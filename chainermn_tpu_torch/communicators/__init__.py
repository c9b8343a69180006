"""Communicator factory (counterpart of
``chainermn_tpu/communicators/__init__.py``), with the JAX registry's
eight names.

``'naive'`` is gloo on the CPU, reducing parameter by parameter (the JAX
``NaiveCommunicator`` role). ``'xla'`` (the JAX package's primary name),
``'flat'`` and ``'pure_nccl'`` are NCCL on the card with one packed flat
buffer per ``allreduce_grad`` (the reference pure_nccl design).
``'hierarchical'`` (and its alias ``'non_cuda_aware'``),
``'two_dimensional'`` and ``'single_node'`` are the topology-aware
communicators of :mod:`~chainermn_tpu_torch.communicators.
xla_communicator`: NCCL on the card by default, gloo when asked for with
``backend='gloo'`` (on the CPU: ``create_communicator('two_dimensional',
backend='gloo', device='cpu')``).
"""

from __future__ import annotations

from chainermn_tpu_torch.communicators.base import (
    ANY_SOURCE,
    CommunicatorBase,
)
from chainermn_tpu_torch.communicators.xla_communicator import (
    HierarchicalCommunicator,
    SingleNodeCommunicator,
    TwoDimensionalCommunicator,
)


class NaiveCommunicator(CommunicatorBase):
    """gloo over CPU tensors, one all_reduce per parameter."""

    name = "naive"

    def __init__(self, *, allreduce_grad_dtype=None, device=None) -> None:
        super().__init__("gloo", packed=False,
                         allreduce_grad_dtype=allreduce_grad_dtype,
                         device=device)


class NcclCommunicator(CommunicatorBase):
    """NCCL over CUDA tensors, one packed flat buffer per reduction."""

    def __init__(self, name: str = "pure_nccl", *, allreduce_grad_dtype=None,
                 device=None) -> None:
        self.name = name
        super().__init__("nccl", packed=True,
                         allreduce_grad_dtype=allreduce_grad_dtype,
                         device=device)


_NCCL_NAMES = ("xla", "flat", "pure_nccl")
_TOPOLOGY = {
    "hierarchical": HierarchicalCommunicator,
    # the reference staged through the host when MPI was not CUDA-aware;
    # the JAX registry maps the name onto the hierarchical layout
    "non_cuda_aware": HierarchicalCommunicator,
    # the reference's intra-RS -> inter-AR -> intra-AG pipeline, pinned
    "two_dimensional": TwoDimensionalCommunicator,
    "single_node": SingleNodeCommunicator,
}


def create_communicator(communicator_name: str = "xla", **kwargs
                        ) -> CommunicatorBase:
    """Create a communicator by registry name: ``xla, naive, flat,
    hierarchical, two_dimensional, single_node, non_cuda_aware,
    pure_nccl``.

    ``kwargs``: ``allreduce_grad_dtype=`` (``'bfloat16'``, ``'float16'``,
    ``'int8'`` or None) and ``device=`` (the NCCL names default to the
    current CUDA card and raise without one; ``'naive'`` runs on the
    CPU); the topology names also take ``backend=`` (``'nccl'``, the
    default, or ``'gloo'``) and ``mesh=`` (a 2-D ``DeviceMesh``).
    """
    if communicator_name == "naive":
        return NaiveCommunicator(**kwargs)
    if communicator_name in _NCCL_NAMES:
        return NcclCommunicator(communicator_name, **kwargs)
    if communicator_name in _TOPOLOGY:
        return _TOPOLOGY[communicator_name](**kwargs)
    raise ValueError(f"unknown communicator {communicator_name!r}; available: "
                     f"{sorted(('naive',) + _NCCL_NAMES + tuple(_TOPOLOGY))}")


#: the names whose transport is chosen by ``backend=``
TOPOLOGY_NAMES = tuple(_TOPOLOGY)


def example_communicator(name, device, **kwargs) -> CommunicatorBase:
    """The example twins' communicator: ``name``, or by default
    ``'pure_nccl'`` on the card and ``'naive'`` on the CPU. On the CPU —
    which the caller asked for with ``--device cpu``, and where gloo is
    the only transport — a topology name is asked for gloo."""
    name = name or ("pure_nccl" if device.type == "cuda" else "naive")
    if name in TOPOLOGY_NAMES and device.type == "cpu":
        kwargs.setdefault("backend", "gloo")
    return create_communicator(name, device=device, **kwargs)


__all__ = ["ANY_SOURCE", "CommunicatorBase", "HierarchicalCommunicator",
           "NaiveCommunicator", "NcclCommunicator", "SingleNodeCommunicator",
           "TOPOLOGY_NAMES", "TwoDimensionalCommunicator",
           "create_communicator", "example_communicator"]
