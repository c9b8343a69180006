"""Communicator factory (counterpart of
``chainermn_tpu/communicators/__init__.py``).

Names: ``'naive'`` is gloo on the CPU, reducing parameter by parameter
(the JAX ``NaiveCommunicator`` role). ``'xla'`` (the JAX package's primary
name), ``'flat'`` and ``'pure_nccl'`` are NCCL on the card with one packed
flat buffer per ``allreduce_grad`` (the reference pure_nccl design).

Left for later (ROADMAP queue 3.2, communicators): ``'hierarchical'``,
``'two_dimensional'``, ``'single_node'`` and ``'non_cuda_aware'``, which
raise ``NotImplementedError``.
"""

from __future__ import annotations

from chainermn_tpu_torch.communicators.base import CommunicatorBase


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
_LATER = ("hierarchical", "two_dimensional", "single_node", "non_cuda_aware")


def create_communicator(communicator_name: str = "xla", **kwargs
                        ) -> CommunicatorBase:
    """Create a communicator by registry name.

    ``kwargs``: ``allreduce_grad_dtype=`` (``'bfloat16'``, ``'float16'`` or
    None) and ``device=`` (the NCCL names default to the current CUDA card
    and raise without one; ``'naive'`` runs on the CPU).
    """
    if communicator_name == "naive":
        return NaiveCommunicator(**kwargs)
    if communicator_name in _NCCL_NAMES:
        return NcclCommunicator(communicator_name, **kwargs)
    if communicator_name in _LATER:
        raise NotImplementedError(
            f"communicator {communicator_name!r} is not ported yet (ROADMAP "
            "queue 3.2, communicators: the topology-aware names)")
    raise ValueError(f"unknown communicator {communicator_name!r}; available: "
                     f"{sorted(('naive',) + _NCCL_NAMES + _LATER)}")


__all__ = ["CommunicatorBase", "NaiveCommunicator", "NcclCommunicator",
           "create_communicator"]
