"""The topology-aware communicators (counterpart of
``chainermn_tpu/communicators/xla_communicator.py``):
``HierarchicalCommunicator`` (also ``'non_cuda_aware'``),
``TwoDimensionalCommunicator`` and ``SingleNodeCommunicator``.

The ranks are laid out on two axes, ``('inter', 'intra')``. By default
``intra`` is the ranks on this host, from the hostname exchange, and
``inter`` one rank per host (rank ``i`` of every host); the hosts' ranks
must be contiguous and equal in number. ``mesh=`` — a 2-D
``DeviceMesh`` (:func:`~chainermn_tpu_torch.parallel.mesh.make_mesh`
over ``('inter', 'intra')``) that lays out this communicator's ranks
row-major — sets the layout instead, so a 2 x 2 layout runs on one host;
``hierarchical`` takes a mesh of any number of axes (``inter`` is then
every axis but the last, merged). ``grad_axes`` is the axes' groups with
their product, this communicator's group
(:class:`~chainermn_tpu_torch.parallel.collectives.MergedAxes`), so a
reduction over all of them is one call; ``axis_groups`` names them (the
mesh's dim names, or ``('inter', 'intra')``) and carries the product
group of every other set of axes, made at construction, which the
composed reduction schedules run their merged stages on.

Transport: NCCL on the card by default. gloo only when the caller asks
for it (``backend='gloo'``): on the CPU (``device='cpu'``, as the CPU
tests run) or over CUDA tensors through host copies (several ranks on
one card, where NCCL cannot put two ranks). Nothing falls back from one
to the other.

Strategies: ``'hierarchical'`` averages the gradients as the base
communicator does, one packed all-reduce over both axes (the JAX
package's fused ``pmean`` over ``('inter', 'intra')``);
``'two_dimensional'`` pins the reference's two-level pipeline
(``reduce_tree(schedule='two_level')``: per ~64 MB bucket an intra
reduce-scatter, an inter all-reduce of the shard, an intra all-gather;
the int8 wire quantizes only the shard crossing ``inter``), and its
``two_level_axes`` selects the shard-level error feedback;
``'single_node'`` is the flat communicator that refuses more than one
host. The tuned bucket size and the ``'auto'`` wire are ROADMAP queue
8's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators.base import CommunicatorBase
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel.reduction_schedule import (
    DEFAULT_BUCKET_BYTES,
    reduce_tree,
)


class HierarchicalCommunicator(CommunicatorBase):
    """Two axes ``('inter', 'intra')``; the gradients are averaged over
    both, packed into one all-reduce."""

    name = "hierarchical"
    gloo_on_cuda = True

    def __init__(self, *, backend: str = "nccl", mesh=None,
                 allreduce_grad_dtype=None, device=None) -> None:
        super().__init__(backend, packed=True,
                         allreduce_grad_dtype=allreduce_grad_dtype,
                         device=device)
        names = ("inter", "intra")
        if mesh is not None:
            axes = self._mesh_axes(mesh)
            names = tuple(mesh.mesh_dim_names
                          or (f"a{i}" for i in range(mesh.ndim)))
            # the group over every other set of axes, made here on every
            # rank in one order (a group made inside a step deadlocks the
            # moment two ranks bind different compositions)
            products = C.product_groups(
                mesh.mesh.cpu().numpy(), names, backend=self.backend,
                known={names: self.group})
        else:
            axes = (self._host_axes() if self.size > 1
                    else (self.group, self.group))
            products = {names: self.group}
        self._axis_groups = C.AxisGroups(names, axes, products)

    def _mesh_axes(self, mesh) -> tuple:
        """The axis groups of ``mesh``, checked against this
        communicator: its ranks row-major, each group on its backend."""
        ranks = mesh.mesh.reshape(-1).tolist()
        if ranks != self.global_ranks:
            raise ValueError(
                f"mesh= must lay out this communicator's ranks "
                f"{self.global_ranks} row-major, got {ranks}")
        axes = tuple(mesh.get_group(i) for i in range(mesh.ndim))
        for g in axes:
            if dist.get_backend(g) != self.backend:
                raise ValueError(
                    f"mesh= axis group on {dist.get_backend(g)!r}, the "
                    f"communicator on {self.backend!r}")
        return axes

    def _host_axes(self) -> tuple:
        """``(inter, intra)`` from the hostnames: each host's ranks must
        be contiguous and as many as every other host's. Every rank makes
        every row's and column's group, in one order."""
        names = self._host_names()
        hosts = list(dict.fromkeys(names))
        per = len(names) // len(hosts)
        layout = [h for h in hosts for _ in range(per)]
        if layout != names:
            raise ValueError(
                f"the hosts' ranks are not contiguous and equal in number "
                f"({names}); pass mesh= to lay the ranks out")
        g = self.global_ranks
        inter = intra = None
        for j in range(per):  # the inter groups: rank j of every host
            grp = dist.new_group([g[i * per + j] for i in range(len(hosts))],
                                 backend=self.backend)
            if j == self.rank % per:
                inter = grp
        for i in range(len(hosts)):  # the intra groups: one a host
            grp = dist.new_group(g[i * per:(i + 1) * per],
                                 backend=self.backend)
            if i == self.rank // per:
                intra = grp
        return inter, intra

    @property
    def axis_groups(self):
        """The axes by name (``('inter', 'intra')``, or the ``mesh=``'s
        dim names) with their groups and the product group of every set
        of them (made at construction)."""
        return self._axis_groups

    @property
    def inter_rank(self) -> int:
        """This rank's row-major index over every axis but the last."""
        return C.axes_index(self.grad_axes[:-1])

    @property
    def inter_size(self) -> int:
        """The ranks of every axis but the last, merged."""
        return C.axes_size(self.grad_axes[:-1])

    @property
    def intra_rank(self) -> int:
        return dist.get_rank(self.grad_axes[-1])

    @property
    def intra_size(self) -> int:
        return dist.get_world_size(self.grad_axes[-1])


class TwoDimensionalCommunicator(HierarchicalCommunicator):
    """The hierarchical axes with the reference's bandwidth-optimal
    pipeline pinned: per ~``bucket_bytes`` bucket an intra reduce-scatter,
    an inter all-reduce of the 1/n shard and an intra all-gather. Raises
    unless both axes exist."""

    name = "two_dimensional"
    #: the gradient buckets' size (the tuned size is ROADMAP queue 8's)
    bucket_bytes = DEFAULT_BUCKET_BYTES

    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        if len(self.axis_names) != 2:
            raise ValueError(
                "two_dimensional requires a 2-axis (inter, intra) layout; "
                f"got {len(self.axis_names)} axes")

    @property
    def two_level_axes(self) -> tuple:
        """``(intra, inter)`` groups of the pinned two-level reduction:
        the int8 wire rounds only at the inter stage, so error feedback
        keeps its residual at shard shape."""
        inter, intra = self.grad_axes
        return intra, inter

    def _reduce(self, grads: list, wire) -> None:
        self._two_level(grads, wire)

    def _reduce_int8_per_leaf(self, grads: list) -> None:
        # under two_dimensional the int8 wire is per bucket, as the
        # other wires are
        self._two_level(grads, torch.int8)

    def _two_level(self, grads: list, wire) -> None:
        means = reduce_tree(grads, schedule="two_level", axes=self,
                            compress_dtype=wire,
                            bucket_bytes=self.bucket_bytes)
        for g, m in zip(grads, means):
            g.copy_(m)


class SingleNodeCommunicator(CommunicatorBase):
    """The flat communicator (one packed all-reduce) on ONE host: raises
    unless ``inter_size == 1`` (the reference asserted one node)."""

    name = "single_node"
    gloo_on_cuda = True

    def __init__(self, *, backend: str = "nccl", allreduce_grad_dtype=None,
                 device=None) -> None:
        super().__init__(backend, packed=True,
                         allreduce_grad_dtype=allreduce_grad_dtype,
                         device=device)
        if self.inter_size != 1:
            raise ValueError(
                f"SingleNodeCommunicator requires one host (inter_size == "
                f"1), got {self.inter_size} hosts")


__all__ = ["HierarchicalCommunicator", "SingleNodeCommunicator",
           "TwoDimensionalCommunicator"]
