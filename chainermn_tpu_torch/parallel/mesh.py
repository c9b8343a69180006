"""Rank meshes and their topology (counterpart of
``chainermn_tpu/parallel/mesh.py``).

The JAX package lays its devices out in a ``jax.sharding.Mesh`` and runs
one SPMD program over it. The port runs one process per rank, so a mesh
here is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default group: rank ``r`` sits at the row-major position ``r`` of
the shape, as device ``r`` of ``np.array(devices).reshape(shape)`` does
in a JAX CPU mesh, and an axis's process group is
``mesh.get_group(axis_name)``. :class:`MeshTopology` reads a mesh with
the reference communicator's ``rank``/``size``/``intra_*``/``inter_*``
surface.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from chainermn_tpu_torch._device import resolve_device


def best_mesh_shape(n: int, ndims: int = 2) -> tuple[int, ...]:
    """Factor ``n`` ranks into an ``ndims``-dim balanced mesh shape.

    Most balanced factorisation, larger factors first: minimises the
    largest factor, then the next-largest, and so on (lexicographic on the
    descending-sorted tuple). E.g. 8 -> (4, 2), 16 -> (4, 4), 6 -> (3, 2),
    primes -> (n, 1); 8 over 3 dims -> (2, 2, 2), 16 over 3 -> (4, 2, 2),
    24 over 4 -> (3, 2, 2, 2).
    """
    if ndims < 1:
        raise ValueError(f"ndims must be >= 1, got {ndims}")
    if n < 1:
        raise ValueError(f"need a positive device count, got {n}")
    if ndims == 1:
        return (n,)

    def factorisations(m: int, k: int):
        if k == 1:
            yield (m,)
            return
        for d in range(1, m + 1):
            if m % d == 0:
                for rest in factorisations(m // d, k - 1):
                    yield tuple(sorted((d,) + rest, reverse=True))

    # min() over descending-sorted tuples = smallest largest factor,
    # ties broken by the next factor — the balanced choice.
    return min(set(factorisations(n, ndims)))


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default process group.

    Args:
      axis_names: mesh axis names, e.g. ``('data',)`` or ``('data',
        'stage')``; they become the mesh's ``mesh_dim_names``.
      shape: per-axis sizes; if ``None``, all ranks go on the first axis
        when one axis is named, else a balanced 2-d factorisation and
        size 1 for the remaining axes (the JAX rule).
      device: the ranks' device, whose type the mesh takes; ``None``
        means the CUDA card (and raises without one), ``'cpu'`` a mesh of
        CPU ranks (gloo).

    Raises ``ValueError`` when the shape does not cover the ranks, and
    ``RuntimeError`` when no default process group exists (a
    communicator makes one).
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group; "
                           "create a communicator or call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            shape = best_mesh_shape(n, 2) + (1,) * (len(axis_names) - 2)
    shape = tuple(shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name an axis each "
                         f"for {axis_names}")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} ranks; "
                         f"fix `shape`")
    return init_device_mesh(device.type, shape, mesh_dim_names=axis_names)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Rank-topology view of a mesh, mirroring the reference communicator's
    ``rank/size/intra_rank/inter_rank/inter_size`` surface.

    One process per rank: the processes are the inter group (``rank``,
    ``inter_rank`` and ``inter_size`` are the default group's), and the
    intra pair is the position among the processes on this host. With a
    communicator (``comm``) the pair comes from its hostname exchange
    (``CommunicatorBase.intra_rank``/``intra_size``: a collective on the
    first read, so read it on every rank or on none); without one it is
    ``(0, 1)``, a process that manages its one device alone.
    """

    mesh: DeviceMesh
    comm: "object" = dataclasses.field(default=None, compare=False)

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        return self.mesh.size()

    @property
    def rank(self) -> int:
        """This process's rank in the default group."""
        return dist.get_rank()

    @property
    def inter_size(self) -> int:
        """Number of processes (the reference's number of nodes)."""
        return dist.get_world_size()

    @property
    def inter_rank(self) -> int:
        return dist.get_rank()

    @property
    def intra_size(self) -> int:
        """Processes sharing this host (1 without a communicator)."""
        return 1 if self.comm is None else self.comm.intra_size

    @property
    def intra_rank(self) -> int:
        """Index of this process among those sharing its host (0 without
        a communicator)."""
        return 0 if self.comm is None else self.comm.intra_rank

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names or ())

    def axis_size(self, axis_name: str) -> int:
        return self.mesh.shape[self.axis_names.index(axis_name)]


__all__ = ["MeshTopology", "best_mesh_shape", "make_mesh"]
