"""Collectives over a ``torch.distributed`` process group, differentiable
(counterpart of ``chainermn_tpu/parallel/collectives.py``, the primitive
layer under :mod:`chainermn_tpu_torch.functions`).

The JAX functions run inside ``shard_map`` over a named mesh axis, and
XLA's autodiff knows each collective's transpose. Here each rank is a
process, the axis is a process group (``None`` is the default group; a
communicator stands for its group), and every function is a
``torch.autograd.Function`` whose backward is the transpose JAX's AD
gives, so a backward over the ranks computes the gradient of the SUM of
the ranks' losses, as a gradient taken inside ``shard_map`` does:

==============  =======================================================
forward         backward
==============  =======================================================
``allreduce``   ``allreduce`` (sum; mean divides by the size again);
                max and min raise, as ``lax.pmax``'s gradient does
``reduce_scatter``  ``allgather`` of the cotangents
``bcast``       the cotangents summed onto ``root``, zeros elsewhere
``gather``      ``root``'s cotangent scattered (the others' are zero)
``allgather``   ``reduce_scatter`` of the cotangents
``scatter``     the cotangents gathered onto ``root``, zeros elsewhere
``ppermute``    the inverse permutation
``alltoall``    ``alltoall`` with the split and concat axes swapped
==============  =======================================================

Every rank of the group calls each function, with tensors of the same
shape and dtype, in the same order, and takes the backward through it
(a rank whose loss does not use the result still backs through it: see
:func:`chainermn_tpu_torch.functions.pseudo_connect`). So under grad mode
a result is differentiable on every rank, whether or not that rank's
input is: a receiver's input only gives the shape, and its backward
still sends the cotangent back. JAX's SPMD
conventions hold where they differ from MPI's: ``gather`` gives zeros off
the root, ``scatter`` takes the root's copy and ignores the others',
``ppermute`` gives zeros on a rank that no pair sends to, and ``tiled``
selects the same layouts. ``allreduce``, ``bcast``, ``ppermute`` and
``shift`` take a tensor or a dict, list or tuple of them, as the JAX
functions take pytrees.

Left for later, each raising ``NotImplementedError`` that names its
ROADMAP item: the two-level, decomposed and staged wires over several
axes (queue 3.2), the int8 wires and their error feedback (queue 3.3),
and the tuned bucket size and wire (queue 8, the tuning registry).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from chainermn_tpu_torch.communicators.base import CommunicatorBase

PyTree = Any

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def as_group(comm_or_group):
    """The process group of a communicator, or the group itself (``None``
    is the default group)."""
    if isinstance(comm_or_group, CommunicatorBase):
        return comm_or_group.group
    return comm_or_group


def axis_index(group=None) -> int:
    """This rank's index in ``group`` (JAX: ``lax.axis_index``)."""
    return dist.get_rank(as_group(group))


def axis_size_of(group=None) -> int:
    """The size of ``group`` (JAX: ``lax.axis_size``)."""
    return dist.get_world_size(as_group(group))


def axes_bound(groups) -> bool:
    """Whether a default group exists and this process belongs to every
    group of ``groups`` (a group, ``None`` for the default group, or a
    sequence of them): the JAX probe of whether the named axes are bound,
    with which callers fall back to local semantics instead of raising."""
    if not (dist.is_available() and dist.is_initialized()):
        return False
    gs = groups if isinstance(groups, (tuple, list)) else (groups,)
    return all(dist.get_rank(as_group(g)) >= 0 for g in gs)


def _global(group, rank: int) -> int:
    """``rank`` of ``group`` as a rank of the default group (the
    ``src``/``dst`` that ``torch.distributed``'s calls take)."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


class _Linear(torch.autograd.Function):
    """``y = fwd(x)`` for a linear map across the ranks whose transpose
    is ``bwd``: every collective here is one."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.bwd(ct.contiguous()), None, None


def _linear(x: torch.Tensor, fwd: Callable, bwd: Callable) -> torch.Tensor:
    if (torch.is_grad_enabled() and x.is_floating_point()
            and not x.requires_grad):
        # the result joins the graph whatever this rank's input is: its
        # backward is a collective that the other ranks' backward waits
        # for (a receiver's ``x`` only gives the shape, and its backward
        # sends the cotangent back)
        x = x.detach().requires_grad_()
    return _Linear.apply(x, fwd, bwd)


def _leaves(fn: Callable, x: PyTree) -> PyTree:
    return pytree.tree_map(fn, x)


# ---------------------------------------------------------------------------
# plain collectives on one tensor, no autograd
# ---------------------------------------------------------------------------

def _all_reduce(t, group, op="sum"):
    out = t.contiguous().clone()
    dist.all_reduce(out, op=_REDUCE_OPS[op], group=group)
    if op == "mean":
        out /= dist.get_world_size(group)
    return out


def _all_gather(t, group, axis, tiled):
    n = dist.get_world_size(group)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _reduce_scatter(t, group, dim, tiled):
    n = dist.get_world_size(group)
    size = t.shape[dim]
    if (size % n) if tiled else (size != n):
        raise ValueError(
            f"reduce_scatter: dimension {dim} of size {size} must be "
            + (f"divisible by the group size {n}" if tiled
               else f"the group size {n} (tiled=False)"))
    t0 = t.movedim(dim, 0).contiguous()
    out = t0.new_empty((size // n,) + tuple(t0.shape[1:]))
    dist.reduce_scatter_tensor(out, t0, group=group)
    out = out.movedim(0, dim)
    return out if tiled else out.squeeze(dim)


def _bcast(t, group, root):
    out = t.contiguous().clone()
    dist.broadcast(out, src=_global(group, root), group=group)
    return out


def _reduce_to(t, group, root):
    """The sum over the ranks on ``root``; zeros elsewhere."""
    out = t.contiguous().clone()
    dist.reduce(out, dst=_global(group, root), group=group)
    if dist.get_rank(group) != root:
        out.zero_()
    return out


def _gather_to(t, group, root, axis, tiled):
    """Every rank's ``t`` stacked (or concatenated) along ``axis`` on
    ``root``; zeros of that shape elsewhere."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    mine = dist.get_rank(group) == root
    parts = [torch.empty_like(t) for _ in range(n)] if mine else None
    dist.gather(t, parts, dst=_global(group, root), group=group)
    if not mine:
        parts = [torch.zeros_like(t)] * n
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _scatter_from(t, group, root, axis, tiled):
    """Slice ``i`` along ``axis`` of ``root``'s ``t`` on rank ``i``."""
    n = dist.get_world_size(group)
    size = t.shape[axis]
    if (size % n) if tiled else (size != n):
        raise ValueError(
            f"scatter: dimension {axis} of size {size} must be "
            + (f"divisible by the group size {n}" if tiled
               else f"the group size {n} (tiled=False)"))
    chunks = [c.contiguous() for c in t.chunk(n, axis)]
    out = torch.empty_like(chunks[0])
    mine = dist.get_rank(group) == root
    dist.scatter(out, chunks if mine else None, src=_global(group, root),
                 group=group)
    return out if tiled else out.squeeze(axis)


def _stage_through_host(t, group) -> bool:
    """gloo's point-to-point transport hands the tensor's pointer to its
    TCP pair, which cannot read a CUDA tensor (the sender dies with
    ``writev ... Bad address``): a gloo group moves a CUDA tensor through
    a host copy. NCCL and CPU tensors go as they are."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _permute(t, group, perm):
    return _permute_all([t], group, perm)[0]


def _permute_all(ts, group, perm):
    """:func:`_permute` of every tensor of ``ts`` in ONE
    ``batch_isend_irecv`` (a ring hop's K/V and its segment ids go
    together)."""
    staged = [_stage_through_host(t, group) for t in ts]
    outs = _permute_direct([t.cpu() if s else t for t, s in zip(ts, staged)],
                           group, perm)
    return [o.to(t.device) if s else o for o, t, s in zip(outs, ts, staged)]


def _permute_direct(ts, group, perm):
    me = dist.get_rank(group)
    ts = [t.contiguous() for t in ts]
    outs = [None] * len(ts)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            outs = [t.clone() for t in ts]
        elif src == me:
            ops += [dist.P2POp(dist.isend, t, _global(group, dst), group)
                    for t in ts]
        elif dst == me:
            outs = [torch.empty_like(t) for t in ts]
            ops += [dist.P2POp(dist.irecv, o, _global(group, src), group)
                    for o in outs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [torch.zeros_like(t) if o is None else o
            for o, t in zip(outs, ts)]


def _all_to_all(t, group, split_axis, concat_axis, tiled):
    n = dist.get_world_size(group)
    size = t.shape[split_axis]
    if (size % n) if tiled else (size != n):
        raise ValueError(
            f"alltoall: split dimension {split_axis} of size {size} must be "
            + (f"divisible by the group size {n}" if tiled
               else f"the group size {n} (tiled=False)"))
    chunks = [c.contiguous() for c in t.chunk(n, split_axis)]
    send = torch.cat([c.reshape(-1) for c in chunks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    parts = [p.view(chunks[0].shape) for p in recv.chunk(n)]
    if tiled:
        return torch.cat(parts, concat_axis)
    parts = [p.squeeze(split_axis) for p in parts]
    return torch.stack(parts, concat_axis)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def allreduce(x: PyTree, group=None, op: str = "sum") -> PyTree:
    """Allreduce over ``group``; ``op`` in {'sum', 'mean', 'max', 'min'}.
    The gradient of 'sum' is the sum of the cotangents, of 'mean' their
    mean; 'max' and 'min' raise in the backward (``lax.pmax`` and
    ``lax.pmin`` have no gradient either)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduction op: {op!r}")
    g = as_group(group)

    def bwd(ct):
        if op in ("max", "min"):
            raise NotImplementedError(
                f"allreduce(op={op!r}) has no gradient (as lax.p{op})")
        return _all_reduce(ct, g, op)

    return _leaves(lambda t: _linear(
        t, lambda v: _all_reduce(v, g, op), bwd), x)


def reduce_scatter(x: torch.Tensor, group=None, *,
                   scatter_dimension: int = 0,
                   tiled: bool = True) -> torch.Tensor:
    """Sum over the ranks, rank ``i`` keeping block ``i`` of
    ``scatter_dimension`` (``lax.psum_scatter``; ``tiled=False`` takes a
    dimension of the group's size and drops it). Backward: allgather."""
    g = as_group(group)
    dim = scatter_dimension % x.dim()
    return _linear(x, lambda v: _reduce_scatter(v, g, dim, tiled),
                   lambda ct: _all_gather(ct, g, dim, tiled))


# ---------------------------------------------------------------------------
# rooted collectives
# ---------------------------------------------------------------------------

def bcast(x: PyTree, group=None, root: int = 0) -> PyTree:
    """``root``'s ``x`` on every rank. Backward: the ranks' cotangents
    summed onto ``root`` (zeros elsewhere)."""
    g = as_group(group)
    return _leaves(lambda t: _linear(t, lambda v: _bcast(v, g, root),
                                     lambda ct: _reduce_to(ct, g, root)), x)


def gather(x: torch.Tensor, group=None, root: int = 0, *, axis: int = 0,
           tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` stacked along ``axis`` (concatenated when
    ``tiled``) on ``root``; zeros of the same shape on the other ranks,
    as the JAX function gives. Backward: ``root``'s cotangent scattered,
    block ``i`` to rank ``i``."""
    g = as_group(group)
    ax = axis % (x.dim() + (0 if tiled else 1))
    return _linear(x, lambda v: _gather_to(v, g, root, ax, tiled),
                   lambda ct: _scatter_from(ct, g, root, ax, tiled))


def allgather(x: torch.Tensor, group=None, *, axis: int = 0,
              tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` stacked along ``axis`` (concatenated when
    ``tiled``) on every rank. Backward: reduce-scatter of the
    cotangents."""
    g = as_group(group)
    ax = axis % (x.dim() + (0 if tiled else 1))
    return _linear(x, lambda v: _all_gather(v, g, ax, tiled),
                   lambda ct: _reduce_scatter(ct, g, ax, tiled))


def scatter(x: torch.Tensor, group=None, root: int = 0, *,
            axis: int = 0) -> torch.Tensor:
    """Block ``i`` of ``root``'s ``x`` along ``axis`` on rank ``i`` (the
    other ranks' ``x`` only gives the shape). Backward: the cotangents
    concatenated onto ``root``, zeros elsewhere."""
    g = as_group(group)
    ax = axis % x.dim()
    return _linear(x, lambda v: _scatter_from(v, g, root, ax, True),
                   lambda ct: _gather_to(ct, g, root, ax, True))


# ---------------------------------------------------------------------------
# permutation and all-to-all
# ---------------------------------------------------------------------------

def _check_perm(perm, n):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: sources and destinations must be "
                         f"unique, got {perm}")
    if any(not 0 <= r < n for r in srcs + dsts):
        raise ValueError(f"ppermute: {perm} names a rank outside a group "
                         f"of {n}")
    return perm


def ppermute(x: PyTree, group=None, perm: Sequence = ()) -> PyTree:
    """Pairwise transfers: for each ``(src, dst)`` of ``perm``, rank
    ``dst`` receives rank ``src``'s ``x``; a rank that no pair sends to
    gets zeros (``lax.ppermute``). The sends and receives of one call go
    out together (``batch_isend_irecv``), so a ring cannot deadlock.
    Backward: the inverse permutation."""
    g = as_group(group)
    perm = _check_perm(perm, dist.get_world_size(g))
    inverse = [(d, s) for s, d in perm]
    return _leaves(lambda t: _linear(t, lambda v: _permute(v, g, perm),
                                     lambda ct: _permute(ct, g, inverse)),
                   x)


def shift(x: PyTree, group=None, offset: int = 1) -> PyTree:
    """Rotate values around the ring by ``offset``: rank ``i``'s value
    goes to rank ``i + offset`` (the ring-attention K/V step)."""
    n = axis_size_of(group)
    return ppermute(x, group, [(i, (i + offset) % n) for i in range(n)])


def alltoall(x: torch.Tensor, group=None, *, split_axis: int = 0,
             concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Block ``j`` of ``split_axis`` goes to rank ``j``; the blocks
    received are concatenated along ``concat_axis`` in rank order
    (``lax.all_to_all``; ``tiled=False`` takes a split dimension of the
    group's size, drops it and stacks the received blocks along a new
    ``concat_axis``). Backward: the same call with the axes swapped."""
    g = as_group(group)
    sa = split_axis % x.dim()
    ca = concat_axis % x.dim()
    return _linear(
        x, lambda v: _all_to_all(v, g, sa, ca, tiled),
        lambda ct: _all_to_all(ct, g, ca, sa, tiled))


def _later(name: str, item: str) -> Callable:
    def left_out(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP queue {item})")

    left_out.__name__ = left_out.__qualname__ = name
    left_out.__doc__ = f"Not ported yet: ROADMAP queue {item}."
    return left_out


_WIRES = "3.2, communicators: the two-level and staged wires"
_INT8 = "3.3, optimizer and reduction: the int8 wire and error feedback"
_TUNED = "8, tuning: the tuned bucket size and wire"
two_level_allreduce = _later("two_level_allreduce", _WIRES)
two_level_shard_len = _later("two_level_shard_len", _WIRES)
decomposed_allreduce = _later("decomposed_allreduce", _WIRES)
axes_size = _later("axes_size", _WIRES)
axes_index = _later("axes_index", _WIRES)
staged_reduce_scatter = _later("staged_reduce_scatter", _WIRES)
staged_allreduce = _later("staged_allreduce", _WIRES)
staged_allgather = _later("staged_allgather", _WIRES)
staged_broadcast = _later("staged_broadcast", _WIRES)
int8_allreduce_mean = _later("int8_allreduce_mean", _INT8)
int8_decomposed_allreduce_mean = _later("int8_decomposed_allreduce_mean",
                                        _INT8)
int8_two_level_allreduce_mean = _later("int8_two_level_allreduce_mean",
                                       _INT8)
int8_allreduce_mean_with_feedback = _later(
    "int8_allreduce_mean_with_feedback", _INT8)
int8_two_level_allreduce_mean_with_feedback = _later(
    "int8_two_level_allreduce_mean_with_feedback", _INT8)
tuned_bucket_bytes = _later("tuned_bucket_bytes", _TUNED)
resolve_allreduce_wire = _later("resolve_allreduce_wire", _TUNED)
#: the left-outs above, by name
LEFT_OUT = ("two_level_allreduce", "two_level_shard_len",
            "decomposed_allreduce", "axes_size", "axes_index",
            "staged_reduce_scatter", "staged_allreduce", "staged_allgather",
            "staged_broadcast", "int8_allreduce_mean",
            "int8_decomposed_allreduce_mean", "int8_two_level_allreduce_mean",
            "int8_allreduce_mean_with_feedback",
            "int8_two_level_allreduce_mean_with_feedback",
            "tuned_bucket_bytes", "resolve_allreduce_wire")


__all__ = ["allgather", "allreduce", "alltoall", "as_group", "axes_bound",
           "axis_index", "axis_size_of", "bcast", "gather", "ppermute",
           "reduce_scatter", "scatter", "shift"]
