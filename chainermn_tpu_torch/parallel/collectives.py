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

Over several axes (a tuple of groups, merged in row-major order; a
collective over them is ONE call on their product group, which a
:class:`MergedAxes` carries beside them, as a communicator's
``grad_axes`` does): ``axes_size``/
``axes_index``, the two-level and decomposed all-reduces, the staged
primitives the reduction schedules are written in (a reduce-scatter
over ceil-padded rows, an all-reduce, the conjugate all-gather, and a
radix-tree broadcast of ``ceil(log_radix n)`` rounds), and the int8 wires
with their error-feedback forms (per-member stage-1 scales, a per-shard
stage-2 scale; at n == 1 the value itself, unrounded). These are XLA ops
in the JAX package, so torch ops and ``torch.distributed`` calls here; a
gloo group moves CUDA tensors through host copies. The composed
schedules name their axes: an :class:`AxisGroups` binds mesh axis names
to their groups and to the product group of every set of them
(:func:`product_groups`, made with the mesh).

Left for later, raising ``NotImplementedError`` that names ROADMAP
queue 8 (the tuning registry): the tuned bucket size and wire.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Sequence

import numpy as np
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

def _all_reduce(t, group, op="sum", *, inplace=False):
    out = t if inplace else t.contiguous().clone()
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


# ---------------------------------------------------------------------------
# several axes: the merged group, the two-level frame and the staged
# primitives (the reduction schedules' and the composition layer's
# vocabulary), and the int8 wires
# ---------------------------------------------------------------------------

def _norm(group):
    g = as_group(group)
    return dist.group.WORLD if g is None else g


def _axes(axes) -> tuple:
    """``axes`` (a group, a communicator, None, or a sequence of them) as
    a tuple of process groups, ``None`` being the default group."""
    if isinstance(axes, MergedAxes):
        return axes
    if isinstance(axes, (tuple, list)):
        return tuple(_norm(a) for a in axes)
    return (_norm(axes),)


class MergedAxes(tuple):
    """Axis groups merged in row-major order, with ``product``: the one
    group over all of them (rank ``i`` of ``product`` is the rank whose
    row-major index over the groups is ``i``, as a 2-D mesh's whole group
    over its two axes). A collective over the merged axes runs as ONE
    call on ``product``. Slicing gives a plain tuple of the groups."""

    def __new__(cls, groups, product):
        self = super().__new__(cls, (_norm(g) for g in groups))
        self.product = _norm(product)
        return self


class AxisGroups:
    """Mesh axis names bound to this rank's process groups, the names a
    composition's stages speak (``rs(intra)``, ``ar(a0+a1)``): ``names``
    in mesh order (slow first, fast last), the group of each axis through
    this rank, and ``products``, the group over each set of two or more
    axes (the ranks that share this rank's coordinates on every other
    axis). Group creation is collective, so every product group is made
    with the mesh, on every rank in one order (:func:`product_groups`),
    never inside a step. torch numbers a group's ranks by their
    default-group ranks, so rank ``i`` of a product group is the rank at
    row-major position ``i`` over its axes in MESH order."""

    def __init__(self, names, groups, products=None) -> None:
        self.names = tuple(names)
        groups = tuple(groups)
        if len(set(self.names)) != len(self.names) or len(groups) != len(
                self.names):
            raise ValueError(f"axis names {self.names} must be distinct, one "
                             f"for each of the {len(groups)} groups")
        self.groups = dict(zip(self.names, (_norm(g) for g in groups)))
        self.products = {frozenset(k): _norm(g)
                         for k, g in (products or {}).items()}

    def ordered(self, axes) -> tuple:
        """``axes`` (names) in mesh order; raises on a name not on it."""
        bad = [a for a in axes if a not in self.groups]
        if bad:
            raise ValueError(f"axes {bad} are not on the mesh {self.names}")
        return tuple(sorted(axes, key=self.names.index))

    def merged(self, axes) -> tuple:
        """The groups of ``axes`` merged in mesh order: a 1-tuple for one
        axis, else a :class:`MergedAxes` carrying their product group."""
        ordered = self.ordered(axes)
        groups = [self.groups[a] for a in ordered]
        if len(ordered) == 1:
            return tuple(groups)
        key = frozenset(ordered)
        if key not in self.products:
            raise ValueError(f"no product group over {ordered} was made with "
                             f"the mesh {self.names}")
        return MergedAxes(groups, self.products[key])

    def size(self, axes) -> int:
        """The number of ranks of ``axes`` merged."""
        n = 1
        for a in self.ordered(axes):
            n *= dist.get_world_size(self.groups[a])
        return n

    def sizes(self) -> dict:
        """``{name: size}`` of every axis."""
        return {a: dist.get_world_size(g) for a, g in self.groups.items()}


def product_groups(ranks, names, *, backend=None, known=None) -> dict:
    """``{frozenset(axes): group}``: the group through this rank over each
    set of two or more of the axes ``names`` of ``ranks`` (an array of
    default-group ranks in the mesh's shape), but the sets ``known``
    already has (passed through). Every rank calls it, with the same
    arguments: each set's groups are made in one fixed order."""
    ranks = np.asarray(ranks)
    names = tuple(names)
    me = dist.get_rank()
    out = {frozenset(k): g for k, g in (known or {}).items()}
    k = len(names)
    for n_axes in range(2, k + 1):
        for combo in itertools.combinations(range(k), n_axes):
            key = frozenset(names[i] for i in combo)
            if key in out:
                continue
            rest = [i for i in range(k) if i not in combo]
            mine = None
            for fixed in itertools.product(*(range(ranks.shape[i])
                                             for i in rest)):
                index = [slice(None)] * k
                for i, c in zip(rest, fixed):
                    index[i] = c
                members = sorted(int(r) for r in
                                 ranks[tuple(index)].reshape(-1))
                g = dist.new_group(members, backend=backend)
                if me in members:
                    mine = g
            out[key] = mine
    return out


def axis_groups_of(axes) -> AxisGroups:
    """``axes`` as an :class:`AxisGroups`: itself, a communicator's
    (``comm.axis_groups``), or a group or tuple of groups named by
    position ``('a0', 'a1', ...)`` (a :class:`MergedAxes` brings its
    product group)."""
    if isinstance(axes, AxisGroups):
        return axes
    if isinstance(axes, CommunicatorBase):
        return axes.axis_groups
    groups = _axes(axes)
    names = tuple(f"a{i}" for i in range(len(groups)))
    products = ({frozenset(names): groups.product}
                if isinstance(groups, MergedAxes) else {})
    return AxisGroups(names, groups, products)


def _merged(axes: tuple):
    """The one group that spans the merged ``axes``: a single axis, or
    the product a :class:`MergedAxes` carries."""
    if len(axes) == 1:
        return axes[0]
    if isinstance(axes, MergedAxes):
        return axes.product
    raise ValueError(
        f"a collective over {len(axes)} merged axes runs on their product "
        "group: pass MergedAxes(groups, product) (a communicator's "
        "grad_axes is one)")


def axes_size(axes) -> int:
    """Product of the sizes of the groups ``axes`` (a group or a sequence
    of groups): the world size of a reduction over the merged axes."""
    n = 1
    for g in _axes(axes):
        n *= dist.get_world_size(g)
    return n


def axes_index(axes) -> int:
    """Row-major index of this rank over the merged ``axes`` (the
    single-group :func:`axis_index`, generalised)."""
    idx = 0
    for g in _axes(axes):
        idx = idx * dist.get_world_size(g) + dist.get_rank(g)
    return idx


def two_level_shard_len(size: int, n_intra: int) -> int:
    """Per-member intra-shard length for a flat buffer of ``size``
    elements: the ceil-padded row length of the two-level frame, and so
    the shape of the shard-level error-feedback residual."""
    return -(-size // n_intra)


def _rows(flat: torch.Tensor, n: int) -> torch.Tensor:
    """``flat`` zero-padded into ``n`` equal rows ``[n, c]``."""
    c = two_level_shard_len(flat.numel(), n)
    if n * c == flat.numel():
        return flat.reshape(n, c)
    return torch.nn.functional.pad(flat, (0, n * c - flat.numel())
                                   ).reshape(n, c)


def _host_staged(fn, t, group, *args, **kwargs):
    """``fn(t, group, *args, **kwargs)``, through a host copy when
    ``group`` is gloo and ``t`` a CUDA tensor (gloo's collectives take CPU
    tensors)."""
    if _stage_through_host(t, group):
        return fn(t.cpu(), group, *args, **kwargs).to(t.device)
    return fn(t, group, *args, **kwargs)


def _psum(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The sum over the merged ``axes`` (``lax.psum``)."""
    return _host_staged(_all_reduce, x, _merged(axes))


def _rs_rows(rows: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``[n, c]`` rows over the merged ``axes`` -> this rank's ``[c]``
    row summed over them (``psum_scatter(..., tiled=False)``)."""
    return _host_staged(_reduce_scatter, rows, _merged(axes), 0, False)


def _ag_rows(t: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``t`` of every rank of the merged ``axes``, stacked ``[n, ...]`` in
    row-major order (``all_gather(..., tiled=False)``)."""
    return _host_staged(_all_gather, t, _merged(axes), 0, False)


def _a2a_rows(rows: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Row ``j`` of ``[n, c]`` to member ``j`` of the merged ``axes``; row
    ``s`` of the result came from member ``s`` (``all_to_all(...,
    tiled=True)``)."""
    return _host_staged(_all_to_all, rows, _merged(axes), 0, 0, True)


def _two_level_frame(x: torch.Tensor, intra, inter_reduce) -> torch.Tensor:
    """The frame both two-level reductions share: ceil-pad, intra
    reduce-scatter (the exact sum of this member's 1/n slice),
    ``inter_reduce(shard)``, intra all-gather, un-pad."""
    intra = _axes(intra)
    n_intra = axes_size(intra)
    flat = x.reshape(-1)
    shard = _rs_rows(_rows(flat, n_intra), intra)
    shard = inter_reduce(shard)
    rows = _ag_rows(shard, intra)
    return rows.reshape(-1)[:flat.numel()].reshape(x.shape)


def _check_op(op):
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")


def _self_adjoint(x, fn):
    """``fn(x)`` as a differentiable linear map that is its own
    transpose (an all-reduce, whatever its schedule)."""
    return _linear(x, fn, fn)


def two_level_allreduce(x: torch.Tensor, intra_group, inter_group, *,
                        op: str = "mean") -> torch.Tensor:
    """Bandwidth-optimal two-level allreduce: intra reduce-scatter, inter
    allreduce of the 1/n shard, intra all-gather (the reference's
    ``TwoDimensionalCommunicator`` pipeline). ``inter_group`` may be a
    sequence of groups, merged. Differentiable (its own transpose)."""
    _check_op(op)
    return _self_adjoint(x, lambda v: _two_level(v, intra_group, inter_group,
                                                 op == "mean"))


def _two_level(x, intra, inter, mean: bool):
    """The exact two-level sum (or mean) of ``x`` over ``intra`` and
    ``inter`` (no autograd)."""
    inter = _axes(inter)
    n = axes_size(intra) * axes_size(inter)

    def inter_fn(shard):
        shard = _psum(shard, inter)
        return shard / n if mean else shard

    return _two_level_frame(x, intra, inter_fn)


def decomposed_allreduce(x: torch.Tensor, axes, *,
                         op: str = "mean") -> torch.Tensor:
    """Allreduce as its bandwidth-optimal decomposition: reduce-scatter
    over the LAST group of ``axes`` (the fast, intra one by the mesh
    convention), allreduce of the shard over the others (none on a flat
    mesh), all-gather back. Differentiable (its own transpose)."""
    _check_op(op)
    names = _axes(axes)
    scatter_ax, rest = names[-1], names[:-1]
    n = axes_size(names)

    def run(v):
        def inter_fn(shard):
            if rest:
                shard = _psum(shard, rest)
            return shard / n if op == "mean" else shard

        return _two_level_frame(v, scatter_ax, inter_fn)

    return _self_adjoint(x, run)


def staged_reduce_scatter(flat: torch.Tensor, axes) -> torch.Tensor:
    """One composition stage: ceil-pad ``flat`` into ``[n, c]`` rows over
    the merged ``axes`` (``c`` = :func:`two_level_shard_len`) and
    reduce-scatter them: this member's exactly summed 1/n shard."""
    names = _axes(axes)
    return _rs_rows(_rows(flat.reshape(-1), axes_size(names)), names)


def staged_allreduce(x: torch.Tensor, axes) -> torch.Tensor:
    """One composition stage: the sum over the merged ``axes``."""
    return _psum(x, _axes(axes))


def staged_allgather(shard: torch.Tensor, axes,
                     orig_size: int) -> torch.Tensor:
    """One composition stage, the conjugate of
    :func:`staged_reduce_scatter`: all-gather the shards over the merged
    ``axes`` and un-pad to ``orig_size`` elements."""
    return _ag_rows(shard, _axes(axes)).reshape(-1)[:orig_size]


def staged_broadcast(x: torch.Tensor, axes, *, radix: int = 2,
                     root: int = 0) -> torch.Tensor:
    """One composition stage: the ``root`` member's ``x`` on every member
    of the merged ``axes``, by a multicast tree of exactly
    ``ceil(log_radix n)`` rounds of point-to-point transfers (the JAX
    ``ppermute`` rounds): non-holders carry zeros, so each transfer's
    ``cur + received`` delivers the payload or adds zero, and each round
    multiplies the holders by ``radix`` (holder ``s`` sends to ``s +
    j * holders``, ``j`` in ``1..radix-1``: ``radix - 1`` transfers a
    round). The merged axes must be one group (a single axis, or a
    :class:`MergedAxes`): a tree's transfers cross the axes at once."""
    names = _axes(axes)
    r = int(radix)
    if r < 2:
        raise ValueError(f"multicast radix must be >= 2, got {radix}")
    n = axes_size(names)
    if n == 1:
        return x
    g = _merged(names)
    idx = axes_index(names)
    rk = int(root) % n

    def pos(s):  # tree coordinate -> rank
        return (s + rk) % n

    cur = x if idx == rk else torch.zeros_like(x)
    holders = 1
    while holders < n:
        for j in range(1, r):
            perm = [(pos(s), pos(s + j * holders))
                    for s in range(holders) if s + j * holders < n]
            if perm:
                cur = cur + _permute(cur, g, perm)
        holders = min(n, holders * r)
    return cur


def quantize_int8(v: torch.Tensor):
    """One quantization stage of the int8 wire: ``(codes, scale)`` with
    ``scale = max(max|v|, 1e-30) / 127`` and ``codes = clip(round(v /
    scale), -127, 127)`` as int8 (round half to even, as ``jnp.round``)."""
    amax = v.abs().max()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_core(x: torch.Tensor, axes: tuple):
    """The two-phase quantized mean over the merged ``axes``:
    ``(mean, local_roundtrip)``, ``local_roundtrip`` being this member's
    dequantized stage-1 message ``D(C(x))``, what the peers received
    from it (error feedback keeps ``x - D(C(x))``).

    1. quantize the ceil-padded ``[n, c]`` rows against this member's own
       max-abs scale; all-to-all the int8 rows and all-gather the n
       scales;
    2. dequantize and sum the n received rows (this member's exact 1/n
       shard), requantize it against its own scale, all-gather the int8
       shards and their scales.

    At n == 1 the mean is ``x`` itself, with no rounding."""
    n = axes_size(axes)
    if n == 1 or x.numel() == 0:
        return x, x
    orig = x.dtype
    flat = x.detach().float().reshape(-1)
    q, scale = quantize_int8(_rows(flat, n))
    local_rt = ((q.float() * scale).reshape(-1)[:flat.numel()]
                .reshape(x.shape).to(orig))
    qt = _a2a_rows(q, axes)
    scales = _ag_rows(scale.reshape(1), axes).reshape(n)
    shard = (qt.float() * scales[:, None]).sum(0)
    q2, scale2 = quantize_int8(shard)
    q2g = _ag_rows(q2, axes)
    scale2g = _ag_rows(scale2.reshape(1), axes).reshape(n)
    out = (q2g.float() * scale2g[:, None]).reshape(-1)
    mean = (out[:flat.numel()] / n).reshape(x.shape).to(orig)
    return mean, local_rt


def int8_allreduce_mean(x: torch.Tensor, axes) -> torch.Tensor:
    """Quantized mean-allreduce over the merged ``axes`` on an INT8 wire
    (:func:`_int8_core`'s two phases: about ``2(n-1)/n`` bytes an element
    against bf16's ``4(n-1)/n``, two roundings of at most half a code of
    each stage's scale). Differentiable straight through: the backward is
    the exact mean-allreduce of the cotangent."""
    names = _axes(axes)
    return _linear(x, lambda v: _int8_core(v, names)[0],
                   lambda ct: _psum(ct, names) / axes_size(names))


def int8_allreduce_mean_with_feedback(x: torch.Tensor, axes):
    """``(mean, local_roundtrip)`` of :func:`_int8_core`: the caller keeps
    ``x - local_roundtrip`` and adds it into the next step's message
    (EF-SGD). Not differentiable (the optimizer's)."""
    return _int8_core(x.detach(), _axes(axes))


def int8_two_level_allreduce_mean(x: torch.Tensor, intra_group,
                                  inter_group) -> torch.Tensor:
    """Topology-aware quantized allreduce: exact intra reduce-scatter,
    the int8 wire (both stages) only on the shard crossing the inter
    groups (one or several, merged), exact intra all-gather; the mean
    over the whole product. Straight-through gradient (the exact mean
    over both levels)."""
    intra, inter = _axes(intra_group), _axes(inter_group)
    n_intra = axes_size(intra)

    def run(v):
        def inter_fn(shard):
            return _int8_core(shard, inter)[0] / n_intra

        return _two_level_frame(v.detach(), intra, inter_fn).to(v.dtype)

    return _linear(x, run, lambda ct: _two_level(ct, intra, inter, True))


def int8_decomposed_allreduce_mean(x: torch.Tensor, axes) -> torch.Tensor:
    """The quantized :func:`decomposed_allreduce`: exact reduce-scatter
    over the last group, the int8 wire over the others, exact all-gather.
    On one axis the flat int8 wire (already a scatter-gather)."""
    names = _axes(axes)
    if len(names) == 1:
        return int8_allreduce_mean(x, names)
    return int8_two_level_allreduce_mean(x, names[-1], names[:-1])


def int8_two_level_allreduce_mean_with_feedback(x: torch.Tensor,
                                                residual: torch.Tensor,
                                                intra_group, inter_group):
    """Shard-level error feedback for the topology-aware wire: the inter
    message is ``intra_shard + residual``, the new residual ``message -
    D(C(message))``, an fp32 buffer of ``[two_level_shard_len(x.numel(),
    n_intra)]`` (1/n_intra of the flat form's), kept where the error
    arises. Returns ``(mean, new_residual)``; an inter level of size 1
    rounds nothing and returns a zero residual. Not differentiable."""
    intra, inter = _axes(intra_group), _axes(inter_group)
    n_intra = axes_size(intra)
    captured = []

    def inter_fn(shard):
        msg = shard + residual.float()
        mean_shard, local_rt = _int8_core(msg, inter)
        captured.append(msg - local_rt)
        return mean_shard / n_intra

    mean = _two_level_frame(x.detach().float(), intra, inter_fn).to(x.dtype)
    return mean, captured[0]


def _later(name: str, item: str) -> Callable:
    def left_out(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP queue {item})")

    left_out.__name__ = left_out.__qualname__ = name
    left_out.__doc__ = f"Not ported yet: ROADMAP queue {item}."
    return left_out


_TUNED = "8, tuning: the tuned bucket size and wire"
tuned_bucket_bytes = _later("tuned_bucket_bytes", _TUNED)
resolve_allreduce_wire = _later("resolve_allreduce_wire", _TUNED)
#: the left-outs above, by name
LEFT_OUT = ("tuned_bucket_bytes", "resolve_allreduce_wire")


__all__ = ["AxisGroups", "LEFT_OUT", "MergedAxes", "allgather", "allreduce",
           "alltoall", "as_group", "axes_bound", "axes_index", "axes_size",
           "axis_groups_of",
           "axis_index", "axis_size_of", "bcast", "decomposed_allreduce",
           "gather", "int8_allreduce_mean",
           "int8_allreduce_mean_with_feedback",
           "int8_decomposed_allreduce_mean", "int8_two_level_allreduce_mean",
           "int8_two_level_allreduce_mean_with_feedback", "ppermute",
           "product_groups", "quantize_int8", "reduce_scatter",
           "resolve_allreduce_wire", "scatter", "shift",
           "staged_allgather", "staged_allreduce", "staged_broadcast",
           "staged_reduce_scatter", "tuned_bucket_bytes",
           "two_level_allreduce", "two_level_shard_len"]
