"""ZeRO-style optimizer-state sharding over the data-parallel group
(counterpart of ``chainermn_tpu/parallel/zero.py``).

In plain data parallelism every rank holds the FULL optimizer state (2x
the parameters for Adam). Here each of the ``n`` ranks of the group owns
``1/n`` of every parameter's state:

1. each gradient is flattened, padded into ``n`` equal rows (the JAX
   ``_chunk_rows`` layout: ``ceil(size / n)`` per row, zeros after the
   end), the rows of every leaf are laid side by side in one ``[n, sum
   c]`` buffer and reduce-scattered once: rank ``i`` receives row ``i``,
   which is its chunk of every leaf, and divides it by ``n`` (the MEAN;
   a reduce-scatter is half an all-reduce's bytes);
2. the inner optimizer steps only this rank's chunk of each parameter
   (1/n of the state, 1/n of the update work);
3. the updated chunks, one flat buffer, are all-gathered once back into
   the replicated parameters (the other half of the all-reduce).

So a step makes one reduce-scatter and one all-gather for each dtype of
the parameters, where the JAX wrapper makes one of each per leaf; the
chunks and the numbers are the same.

The JAX wrapper gathers the optax updates and adds them; a torch
optimizer updates its parameters in place, so the port gathers the
updated chunks themselves, which is the same parameter without the
rounding of ``p + (p_new - p)``.

The inner optimizer must be ELEMENT-WISE (SGD, momentum, Adam, AdamW,
RMSprop...): anything that computes statistics across a parameter, such
as global-norm clipping, would see only chunks.

Usage, one process per rank::

    opt = zero_shard_optimizer(
        functools.partial(torch.optim.AdamW, lr=1e-3), model.parameters(),
        comm)           # a communicator or process group; None: the world
    loss.backward()     # this rank's local gradients, not yet averaged
    opt.step()          # reduce-scatter mean, 1/n update, all-gather

The wrapper reduces the gradients itself (``handles_cross_rank_sync``),
so :func:`~chainermn_tpu_torch.training.make_train_step` runs it without
another reduction.

:func:`zero_plan_axis` and :func:`zero_stacked_init` are the ZeRO axis's
surface of the :class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`.
``compress_dtype`` (``'bfloat16'``/``'float16'``) casts the gradient
rows before the reduce-scatter and the summed chunk back before the
mean's division, as the JAX wrapper does (the JAX ``'zero'`` reduction
schedule divides in the wire dtype instead: the same number when the
ranks are a power of two). The ``'zero'`` schedule of
:class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` runs this
wrapper over the last (intra) axis with the others as ``extra_group``.
``zero_state_specs`` has a DTensor counterpart: the placement of each
state leaf over a 1-D device mesh of the group.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch.parallel.collectives import as_group


def _shard_len(size: int, n: int) -> int:
    """The ceil-padded row length (JAX ``two_level_shard_len``)."""
    return -(-size // n)


def _chunk_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` flattened and zero-padded into ``n`` equal rows ``[n, c]``
    (a view of ``x`` when its size divides by ``n``)."""
    flat = x.reshape(-1)
    c = _shard_len(flat.numel(), n)
    if n * c == flat.numel():
        return flat.view(n, c)
    return F.pad(flat, (0, n * c - flat.numel())).reshape(n, c)


def _unchunk(rows: torch.Tensor, shape, dtype) -> torch.Tensor:
    size = 1
    for s in shape:
        size *= s
    return rows.reshape(-1)[:size].reshape(shape).to(dtype)


def _group_of(group):
    g = as_group(group)
    return g, dist.get_world_size(g), dist.get_rank(g)


def zero_grad_scatter(g: torch.Tensor, group=None, *, extra_group=None,
                      total: Optional[int] = None,
                      wire_dtype=None) -> torch.Tensor:
    """This rank's MEAN gradient chunk ``[c]``: one reduce-scatter of
    ``g``'s rows over ``group`` plus, when the step has more data-parallel
    ranks, one all-reduce of the chunk over ``extra_group`` (JAX
    ``extra_axes``), divided by ``total`` (default: the product of the two
    groups' sizes). ``wire_dtype`` (a float dtype) casts the rows before
    the reduce-scatter, and the sum back to ``g``'s dtype before the
    division (the JAX ``zero_shard_optimizer(compress_dtype=)``)."""
    grp, n, _ = _group_of(group)
    rows = _chunk_rows(g, n).contiguous()
    if wire_dtype is not None and g.is_floating_point():
        rows = rows.to(wire_dtype)
    part = rows.new_empty(rows.shape[1:])
    dist.reduce_scatter_tensor(part, rows.reshape(-1), group=grp)
    if extra_group is not None:
        extra = as_group(extra_group)
        dist.all_reduce(part, group=extra)
        if total is None:
            total = n * dist.get_world_size(extra)
    return part.to(g.dtype) / (n if total is None else total)


def zero_param_chunk(p: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's ``1/n`` chunk of a replicated parameter (the slice the
    sharded update owns), a view of its padded rows."""
    _, n, r = _group_of(group)
    return _chunk_rows(p, n)[r]


def zero_gather_updates(u_chunk: torch.Tensor, like: torch.Tensor,
                        group=None) -> torch.Tensor:
    """All-gather the ranks' chunks back to ``like``'s shape and dtype."""
    grp, n, _ = _group_of(group)
    u_chunk = u_chunk.reshape(-1).contiguous()
    rows = u_chunk.new_empty(n * u_chunk.numel())
    dist.all_gather_into_tensor(rows, u_chunk, group=grp)
    return _unchunk(rows, like.shape, like.dtype)


def zero_state_specs(optimizer) -> dict:
    """The placements of a :class:`ZeroShardOptimizer`'s state over a
    1-D device mesh of its group (the JAX ``PartitionSpec`` tree of the
    state): each chunk leaf is ``(Shard(0),)``, the ranks' chunks
    concatenated, and each 0-dim leaf (a step counter, equal on every
    rank) ``(Replicate(),)``. Keyed as ``optimizer.state_dict()
    ['state']``; the state must exist (after a step)."""
    from torch.distributed.tensor import Replicate, Shard

    inner = getattr(optimizer, "actual_optimizer", optimizer)
    return {i: {k: ((Shard(0),) if isinstance(v, torch.Tensor) and v.dim()
                    else (Replicate(),)) for k, v in s.items()}
            for i, s in inner.state_dict()["state"].items()}


def zero_plan_axis(axis_name: str = "zero") -> dict:
    """Spec-provider descriptor of the ``zero`` axis for the
    :class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`: the axis
    shards the OPTIMIZER STATE (parameters stay replicated over it: it is
    a data-parallel axis whose state is chunked), and owes the step one
    reduce-scatter and one all-gather of the parameters' chunks."""
    return {"name": axis_name, "stacked": False, "state_stacked": True,
            "collectives": ("reduce-scatter", "all-gather")}


def _chunk_buckets(leaves: list, n: int, rank: int):
    """``(chunks, buckets)``: ``chunks[i]`` is row ``rank`` of leaf
    ``i``'s ``_chunk_rows`` layout as a Parameter that views one flat
    buffer per (dtype, device) of the leaves; ``buckets`` lists, per
    buffer, ``(leaf indices, chunk lengths, flat buffer)``."""
    by_kind: dict = {}
    for i, p in enumerate(leaves):
        by_kind.setdefault((p.dtype, p.device), []).append(i)
    chunks = [None] * len(leaves)
    buckets = []
    with torch.no_grad():
        for idx in by_kind.values():
            lens = [_shard_len(leaves[i].numel(), n) for i in idx]
            flat = torch.cat([_chunk_rows(leaves[i].detach(), n)[rank]
                              for i in idx])
            for i, view in zip(idx, flat.split(lens)):
                chunks[i] = torch.nn.Parameter(view)
            buckets.append((idx, lens, flat))
    return chunks, buckets


def zero_stacked_init(make_inner: Callable[[list], torch.optim.Optimizer],
                      leaves, n: int, rank: int):
    """The ZeRO state over ``leaves`` for the rank at index ``rank`` of a
    zero axis of ``n``: ``(chunks, optimizer)``, where ``chunks[i]`` is
    row ``rank`` of leaf ``i``'s JAX ``_chunk_rows`` layout (flattened,
    zero-padded to ``n * ceil(size / n)``), a view of one flat buffer per
    dtype (so one collective moves every chunk), and ``optimizer =
    make_inner(chunks)``. The state the optimizer keeps for ``chunks[i]``
    is row ``rank`` of the JAX ``jax.vmap(inner.init)(rows)`` state's
    ``[n, ...]`` leaf. :class:`ZeroShardOptimizer` (and through it the
    plan's ``zero`` groups) lays its chunks out this way."""
    chunks, _ = _chunk_buckets(list(leaves), n, rank)
    return chunks, make_inner(chunks)


class ZeroShardOptimizer:
    """ZeRO-1 over ``group``: the inner optimizer holds this rank's chunk
    of every parameter (``zero_param_chunk``) and its state; ``step``
    reduce-scatters the gradient means onto the chunks
    (:func:`zero_grad_scatter`), steps the inner optimizer and
    all-gathers the updated chunks into the parameters
    (:func:`zero_gather_updates`).

    The chunks of the parameters of one dtype are views of one flat
    buffer (:func:`zero_stacked_init`'s layout), so that each of the two
    collectives moves every leaf at once. A parameter without a gradient
    reduces zeros, as the JAX step gives every leaf a gradient; a
    parameter written since the last step (a load, an outside edit) hands
    its new values to its chunk. ``extra_group``, the other data-parallel
    ranks of a plan, adds one all-reduce of the chunk after the scatter
    (the mean then divides by both groups' ranks).
    ``param_groups`` lists the full parameters (what
    :func:`~chainermn_tpu_torch.training.create_train_state` checks);
    ``actual_optimizer`` is the inner one, over the chunks, and its
    ``state_dict`` is this rank's share."""

    #: make_train_step: this wrapper reduces the gradients itself
    handles_cross_rank_sync = True

    def __init__(self, make_inner: Callable[[list], torch.optim.Optimizer],
                 params: Iterable[torch.Tensor], group=None, *,
                 extra_group=None, compress_dtype=None) -> None:
        from chainermn_tpu_torch.communicators.base import _wire_dtype

        self.compress_dtype = _wire_dtype(compress_dtype)
        if self.compress_dtype == torch.int8:
            raise ValueError(
                "zero_shard_optimizer cannot ride the int8 wire: its "
                "reduce-scatter sums raw chunks, and the two-phase quantized "
                "scheme has no scatter form")
        self._params = list(params)
        if not self._params:
            raise ValueError("ZeroShardOptimizer got no parameters")
        self.group, self.n, self.rank = _group_of(group)
        self.extra_group = extra_group
        self._chunks, self._buckets = _chunk_buckets(self._params, self.n,
                                                     self.rank)
        self._seen = [self._mark(p) for p in self._params]
        self.actual_optimizer = make_inner(self._chunks)

    @staticmethod
    def _mark(p: torch.Tensor) -> tuple:
        """What changes when something writes ``p``."""
        return p._version, p.data_ptr()

    @property
    def param_groups(self) -> list:
        return [{"params": self._params}]

    @property
    def state(self):
        """The inner optimizer's per-chunk state."""
        return self.actual_optimizer.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        n = self.n
        for idx, lens, flat in self._buckets:
            for i in idx:
                p = self._params[i]
                if self._mark(p) != self._seen[i]:
                    self._chunks[i].copy_(zero_param_chunk(p, self.group))
            # every leaf's rows side by side: ``[n, sum c]`` is its own
            # ``_chunk_rows`` layout, so one scatter serves the bucket
            rows = torch.cat([_chunk_rows(
                torch.zeros_like(p) if p.grad is None else p.grad, n)
                for p in (self._params[i] for i in idx)], dim=1)
            part = zero_grad_scatter(rows, self.group,
                                     extra_group=self.extra_group,
                                     wire_dtype=self.compress_dtype)
            del rows
            for i, g in zip(idx, part.split(lens)):
                self._chunks[i].grad = g
        self.actual_optimizer.step()
        for idx, lens, flat in self._buckets:
            full = zero_gather_updates(
                flat, torch.empty((n, flat.numel()), dtype=flat.dtype,
                                  device="meta"), self.group)
            for i, rows in zip(idx, full.split(lens, dim=1)):
                p = self._params[i]
                p.copy_(_unchunk(rows, p.shape, p.dtype))
                self._seen[i] = self._mark(p)
                self._chunks[i].grad = None

    def state_dict(self) -> dict:
        return self.actual_optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.actual_optimizer.load_state_dict(state_dict)


def zero_shard_optimizer(make_inner, params, group=None, *,
                         compress_dtype=None) -> ZeroShardOptimizer:
    """Wrap an element-wise torch optimizer (``make_inner(params) ->
    Optimizer``, e.g. ``functools.partial(torch.optim.AdamW, lr=1e-3)``)
    with ZeRO-1 state sharding over ``group`` (a communicator, a process
    group, or None for the world)."""
    return ZeroShardOptimizer(make_inner, params, group,
                              compress_dtype=compress_dtype)


__all__ = ["ZeroShardOptimizer", "zero_gather_updates", "zero_grad_scatter",
           "zero_param_chunk", "zero_plan_axis", "zero_shard_optimizer",
           "zero_stacked_init", "zero_state_specs"]
