"""Expert parallelism (MoE): top-k token routing over a process group of
expert shards (counterpart of ``chainermn_tpu/parallel/moe.py``).

Each rank of the group hosts ``experts_per_shard`` experts; a router
scores the rank's tokens, the tokens travel to their expert's rank in
one :func:`~chainermn_tpu_torch.parallel.collectives.alltoall`, the
expert MLPs run, and a second all-to-all brings the outputs back: two
all-to-alls a layer forward and, through their transposes, two backward,
whatever ``experts_per_shard`` is. Capacity-bounded queues give every
transfer a static shape ``[E, C, d]``, so every rank makes both calls a
layer in one order even when none of its tokens routes to a peer.

Capacity discipline: each expert takes at most ``capacity = ceil(tokens
* k / E * capacity_factor)`` tokens per shard; an overflowing choice is
dropped and its output is zero (callers add the residual path), and
``capacity_factor=None`` is the no-drop capacity of serving.

Routing follows the JAX functions exactly: the gate is the softmax
probability (normalised over the k choices for ``k > 1``), the choice is
the first maximum (``torch.argmax``, as ``jnp.argmax``), top-k picks in
logit space with an explicit taken-mask, and the queue bookkeeping
(cumsums, positions, slots) is integer whatever the logits' dtype. The
router product runs in the promoted dtype of the tokens and the router
(fp32 for bf16 tokens and an fp32 router), as JAX promotes it.

Where the JAX code names a mesh axis (``axis_name``, ``stats_axes``) the
port takes a process group (``None``: the default group) or a tuple of
them, reduced one after another.

Left for later, each raising ``NotImplementedError`` naming its ROADMAP
item: ``dispatch_impl='auto'`` and ``resolve_expert_parallel('auto')``
(the tuning registry, item 8), and :func:`record_moe_dispatch` (the
trace recorder, item 8).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.utils import prng

PyTree = Any

_AUTO = ("resolves through the tuning registry, which is not ported yet "
         "(ROADMAP queue 8, tuning: resolved from H100 measurements only)")


def _dense_from_slots(slots, logits, capacity):
    """Expand index-form routing into the dense ``(dispatch, combine)``
    pair (``[T, E, C]`` each, ``logits.dtype`` dispatch, the gates'
    dtype in the combine)."""
    n_experts = logits.shape[-1]
    sentinel = n_experts * capacity
    tokens = logits.shape[0]
    dispatch = logits.new_zeros((tokens, n_experts, capacity))
    combine = None
    for slot, gate in slots:
        # one_hot over sentinel+1 classes; the sentinel (dropped) column
        # is sliced off, zeroing dropped tokens
        oh = F.one_hot(slot, sentinel + 1).to(logits.dtype)
        oh = oh[:, :sentinel].reshape(tokens, n_experts, capacity)
        dispatch = dispatch + oh
        term = oh * gate[:, None, None]
        combine = term if combine is None else combine + term
    return dispatch, combine


def top1_route(logits: torch.Tensor, capacity: int):
    """Switch-style top-1 routing with capacity: ``(dispatch, combine)``,
    the ``[tokens, n_experts, capacity]`` one-hot dispatch mask and the
    mask times the gate probability."""
    return _dense_from_slots(route_slots(logits, capacity, 1), logits,
                             capacity)


def topk_route(logits: torch.Tensor, capacity: int, k: int = 2):
    """GShard-style top-k routing with capacity: each token's k chosen
    experts receive it in choice order (choice 0 fills the queues first),
    the gates are the chosen probabilities normalised over the k choices,
    and a dropped choice's share is lost (the kept one is not rescaled).
    The same ``(dispatch, combine)`` pair as :func:`top1_route`."""
    return _dense_from_slots(route_slots(logits, capacity, k), logits,
                             capacity)


def _mean_over(tensors: list, groups) -> list:
    """The mean of each tensor over ``groups`` (a group or a tuple of
    them, one after another), differentiable, one all-reduce a group."""
    gs = groups if isinstance(groups, (tuple, list)) else (groups,)
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for g in gs:
        flat = C.allreduce(flat, g, op="mean")
    return [p.view_as(t) for p, t in zip(flat.split(sizes), tensors)]


def load_balancing_loss(logits: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Switch/GShard auxiliary load-balancing loss ``n_experts *
    sum_e(fraction_e * mean_prob_e)`` (top-1 assignment fraction): 1 at
    perfect balance, near ``n_experts`` when routing collapses.

    ``axis_name``: None for the local tokens, or the group (or tuple of
    groups) the token dim is sharded over; the fraction and the mean
    probability are then averaged over it before the product, so the
    value is the global batch's whatever the layout (equal shards)."""
    n_experts = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    top1 = F.one_hot(torch.argmax(probs, dim=-1), n_experts).to(probs.dtype)
    frac = top1.mean(0)
    mean_prob = probs.mean(0)
    if axis_name is not None:
        frac, mean_prob = _mean_over([frac, mean_prob], axis_name)
    return n_experts * (frac * mean_prob).sum()


def routing_stats(logits: torch.Tensor, capacity: int, k: int = 1) -> dict:
    """Drop/pad accounting of one routing pass on this shard, float32:
    ``expert_load`` ``[n_experts]`` (kept tokens per expert), ``dropped``
    (overflowed choices, carried by the residual), ``padded`` (empty queue
    slots shipped anyway) and ``capacity``."""
    n_experts = logits.shape[-1]
    sentinel = n_experts * capacity
    dev = logits.device
    load = torch.zeros(n_experts, dtype=torch.float32, device=dev)
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    for slot, _ in route_slots(logits, capacity, k):
        kept = slot != sentinel
        expert = torch.where(kept, slot // capacity, 0)
        load = load + torch.where(
            kept[:, None], F.one_hot(expert, n_experts).float(), 0.0).sum(0)
        dropped = dropped + (~kept).float().sum()
    return {"expert_load": load, "dropped": dropped,
            "padded": float(sentinel) - load.sum(),
            "capacity": torch.tensor(float(capacity), device=dev)}


def route_slots(logits: torch.Tensor, capacity: int, k: int = 1):
    """Index-form routing: per choice ``(slot, gate)``, ``slot[t] =
    expert[t] * capacity + queue_pos[t]`` for a kept token and the
    sentinel ``n_experts * capacity`` for a dropped one (int64), ``gate``
    the (k-normalised) router weight. O(T E) bookkeeping."""
    n_experts = logits.shape[-1]
    if k > n_experts:
        raise ValueError(f"k={k} exceeds n_experts={n_experts}")
    probs = torch.softmax(logits, dim=-1)
    sentinel = n_experts * capacity

    if k == 1:
        expert = torch.argmax(probs, dim=-1)
        gate = probs.gather(-1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, n_experts)
        pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
        keep = pos < capacity
        slot = torch.where(keep, expert * capacity + pos, sentinel)
        return [(slot, gate)]

    # Top-k in LOGIT space with an explicit taken-mask: probability-space
    # masking re-picks expert 0 when the remaining mass underflows, and
    # -inf masking alone re-picks a taken expert when the caller pads
    # with -inf. A duplicate pick (every untaken expert -inf) is zeroed:
    # no queue slot, no gate. The bookkeeping stays integer: a bf16
    # cumsum collides queue slots past 256 tokens.
    taken = torch.zeros_like(logits, dtype=torch.int64)
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                           device=logits.device)
    chosen = []
    for _ in range(k):
        avail = torch.where(taken > 0, neg_inf, logits)
        expert = torch.argmax(avail, dim=-1)
        onehot = F.one_hot(expert, n_experts) * (1 - taken)
        gate = (probs * onehot).sum(-1)
        chosen.append((expert, onehot, gate))
        taken = taken + onehot

    denom = sum(g for _, _, g in chosen) + 1e-9
    counts = torch.zeros(n_experts, dtype=torch.int64, device=logits.device)
    out = []
    for expert, onehot, gate in chosen:
        pos = (torch.cumsum(onehot, 0) - 1) * onehot + counts[None, :]
        pos_tok = (pos * onehot).sum(-1)
        keep = (pos_tok < capacity) & (onehot.sum(-1) > 0)
        slot = torch.where(keep, expert * capacity + pos_tok, sentinel)
        out.append((slot, gate / denom))
        counts = counts + (onehot * keep[:, None]).sum(0)
        counts = torch.clamp(counts, max=capacity)
    return out


def dispatch_einsum(x, logits, capacity, k):
    """Dense one-hot dispatch (the reference): builds the ``[T, E, C]``
    dispatch and combine tensors. Returns ``(queues [E, C, d],
    combine_fn)``, ``combine_fn(back [E, C, d]) -> [T, d]``; each product
    runs in the promoted dtype of its operands, as the JAX einsums do."""
    if k == 1:
        dispatch, combine = top1_route(logits, capacity)
    else:
        dispatch, combine = topk_route(logits, capacity, k)
    qt = torch.promote_types(x.dtype, dispatch.dtype)
    queues = torch.einsum("td,tec->ecd", x.to(qt), dispatch.to(qt))

    def combine_fn(back):
        ct = torch.promote_types(back.dtype, combine.dtype)
        return torch.einsum("ecd,tec->td", back.to(ct), combine.to(ct))

    return queues, combine_fn


def dispatch_sort(x, logits, capacity, k):
    """Index dispatch: the queues are one integer scatter of token ids
    into slots plus one row gather, O(T d + E C d), no ``[T, E, C]``
    tensor. The routing is :func:`route_slots`' (as
    :func:`dispatch_einsum`'s), and the dtypes are the einsum path's.
    Dropped tokens all write the sentinel slot, which is sliced off, so
    the duplicate writes there never matter; every kept slot is written
    once."""
    tokens, d = x.shape
    n_experts = logits.shape[-1]
    slots = route_slots(logits, capacity, k)
    sentinel = n_experts * capacity
    q_dtype = torch.promote_types(x.dtype, logits.dtype)
    # which token fills each slot; empty slots gather the zero row
    token_of_slot = torch.full((sentinel + 1,), tokens, dtype=torch.int64,
                               device=x.device)
    ids = torch.arange(tokens, device=x.device)
    for slot, _ in slots:
        token_of_slot = token_of_slot.index_put((slot,), ids)
    x_pad = torch.cat([x, x.new_zeros((1, d))]).to(q_dtype)
    queues = x_pad[token_of_slot[:sentinel]].reshape(n_experts, capacity, d)

    def combine_fn(back):
        gate_dtype = slots[0][1].dtype
        out_dtype = torch.promote_types(back.dtype, gate_dtype)
        flat = torch.cat([back.reshape(sentinel, d),
                          back.new_zeros((1, d))]).to(out_dtype)
        out = flat.new_zeros((tokens, d))
        for slot, gate in slots:
            out = out + flat[slot] * gate[:, None].to(out_dtype)
        return out

    return queues, combine_fn


_DISPATCH = {"einsum": dispatch_einsum, "sort": dispatch_sort}


def resolve_dispatch_impl(tokens: int, n_experts: int, d_model: int, dtype,
                          impl: str = "auto") -> str:
    """The dispatch impl: an explicit ``'sort'`` or ``'einsum'`` passes
    through. ``'auto'`` raises: the JAX package resolves it through its
    tuning registry (whose default table says ``'sort'`` on every
    backend), which the port has not yet (ROADMAP queue 8)."""
    if impl == "auto":
        raise NotImplementedError(
            f"dispatch_impl='auto' {_AUTO}; pass 'sort' or 'einsum' "
            f"(the JAX default table's choice is 'sort' everywhere)")
    return impl


def moe_capacity(tokens: int, n_experts: int, k: int,
                 capacity_factor: Optional[float]) -> int:
    """The static per-expert queue depth ``ceil(tokens * k / n_experts *
    capacity_factor)``, at least 1 (``capacity_factor=0``: one slot per
    expert). ``None`` is the no-drop capacity ``tokens``, the serving
    contract: routing never couples co-resident rows."""
    if capacity_factor is None:
        return max(1, tokens)
    if capacity_factor < 0:
        raise ValueError(
            f"capacity_factor must be >= 0 (or None for no-drop), got "
            f"{capacity_factor}")
    return max(1, math.ceil(tokens * k / n_experts * capacity_factor))


def resolve_expert_parallel(tokens: int, n_experts: int, d_model: int,
                            dtype, choice: str = "auto") -> str:
    """``'on'``/``'off'``: whether an MoE workload spreads over an
    ``expert`` group. An explicit choice passes through; ``'auto'``
    raises (the tuning registry, ROADMAP queue 8)."""
    if choice == "auto":
        raise NotImplementedError(f"resolve_expert_parallel('auto') {_AUTO}; "
                                  f"pass 'on' or 'off'")
    return choice


def _sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    gs = groups if isinstance(groups, (tuple, list)) else (groups,)
    for g in gs:
        t = C._all_reduce(t, C.as_group(g))
    return t


def moe_layer_local(x: torch.Tensor, router_w: torch.Tensor,
                    expert_fn: Callable, expert_params: PyTree,
                    axis_name=None, *,
                    capacity_factor: Optional[float] = 1.25, k: int = 1,
                    dispatch_impl: str = "auto", experts_per_shard: int = 1,
                    return_stats: bool = False, stats_axes=None):
    """One MoE layer on this rank: ``experts_per_shard`` experts on each
    rank of ``axis_name`` (a process group or communicator; None: the
    default group), global expert ``e`` on rank ``e // experts_per_shard``.
    ``x`` is ``[tokens_local, d_model]``, ``router_w`` ``[d_model,
    n_experts_global]``, ``expert_fn(params, rows [m, d]) -> [m, d]``.

    ``dispatch_impl``: ``'einsum'`` (dense one-hot, the reference) or
    ``'sort'`` (index scatter and gather); the same routing and the same
    numbers. ``experts_per_shard > 1``: ``expert_params`` leaves stack a
    leading ``[experts_per_shard, ...]`` dim and ``expert_fn`` is mapped
    over it (``torch.func.vmap``); each all-to-all ships that many queues
    to a peer, so there are still exactly two a layer.

    Returns the combined expert outputs of the local tokens (zeros for
    dropped ones: add the residual outside); with ``return_stats=True``
    ``(out, aux)``: ``aux['load_balance']`` (layout-invariant, averaged
    over ``stats_axes``) and :func:`routing_stats`' totals summed over
    ``stats_axes`` (default ``axis_name``; under a composed plan every
    group the token dim shards over), float32."""
    group = C.as_group(axis_name)
    if group is None:  # the default group, named: None means "local" below
        group = dist.group.WORLD
    n = C.axis_size_of(group)
    eps = int(experts_per_shard)
    tokens, d = x.shape
    e_global = n * eps
    if router_w.shape[-1] != e_global:
        raise ValueError(
            f"router_w scores {router_w.shape[-1]} experts but the expert "
            f"group hosts {e_global} ({n} shards x {eps} experts/shard)")
    capacity = moe_capacity(tokens, e_global, k, capacity_factor)
    rt = torch.promote_types(x.dtype, router_w.dtype)
    logits = x.to(rt) @ router_w.to(rt)  # [tokens, e_global]
    impl = resolve_dispatch_impl(tokens, e_global, d, x.dtype, dispatch_impl)
    if impl not in _DISPATCH:
        raise ValueError(f"dispatch_impl must be 'sort', 'einsum' or "
                         f"'auto', got {impl!r}")
    queues, combine_fn = _DISPATCH[impl](x, logits, capacity, k)
    # rank i sends queue rows [j*eps, (j+1)*eps) to rank j and receives
    # its experts' queues from every rank: [n (senders) * eps, C, d]
    recv = C.alltoall(queues, group, split_axis=0, concat_axis=0)
    recv = recv.reshape(n, eps, capacity, d).transpose(0, 1)
    if eps == 1:
        out = expert_fn(expert_params, recv.reshape(n * capacity, d))
        out = out.reshape(1, n, capacity, d)
    else:
        out = torch.func.vmap(expert_fn)(
            expert_params, recv.reshape(eps, n * capacity, d))
        out = out.reshape(eps, n, capacity, d)
    # back to global-expert-major order for the return trip
    out = out.transpose(0, 1).reshape(e_global, capacity, d)
    back = C.alltoall(out, group, split_axis=0, concat_axis=0)
    combined = combine_fn(back)
    if not return_stats:
        return combined
    with torch.no_grad():
        stats = routing_stats(logits, capacity, k)
    red = group if stats_axes is None else stats_axes
    with torch.no_grad():
        counts = _sum_over(torch.cat([stats["expert_load"],
                                      stats["dropped"].reshape(1),
                                      stats["padded"].reshape(1)]), red)
    aux = {"load_balance": load_balancing_loss(logits, red),
           "expert_load": counts[:e_global], "dropped": counts[e_global],
           "padded": counts[e_global + 1], "capacity": stats["capacity"]}
    return combined, aux


def record_moe_dispatch(stats, *, layer: Optional[int] = None) -> None:
    """Not ported yet: the ``moe_dispatch`` trace event needs the trace
    recorder (``active()``, ``event``), ROADMAP queue 8."""
    raise NotImplementedError(
        "record_moe_dispatch is not ported yet (ROADMAP queue 8, "
        "observability: the trace recorder and its moe_dispatch event)")


def make_expert_params(init_fn: Callable, rng, n_experts: int) -> PyTree:
    """Stack ``n_experts`` param trees, expert ``i`` drawn by
    ``init_fn(key_i)`` from the ``i``-th key of ``prng.split(rng,
    n_experts)``, along a new leading dim (what an ``expert`` group
    shards)."""
    keys = prng.split(prng._as_key(rng), n_experts)
    trees = [init_fn(keys[i]) for i in range(n_experts)]
    flat = [pytree.tree_flatten(t)[0] for t in trees]
    spec = pytree.tree_flatten(trees[0])[1]
    return pytree.tree_unflatten(
        [torch.stack(ls) for ls in zip(*flat)], spec)


__all__ = ["dispatch_einsum", "dispatch_sort", "load_balancing_loss",
           "make_expert_params", "moe_capacity", "moe_layer_local",
           "record_moe_dispatch", "resolve_dispatch_impl",
           "resolve_expert_parallel", "route_slots", "routing_stats",
           "top1_route", "topk_route"]
