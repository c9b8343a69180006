"""Tensor (intra-layer model) parallelism over a process group
(counterpart of ``chainermn_tpu/parallel/tensor.py``).

Megatron-style column and row parallel layers as plain functions of this
rank's weight shards, with exactly one all-reduce per column→row pair
and the activation between them never gathered. The JAX functions run
inside ``shard_map`` over a ``'model'`` axis; here every rank of the
group (the axis; ``None`` is the default group, a communicator stands
for its group) calls them with its own shards, and a backward on every
rank gives each rank its shards' gradients.

Two identity/collective adjoint pairs do all the gradient bookkeeping
(Megatron's ``f``/``g``):

- :func:`copy_to_tp` — forward identity, backward all-reduce (sum):
  where a replicated activation fans out to per-rank weight columns.
- :func:`reduce_from_tp` — forward all-reduce (sum), backward identity:
  where per-rank partial products recombine.

Weights keep the JAX layout ``[d_in, d_out]`` (``x @ w``), so a JAX
shard carries over as it is; :func:`stack_tp_params` and
:func:`shard_qkv_columns` cut a full weight into the ``[n, ...]`` stack
of per-rank shards (rank ``i`` takes ``stack[i]``). :func:`tp_plan_axis`
is the ``model`` axis's spec provider of the
:class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch.parallel import collectives as C


def tp_plan_axis(axis_name: str = "model") -> dict:
    """Spec-provider descriptor of the ``model`` axis for the
    :class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`:
    tensor-parallel parameter leaves stack a leading ``[n, ...]`` shard dim
    over ``axis_name`` in the global view (the :func:`stack_tp_params`
    layout; each rank holds its slice), and the axis owes the step one
    all-reduce per column-to-row pair, forward and its mirror backward."""
    return {"name": axis_name, "stacked": True, "state_stacked": False,
            "collectives": ("all-reduce",)}


# ---------------------------------------------------------------------------
# Megatron f/g adjoint pairs
# ---------------------------------------------------------------------------

def copy_to_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; all-reduce (sum) over ``group`` backward.

    Wrap a replicated activation before it meets column-sharded weights:
    each rank computes an independent cotangent slice and the input's
    gradient is their sum. The forward is a view of ``x``: nothing is
    copied."""
    g = C.as_group(group)
    return C._linear(x, lambda v: v.view_as(v),
                     lambda ct: C._all_reduce(ct, g))


def reduce_from_tp(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward; identity backward.

    Recombines per-rank partial products (row-parallel outputs); the
    reduced value is replicated, so its gradient needs no collective."""
    g = C.as_group(group)
    return C._linear(x, lambda v: C._all_reduce(v, g), lambda ct: ct)


def gather_from_tp(x: torch.Tensor, group=None,
                   dim: int = -1) -> torch.Tensor:
    """All-gather the ranks' blocks along ``dim`` forward; this rank's
    block of the cotangent backward (Megatron's gather adjoint: after a
    gather the cotangent is replicated, so a reduce-scatter would count
    it once per rank)."""
    g = C.as_group(group)
    d = dim % x.dim()
    local = x.shape[d]

    def bwd(ct):
        return ct.narrow(d, dist.get_rank(g) * local, local).contiguous()

    return C._linear(x, lambda v: C._all_gather(v, g, d, True), bwd)


# ---------------------------------------------------------------------------
# Parameter sharding helpers
# ---------------------------------------------------------------------------

def tp_slice(w: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's slice of a full weight along ``dim``; ``dim`` must
    divide evenly by the group size (pad the layer width upstream)."""
    n = C.axis_size_of(group)
    size = w.shape[dim]
    if size % n != 0:
        raise ValueError(
            f"dim {dim} of shape {tuple(w.shape)} not divisible by group "
            f"size {n}; pad the layer width")
    local = size // n
    return w.narrow(dim, C.axis_index(group) * local, local)


def stack_tp_params(full: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Split a full weight into ``[n, ...]`` stacked shards along ``dim``
    (rank ``i`` of a group of ``n`` holds ``stack[i]``)."""
    if full.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(full.shape)} not "
                         f"divisible by {n}")
    return torch.stack(torch.chunk(full, n, dim), 0)


def shard_qkv_columns(w: torch.Tensor, n_q_heads: int, n_kv_heads: int,
                      head_dim: int, n: int) -> torch.Tensor:
    """Head-shard a FUSED QKV kernel ``[d_in, (Hq + 2 * Hkv) * dh]``.

    The fused layout concatenates ``[q | k | v]`` column groups, so a
    plain column split would hand rank 0 all of q. This splits each group
    by heads and concatenates per rank: rank ``i`` gets its ``Hq / n``
    query heads and its ``Hkv / n`` key and value heads. Returns ``[n,
    d_in, (Hq + 2 * Hkv) // n * dh]``."""
    if n_q_heads % n or n_kv_heads % n:
        raise ValueError(f"heads ({n_q_heads} q, {n_kv_heads} kv) not "
                         f"divisible by group size {n}")
    q, k, v = torch.split(w, [n_q_heads * head_dim, n_kv_heads * head_dim,
                              n_kv_heads * head_dim], dim=-1)
    ql = n_q_heads // n * head_dim
    kl = n_kv_heads // n * head_dim
    return torch.stack([torch.cat([q[:, i * ql:(i + 1) * ql],
                                   k[:, i * kl:(i + 1) * kl],
                                   v[:, i * kl:(i + 1) * kl]], dim=-1)
                        for i in range(n)], 0)


# ---------------------------------------------------------------------------
# Parallel layers
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def column_parallel_dense(x: torch.Tensor, w_local: torch.Tensor,
                          b_local: Optional[torch.Tensor] = None, *,
                          group=None,
                          gather_output: bool = False) -> torch.Tensor:
    """Output-dimension-sharded dense layer: ``w_local`` ``[d_in, d_out /
    n]``, ``b_local`` ``[d_out / n]``. The input is replicated; the output
    is this rank's column block (all of it when ``gather_output``)."""
    y = copy_to_tp(x, group) @ w_local
    if b_local is not None:
        y = y + b_local
    if gather_output:
        y = gather_from_tp(y, group, y.dim() - 1)
    return y


def row_parallel_dense(x_local: torch.Tensor, w_local: torch.Tensor,
                       b: Optional[torch.Tensor] = None, *,
                       group=None) -> torch.Tensor:
    """Input-dimension-sharded dense layer: ``x_local`` ``[..., d_in /
    n]`` (a column layer's output), ``w_local`` ``[d_in / n, d_out]``,
    ``b`` ``[d_out]`` replicated and added after the reduce. The one
    all-reduce of the column→row pair is here."""
    y = reduce_from_tp(x_local @ w_local, group)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x: torch.Tensor, w1_local: torch.Tensor,
           b1_local: Optional[torch.Tensor], w2_local: torch.Tensor,
           b2: Optional[torch.Tensor], *, group=None,
           activation: Callable[[torch.Tensor], torch.Tensor] = _gelu
           ) -> torch.Tensor:
    """The transformer MLP block, hidden dimension sharded: column dense,
    activation on the rank's hidden slice, row dense. One all-reduce
    forward, one backward."""
    h = column_parallel_dense(x, w1_local, b1_local, group=group)
    return row_parallel_dense(activation(h), w2_local, b2, group=group)


def tp_attention(x: torch.Tensor, wq_local: torch.Tensor,
                 wk_local: torch.Tensor, wv_local: torch.Tensor,
                 wo_local: torch.Tensor, *, group=None, n_heads: int,
                 causal: bool = False) -> torch.Tensor:
    """Multi-head attention with heads sharded over the group: each rank
    owns ``n_heads / n`` whole heads (``w{q,k,v}_local`` ``[d_model,
    d_model / n]``, ``wo_local`` ``[d_model / n, d_model]``). The QKV
    projections are column-parallel, the attention is local to the
    rank's heads (the port's plain :func:`~chainermn_tpu_torch.ops.
    attention.dot_product_attention`, fp32 accumulation, as the JAX
    layer delegates to its own), and the output projection is
    row-parallel: one all-reduce for the block."""
    from chainermn_tpu_torch.ops.attention import dot_product_attention

    n = C.axis_size_of(group)
    if n_heads % n != 0:
        raise ValueError(f"n_heads={n_heads} not divisible by group size "
                         f"{n}")
    heads_local = n_heads // n
    b, t, d_model = x.shape
    if d_model % n_heads != 0:
        raise ValueError(f"d_model={d_model} not divisible by "
                         f"n_heads={n_heads}")
    head_dim = d_model // n_heads
    xc = copy_to_tp(x, group)
    q = (xc @ wq_local).reshape(b, t, heads_local, head_dim)
    k = (xc @ wk_local).reshape(b, t, heads_local, head_dim)
    v = (xc @ wv_local).reshape(b, t, heads_local, head_dim)
    ctx = dot_product_attention(q, k, v, causal=causal)
    ctx = ctx.reshape(b, t, heads_local * head_dim)
    return row_parallel_dense(ctx, wo_local, group=group)


__all__ = ["column_parallel_dense", "copy_to_tp", "gather_from_tp",
           "reduce_from_tp", "row_parallel_dense", "shard_qkv_columns",
           "stack_tp_params", "tp_attention", "tp_mlp", "tp_plan_axis",
           "tp_slice"]
