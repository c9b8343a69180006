"""Transformer-base LM (counterpart of
``chainermn_tpu/models/transformer.py``): 6 layers, d_model 512, 8 heads,
d_ff 2048 by default; pre-LN; bf16 compute over fp32 parameters.

What is ported: the dense-FFN block with GQA (``num_kv_heads``), learned
or rotary positions, the training forward through a pluggable
``attention_fn`` (default :func:`~chainermn_tpu_torch.ops.attention.
blockwise_attention`; pass :func:`~chainermn_tpu_torch.ops.
flash_attention.flash_attention` for packed ``segment_ids`` or a
``window``), the bidirectional MLM encoder (``causal=False``,
:func:`mlm_loss`, :func:`mlm_corrupt`), residual dropout drawn from an
explicit ``torch.Generator``, per-block rematerialisation (``remat``,
``remat_policy`` ``'dots'`` or ``'nothing'``), ``return_hidden`` with
:func:`lm_loss` and the chunked :func:`lm_loss_fused`, and decoding:

- the serving engine's slot-decode path over either cache layout
  (``kv_layout``): ``'paged'`` (the shared block pool and per-slot block
  tables) or ``'dense'`` (``[n_slots, decode_cache_len, kvh, dh]`` per
  block, ``decode_slots`` mapping a prefill's row onto its cache row),
  each with both attend impls — ``'fused'`` (K4's CUDA kernels,
  :func:`~chainermn_tpu_torch.ops.paged_decode.paged_flash_decode` and
  :func:`~chainermn_tpu_torch.ops.paged_decode.dense_flash_decode`) and
  ``'xla'`` (the dense view, then a masked softmax in torch ops);
- the legacy dense ring of :func:`generate` and :func:`beam_search`
  (:func:`init_cache`: one ``[B, max_len, kvh, dh]`` ring per block with a
  shared write index), with counter-keyed sampling
  (:func:`stream_sample_keys`, :mod:`chainermn_tpu_torch.utils.prng`).

The numerics follow the flax module: LayerNorm with epsilon 1e-6 and fp32
statistics, the tanh GELU, parameters cast to the compute dtype for each
product, and the tied head computed in the compute dtype. Caches are
explicit lists of per-block dicts that the caller passes and the model
writes in place; no state hides in the module.

Tensor parallelism (``tp_group``): a block built with this rank's LOCAL
``num_heads``/``num_kv_heads``/``d_ff`` and an explicit ``head_dim``
holds its shard of every column/row weight and makes exactly one
all-reduce per column→row pair, two per layer (:meth:`TransformerLM.
clone` cuts a full model down to such a shard; :func:`~chainermn_tpu_torch.
serving.engine.shard_lm_params` gives the weights).

Mixture of experts (``n_experts > 0``): every block's dense FFN becomes
``n_experts`` expert MLPs behind a top-1 router (the ``moe_router``,
``moe_w_up``, ``moe_b_up``, ``moe_w_down`` and ``moe_b_down`` leaves,
the expert leaves stacking a leading ``[E, ...]`` dim), in two forms:
with ``expert_axis`` None every expert is evaluated and a one-hot times
the gate combines them (the reference form: training, ``generate`` and
the engine without a mesh); with ``expert_axis`` a process group (the
serving engine's TP group) the ownership-split form routes this rank's
slice of the token rows through :func:`~chainermn_tpu_torch.parallel.
moe.moe_layer_local` to the experts' owners and back, and one all-reduce
re-replicates the rows.

Left for later: LoRA adapters and MoE with them (ROADMAP queue 1, item
7), ``sow_kv``.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.ops.attention import blockwise_attention
from chainermn_tpu_torch.models._decode_common import rank_beams
from chainermn_tpu_torch.ops.paged_decode import (
    dense_flash_decode,
    paged_flash_decode,
)
from chainermn_tpu_torch.ops.paged_kv import paged_lookup, paged_update
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel.moe import moe_layer_local
from chainermn_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp
from chainermn_tpu_torch.utils import prng

DECODE_ATTEND_IMPLS = ("xla", "fused")
KV_LAYOUTS = ("paged", "dense")


def apply_rope(x, positions, base: float = 10000.0):
    """Rotary position embedding on ``[B, T, H, Dh]`` (half-split pairing).

    ``positions``: ``[T]`` positions shared by the batch, or ``[B, T]``
    per-row positions (the serving engine's slot array, where every slot
    sits at a different depth).
    """
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # [..., T, half]
    if ang.dim() == 2:  # [T, half]: shared across the batch
        cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
        sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    else:  # [B, T, half]: per-row slot positions
        cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
        sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: epsilon 1e-6, statistics in fp32 (variance
    as E[x^2] - E[x]^2, clipped at 0), fp32 scale/bias, output in the
    compute dtype."""

    EPS = 1e-6

    def __init__(self, dim: int, *, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.EPS) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


def _dense(layer: nn.Linear, x, dtype):
    """flax ``nn.Dense`` with ``dtype``: input, kernel and bias all cast
    to the compute dtype for the product."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _dense_write(cache_t, rows, cols, new):
    """``cache_t[rows[b], cols[b, t]] = new[b, t]`` for ``cols < L``, in
    place; a column at or past ``L`` is dropped, as JAX's ``.at[].set``
    drops an out-of-bounds write. Without a host sync: a dropped column
    is aimed at ``cols % L`` and writes back what is there (for spans of
    at most ``L`` tokens that cell is none of the row's kept columns)."""
    L = cache_t.shape[1]
    rows = rows[:, None].expand_as(cols)
    at = cols % L
    keep = (cols < L)[:, :, None, None]
    cache_t[rows, at] = torch.where(keep, new, cache_t[rows, at])


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + proj(attn(LN(x)))`` then ``x + FFN(LN(x))``.

    ``tp_group`` (a process group or a communicator; None: no tensor
    parallelism) makes the block one rank's shard of a tensor-parallel
    block: ``num_heads``, ``num_kv_heads`` and ``d_ff`` are then this
    rank's (set ``head_dim``, since ``d_model // num_heads`` no longer
    holds), ``qkv`` and ``ff_up`` are column shards and ``proj`` and
    ``ff_down`` row shards. The normed input is wrapped in
    :func:`~chainermn_tpu_torch.parallel.tensor.copy_to_tp` before
    ``qkv`` and ``ff_up``, and the outputs of ``proj`` and ``ff_down``
    in :func:`~chainermn_tpu_torch.parallel.tensor.reduce_from_tp`: one
    all-reduce per column→row pair. ``ff_down``'s bias rides inside the
    reduce, so the shard holds ``bias / n``.

    ``n_experts > 0`` replaces ``ff_up``/``ff_down`` by the MoE leaves
    (:meth:`_moe_ffn`); the MoE branch takes no ``copy_to_tp``/
    ``reduce_from_tp`` pair, so under ``tp_group`` alone every rank runs
    the dense MoE form on full expert leaves. ``expert_axis`` (a process
    group) selects the ownership-split form, whose expert leaves hold
    ``moe_experts_local`` (default ``n_experts``) experts."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *,
                 compute_dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None,
                 decode_attend_impl: str = "xla", causal: bool = True,
                 dropout_rate: float = 0.0, kv_layout: str = "paged",
                 head_dim: Optional[int] = None, tp_group=None,
                 n_experts: int = 0, expert_axis=None,
                 moe_dispatch_impl: str = "auto",
                 moe_experts_local: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        if decode_attend_impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(
                f"decode_attend_impl must be 'xla' or 'fused', got "
                f"{decode_attend_impl!r}")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be 'paged' or 'dense', got "
                             f"{kv_layout!r}")
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.compute_dtype = compute_dtype
        #: the training forward's attention, called as ``attention_fn(q,
        #: k, v, causal=self.causal, scale=..., [segment_ids=...])`` on
        #: BTHD heads; None means the blockwise reference, which takes
        #: neither a window nor segment ids
        self.attention_fn = attention_fn
        #: False: every position attends both directions (the MLM
        #: encoder); decode and the window need True
        self.causal = causal
        #: residual dropout on the attention and FFN branches (never on
        #: the attention matrix); the masks come in from the caller
        self.dropout_rate = dropout_rate
        self.num_kv_heads = num_kv_heads
        self.window = window
        self.decode_attend_impl = decode_attend_impl
        #: the slot-decode cache layout (:meth:`_slot_decode_attend`)
        self.kv_layout = kv_layout
        #: the tensor-parallel group (None: the whole block on this rank)
        self.tp_group = tp_group
        self.head_dim = head_dim or d_model // num_heads
        kv_heads = num_kv_heads or num_heads
        dt = dict(dtype=compute_dtype, device=device)
        self.ln1 = LayerNorm(d_model, **dt)
        self.qkv = nn.Linear(d_model, (num_heads + 2 * kv_heads)
                             * self.head_dim, bias=False, device=device)
        self.proj = nn.Linear(num_heads * self.head_dim, d_model, bias=False,
                              device=device)
        self.ln2 = LayerNorm(d_model, **dt)
        #: the global expert count (0: the dense FFN)
        self.n_experts = n_experts
        #: the ownership-split form's process group (None: the dense form)
        self.expert_axis = expert_axis
        self.moe_dispatch_impl = moe_dispatch_impl
        if n_experts > 0:
            e = moe_experts_local or n_experts
            f32 = dict(dtype=torch.float32, device=device)
            self.moe_router = nn.Parameter(torch.empty(d_model, n_experts,
                                                       **f32))
            self.moe_w_up = nn.Parameter(torch.empty(e, d_model, d_ff,
                                                     **f32))
            self.moe_b_up = nn.Parameter(torch.empty(e, d_ff, **f32))
            self.moe_w_down = nn.Parameter(torch.empty(e, d_ff, d_model,
                                                       **f32))
            self.moe_b_down = nn.Parameter(torch.empty(e, d_model, **f32))
        else:
            self.ff_up = nn.Linear(d_model, d_ff, device=device)
            self.ff_down = nn.Linear(d_ff, d_model, device=device)

    def _decode_attend(self, qh, kh_new, vh_new, cache):
        """One-token attention against the legacy dense ring of
        :func:`generate`: ``cache`` holds ``cached_key``/``cached_value``
        ``[B, L, kvh, dh]`` and the 0-d write index ``cache_index``
        (advanced here by one). Every row writes at the shared index and
        attends to ``pos <= index`` (and ``pos > index - window``), with
        fp32 scores over the whole ring; masked positions cost reads, not
        correctness."""
        if cache is None:
            raise ValueError("decode=True without decode_positions needs "
                             "cache= (init_cache)")
        B, T = qh.shape[:2]
        if T != 1:
            raise ValueError(
                f"decode=True expects one token per step, got T={T}")
        kv_heads = kh_new.shape[2]
        dt = self.compute_dtype
        ck, cv = cache["cached_key"], cache["cached_value"]
        i = cache["cache_index"]
        at = i.reshape(1).long()
        ck.index_copy_(1, at, kh_new.to(dt))
        cv.index_copy_(1, at, vh_new.to(dt))
        cache["cache_index"] = i + 1
        pos = torch.arange(ck.shape[1], device=qh.device)
        mask = pos <= i
        if self.window is not None:
            mask &= pos > i - self.window
        group = self.num_heads // kv_heads
        q = qh[:, 0].reshape(B, kv_heads, group, self.head_dim)
        scores = torch.einsum("bngd,blnd->bngl", q.float(),
                              ck.float()) * self.head_dim ** -0.5
        scores = scores.masked_fill(~mask, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bngl,blnd->bngd", w, cv.float())
        return o.reshape(B, 1, self.num_heads, self.head_dim).to(dt)

    def _slot_decode_attend(self, qh, kh_new, vh_new, positions,
                            block_tables, cache, slots=None):
        """Slot-array cached attention (the serving engine's path). Every
        batch row carries its OWN position: its ``T >= 1`` new tokens are
        written at ``positions[b] + t`` and query ``t`` attends to ``pos <=
        positions[b] + t``. ``T == 1`` is the decode step, ``T == bucket``
        the prefill (pad writes land beyond the row's true length, or in
        scratch, and are re-written before any mask admits them).

        Two cache layouts behind one arithmetic (``kv_layout``):
        ``'paged'`` writes into the shared block pool through
        ``block_tables``; ``'dense'`` writes ``cached_key``/``cached_value``
        ``[n_slots, L, kvh, dh]`` at cache row ``slots[b]`` (a prefill of
        one slot) or ``b`` (``slots`` None: the decode tick over every
        slot). A dense write past the ring's end (a span overhanging
        ``L``) is dropped, as JAX's ``.at[].set`` drops it. The write is
        the same for both impls; only the read differs: ``'fused'`` is
        one pass of K4's CUDA kernels over the live blocks, ``'xla'``
        reads the dense view and attends with torch ops.
        """
        if cache is None:
            raise ValueError("the slot-decode path needs cache=")
        B, T = qh.shape[:2]
        dt = self.compute_dtype
        scale = self.head_dim ** -0.5
        if self.kv_layout == "paged":
            if block_tables is None:
                raise ValueError("kv_layout='paged' needs block_tables=")
            pk, pv = cache["pool_key"], cache["pool_value"]
            paged_update(pk, block_tables, positions, kh_new.to(dt))
            paged_update(pv, block_tables, positions, vh_new.to(dt))
            if self.decode_attend_impl == "fused":
                # Scratch block 0 is masked in-kernel: a released slot's
                # garbage and beyond-horizon writes never reach a live row.
                return paged_flash_decode(
                    qh.to(dt).contiguous(), pk, pv, block_tables, positions,
                    window=self.window, scale=scale, scratch_block=0)
            keys = paged_lookup(pk, block_tables)
            vals = paged_lookup(pv, block_tables)
        else:
            ck, cv = cache["cached_key"], cache["cached_value"]
            rows = (torch.arange(B, device=qh.device) if slots is None
                    else slots.long())
            cols = (positions.long()[:, None]
                    + torch.arange(T, device=qh.device)[None])
            _dense_write(ck, rows, cols, kh_new.to(dt))
            _dense_write(cv, rows, cols, vh_new.to(dt))
            if self.decode_attend_impl == "fused":
                return dense_flash_decode(
                    qh.to(dt).contiguous(), ck, cv, positions, slots=slots,
                    window=self.window, scale=scale)
            keys = ck if slots is None else ck[rows]
            vals = cv if slots is None else cv[rows]
        L = keys.shape[1]
        pos_l = torch.arange(L, device=qh.device)
        qpos = (positions.long()[:, None]
                + torch.arange(T, device=qh.device)[None])
        mask = pos_l[None, None, :] <= qpos[:, :, None]  # [B, T, L]
        if self.window is not None:
            mask &= pos_l[None, None, :] > qpos[:, :, None] - self.window
        kv_heads = keys.shape[2]
        group = self.num_heads // kv_heads
        q = qh.reshape(B, T, kv_heads, group, self.head_dim)
        scores = torch.einsum("btngd,blnd->btngl", q.float(),
                              keys.float()) * scale
        scores = scores.masked_fill(~mask[:, :, None, None, :],
                                    float("-inf"))
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("btngl,blnd->btngd", w, vals.float())
        return o.reshape(B, T, self.num_heads, self.head_dim).to(dt)

    def _moe_ffn(self, h):
        """Top-1 mixture-of-experts FFN of the normed rows ``h`` ``[B, T,
        D]`` (the JAX ``_moe_ffn``). Routing is per row, so the same code
        serves training, prefill and the decode tick.

        The router product runs in fp32 (``h`` promoted to the fp32
        router's dtype, as JAX promotes it): bf16 logits would pick other
        experts. With ``expert_axis`` None every expert runs and a one-hot
        times the gate combines them, in the compute dtype; rows never
        couple, so the engine's streams equal ``generate``'s. With
        ``expert_axis`` set: the rows padded to a multiple of the group
        size ``n``, this rank's slice routed through
        :func:`~chainermn_tpu_torch.parallel.moe.moe_layer_local` (no-drop
        capacity: serving drops nothing; two all-to-alls), scattered into
        a zero buffer, and ONE all-reduce over the group re-replicates
        them (the MoE counterpart of ``ff_down``'s reduce). The expert
        MLP there runs in the queues' promoted dtype, as JAX's does."""
        cd = self.compute_dtype
        router = self.moe_router
        w_up, b_up = self.moe_w_up, self.moe_b_up
        w_down, b_down = self.moe_w_down, self.moe_b_down
        rt = torch.promote_types(h.dtype, router.dtype)
        if self.expert_axis is None:
            e_eff = w_up.shape[0]
            logits = h.to(rt) @ router[:, :e_eff].to(rt)
            probs = torch.softmax(logits, dim=-1)
            gate, idx = probs.max(-1).values, torch.argmax(probs, dim=-1)
            up = (torch.einsum("...d,edf->...ef", h, w_up.to(cd))
                  + b_up.to(cd))
            down = (torch.einsum("...ef,efd->...ed",
                                 F.gelu(up, approximate="tanh"),
                                 w_down.to(cd)) + b_down.to(cd))
            combine = (F.one_hot(idx, e_eff).to(down.dtype)
                       * gate.to(down.dtype)[..., None])
            return torch.einsum("...ed,...e->...d", down, combine)

        group = C.as_group(self.expert_axis)
        n, r = C.axis_size_of(group), C.axis_index(group)
        eps = w_up.shape[0]  # this rank's experts, not n_experts
        B, T, D = h.shape
        rows = B * T
        own = -(-rows // n)
        hr = F.pad(h.reshape(rows, D), (0, 0, 0, own * n - rows))
        mine = hr[r * own:(r + 1) * own]
        eparams = (w_up.to(cd), b_up.to(cd), w_down.to(cd), b_down.to(cd))
        if eps == 1:
            eparams = tuple(leaf[0] for leaf in eparams)
        out = moe_layer_local(mine, router, _expert_mlp, eparams, group,
                              capacity_factor=None,
                              dispatch_impl=self.moe_dispatch_impl,
                              experts_per_shard=eps)
        full = F.pad(out, (0, 0, r * own, (n - 1 - r) * own))
        full = C.allreduce(full, group)  # the one re-replicating reduce
        return full[:rows].reshape(B, T, D)

    def _dropout(self, h, mask):
        """flax ``nn.Dropout``: kept entries scaled by 1/(1 - rate), the
        rest 0; ``mask`` (bool, True = keep) is None outside training."""
        if mask is None:
            return h
        return torch.where(mask, h / (1.0 - self.dropout_rate),
                           torch.zeros_like(h))

    def forward(self, x, segment_ids=None, rope_positions=None,
                decode: bool = False, decode_positions=None,
                block_tables=None, cache=None, dropout_masks=None,
                decode_slots=None):
        """``dropout_masks``: ``(attention branch, FFN branch)`` bool keep
        masks of ``x``'s shape, or None (no dropout). They are drawn by
        :class:`TransformerLM` outside any rematerialised region, so a
        recomputed block applies the same masks."""
        dt = self.compute_dtype
        kv_heads = self.num_kv_heads or self.num_heads
        hd = self.head_dim
        B, T = x.shape[:2]
        tp = self.tp_group is not None
        h = self.ln1(x)
        if tp:
            h = copy_to_tp(h, self.tp_group)
        qkv = _dense(self.qkv, h, dt)
        q, k, v = torch.split(
            qkv, [self.num_heads * hd, kv_heads * hd, kv_heads * hd], dim=-1)
        qh = q.reshape(B, T, self.num_heads, hd)
        kh = k.reshape(B, T, kv_heads, hd)
        vh = v.reshape(B, T, kv_heads, hd)
        if rope_positions is not None:
            qh = apply_rope(qh, rope_positions)
            kh = apply_rope(kh, rope_positions)
        if decode:
            if not self.causal:
                raise ValueError("decode=True requires a causal block")
            if decode_positions is None:
                o = self._decode_attend(qh, kh, vh, cache)
            else:
                o = self._slot_decode_attend(qh, kh, vh, decode_positions,
                                             block_tables, cache,
                                             decode_slots)
        else:
            if self.window is not None and self.attention_fn is None:
                raise ValueError(
                    "window needs a window-honouring attention_fn (e.g. "
                    "flash_attention(..., window=W)); the default blockwise "
                    "reference has no window support")
            if self.window is not None and not self.causal:
                raise ValueError("window requires a causal block")
            attn = self.attention_fn or blockwise_attention
            kw = {} if segment_ids is None else {"segment_ids": segment_ids}
            o = attn(qh, kh, vh, causal=self.causal, scale=hd ** -0.5, **kw)
        m_attn, m_ffn = dropout_masks or (None, None)
        o = _dense(self.proj, o.reshape(B, T, self.num_heads * hd), dt)
        if tp:  # the attention pair's one all-reduce
            o = reduce_from_tp(o, self.tp_group)
        x = x + self._dropout(o, m_attn)
        h = self.ln2(x)
        if self.n_experts > 0:
            return x + self._dropout(self._moe_ffn(h), m_ffn)
        if tp:
            h = copy_to_tp(h, self.tp_group)
        h = F.gelu(_dense(self.ff_up, h, dt), approximate="tanh")
        h = _dense(self.ff_down, h, dt)
        if tp:  # the FFN pair's: ff_down's bias / n sums back to the bias
            h = reduce_from_tp(h, self.tp_group)
        return x + self._dropout(h, m_ffn)


def _expert_mlp(p, xq):
    """One expert's MLP on its queue rows, in the promoted dtype of the
    rows and the weights (JAX's ``xq @ wu`` promotion)."""
    wu, bu, wd, bd = p
    t = torch.promote_types(xq.dtype, wu.dtype)
    h = F.gelu(xq.to(t) @ wu.to(t) + bu.to(t), approximate="tanh")
    return h @ wd.to(t) + bd.to(t)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy='dots'``: keep the
    matmul outputs, recompute the rest (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``'s role)."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat_policy: str):
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint`` (JAX
    ``_remat_block``'s policy switch)."""
    if remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    if remat_policy == "nothing":
        return None  # plain checkpoint: save only the block's inputs
    raise ValueError(f"remat_policy must be 'dots' or 'nothing', got "
                     f"{remat_policy!r}")


class TransformerLM(nn.Module):
    """LM over integer tokens ``[B, T]`` -> logits ``[B, T, vocab]`` in
    the compute dtype; causal, or the bidirectional MLM encoder with
    ``causal=False`` (pair with :func:`mlm_loss`; decode and ``window``
    are refused).

    ``attention_fn`` is the training forward's attention (see
    :class:`TransformerBlock`); ``return_hidden=True`` skips the tied head
    and returns the final post-LN hidden states (pair with
    :func:`lm_loss_fused`).

    ``dropout_rate`` drops entries of each block's attention and FFN
    branch outputs before the residual add (not the attention matrix), in
    training mode only (``model.train()``, the default), with keep masks
    drawn from the ``dropout_generator`` given to :meth:`forward` on the
    model's device; in eval mode it is inert and needs no generator.

    ``remat=True`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant, the JAX
    ``nn.remat(TransformerBlock)``). ``remat_policy='dots'`` keeps the
    outputs of the matmuls (``aten.mm``/``addmm``/``bmm``) through a
    selective-checkpoint policy and recomputes the rest; ``'nothing'``
    keeps only each block's inputs. Under both policies the flash
    attention ``autograd.Function``'s forward (K1) runs again in the
    backward: its kernel launch is not an aten op a policy can keep, and
    its saved O and LSE go with the block's other saved tensors — as the
    JAX ``pallas_call`` is not a dot that ``dots_with_no_batch_dims_
    saveable`` keeps. K2 and K3 run once either way. Dropout masks are
    drawn before a block is entered and passed into it, so the recomputed
    block applies the masks of its forward; the global RNG states are not
    stashed (``preserve_rng_state=False``), since no block draws from
    them.

    ``n_experts > 0`` makes every block's FFN a top-1 mixture of experts
    (see :class:`TransformerBlock`): ``n_experts`` is the GLOBAL count,
    ``expert_axis`` the ownership-split form's process group (the serving
    engine's TP group), ``moe_dispatch_impl`` that form's queue build
    (``'sort'``/``'einsum'``; ``'auto'`` raises there, ROADMAP item 8, and
    is never resolved by the dense form), and ``moe_experts_local`` the
    leading dim of this model's expert leaves (default ``n_experts``).

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``
    (the flax initialisers' scales: embedding ``1/sqrt(d_model)``, dense
    kernels ``1/sqrt(fan_in)``, learned positions 0.02; the MoE router
    normal(0.02), its expert kernels truncated normal at the fan-in scale,
    biases 0), or loaded from a flax tree with
    :func:`chainermn_tpu_torch.convert.lm_state_from_flax`.
    ``device=None`` means the CUDA card and raises without one.
    """

    def __init__(self, vocab_size: int = 32000, num_layers: int = 6,
                 num_heads: int = 8, d_model: int = 512, d_ff: int = 2048,
                 max_len: int = 2048, compute_dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 return_hidden: bool = False,
                 num_kv_heads: Optional[int] = None,
                 pos_encoding: str = "learned",
                 window: Optional[int] = None,
                 decode_attend_impl: str = "xla", *, seed: int = 0,
                 dropout_rate: float = 0.0, remat: bool = False,
                 remat_policy: str = "dots", causal: bool = True,
                 kv_layout: str = "paged",
                 decode_cache_len: Optional[int] = None,
                 head_dim: Optional[int] = None, tp_group=None,
                 n_experts: int = 0, expert_axis=None,
                 moe_dispatch_impl: str = "auto",
                 moe_experts_local: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        self._remat_context = _remat_context(remat_policy)
        if pos_encoding not in ("learned", "rope"):
            raise ValueError(f"pos_encoding must be 'learned' or 'rope', "
                             f"got {pos_encoding!r}")
        if window is not None and window < 1:
            raise ValueError(f"window must be >= 1 or None, got {window}")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.d_model = d_model
        self.d_ff = d_ff
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        self.attention_fn = attention_fn
        self.return_hidden = return_hidden
        self.num_kv_heads = num_kv_heads
        self.pos_encoding = pos_encoding
        self.window = window
        self.decode_attend_impl = decode_attend_impl
        self.dropout_rate = dropout_rate
        self.remat = remat
        self.remat_policy = remat_policy
        self.causal = causal
        self.kv_layout = kv_layout
        #: rows of a dense decode cache (the slot layout's and
        #: :func:`init_cache`'s ring); None means ``max_len``
        self.decode_cache_len = decode_cache_len
        #: the tensor-parallel group of every block (None: no tensor
        #: parallelism); ``num_heads``, ``num_kv_heads`` and ``d_ff`` are
        #: then this rank's
        self.tp_group = tp_group
        self.n_experts = n_experts
        self.expert_axis = expert_axis
        self.moe_dispatch_impl = moe_dispatch_impl
        self.moe_experts_local = moe_experts_local
        self.head_dim = head_dim or d_model // num_heads
        self.kv_heads = num_kv_heads or num_heads
        self.tok_emb = nn.Embedding(vocab_size, d_model, device=device)
        if pos_encoding == "learned":
            self.pos_emb = nn.Parameter(
                torch.empty(max_len, d_model, device=device))
        else:
            self.pos_emb = None
        self.blocks = nn.ModuleList([
            self._block(device) for _ in range(num_layers)])
        self.ln_f = LayerNorm(d_model, dtype=compute_dtype, device=device)
        self.init_weights(torch.Generator().manual_seed(seed))

    def _block(self, device) -> TransformerBlock:
        """A block of this model's fields."""
        return TransformerBlock(
            self.d_model, self.num_heads, self.d_ff,
            compute_dtype=self.compute_dtype,
            attention_fn=self.attention_fn, num_kv_heads=self.num_kv_heads,
            window=self.window, decode_attend_impl=self.decode_attend_impl,
            causal=self.causal, dropout_rate=self.dropout_rate,
            kv_layout=self.kv_layout, head_dim=self.head_dim,
            tp_group=self.tp_group, n_experts=self.n_experts,
            expert_axis=self.expert_axis,
            moe_dispatch_impl=self.moe_dispatch_impl,
            moe_experts_local=self.moe_experts_local, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (CPU draws, copied to the
        model's device, so a seed gives the same weights on any card)."""
        def normal(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        normal(self.tok_emb.weight, self.d_model ** -0.5)
        if self.pos_emb is not None:
            normal(self.pos_emb, 0.02)
        for blk in self.blocks:
            moe = blk.n_experts > 0
            for lin in ((blk.qkv, blk.proj) if moe else
                        (blk.qkv, blk.proj, blk.ff_up, blk.ff_down)):
                normal(lin.weight, lin.in_features ** -0.5)
                if lin.bias is not None:
                    lin.bias.zero_()
            if moe:
                normal(blk.moe_router, 0.02)
                for w in (blk.moe_w_up, blk.moe_w_down):
                    # flax variance_scaling(1, fan_in, truncated_normal)
                    std = w.shape[-2] ** -0.5 / .87962566103423978
                    t = torch.empty(w.shape)
                    torch.nn.init.trunc_normal_(t, generator=generator)
                    w.copy_(t * std)
                blk.moe_b_up.zero_()
                blk.moe_b_down.zero_()
            for ln in (blk.ln1, blk.ln2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    _DECODE_FIELDS = ("decode_attend_impl", "kv_layout", "decode_cache_len")
    _SHARD_FIELDS = ("num_heads", "num_kv_heads", "d_ff", "head_dim",
                     "moe_experts_local")
    _MOE_FIELDS = ("expert_axis", "moe_dispatch_impl")
    #: a block's layers that a shard of other widths holds anew (the MoE
    #: router is replicated: it stays the same tensor)
    _SHARDED = ("qkv", "proj", "ff_up", "ff_down")
    _SHARDED_MOE = ("moe_w_up", "moe_b_up", "moe_w_down", "moe_b_down")

    def clone(self, **overrides) -> "TransformerLM":
        """A view of this model with fields changed (flax ``Module.clone``'s
        role), leaving the caller's model untouched.

        The decode fields (``decode_attend_impl``, ``kv_layout``,
        ``decode_cache_len``), ``tp_group`` and the MoE form
        (``expert_axis``, ``moe_dispatch_impl``) keep the SAME parameter
        tensors: the serving engine serves through such a clone. The
        local widths of a tensor-parallel shard (``num_heads``,
        ``num_kv_heads``, ``d_ff``, ``head_dim``, with ``tp_group``) and
        an expert slice (``moe_experts_local``) give every block new,
        UNINITIALISED ``qkv``/``proj`` layers and ``ff_up``/``ff_down``
        layers or expert leaves (``moe_w_up``, ``moe_b_up``,
        ``moe_w_down``, ``moe_b_down``) of the shard's shapes, for the
        caller to load a shard into (:func:`~chainermn_tpu_torch.serving.
        engine.tp_local_model` does); the replicated leaves (embeddings,
        norms, the MoE router, the tied head) stay the same tensors."""
        fields = (self._DECODE_FIELDS + self._SHARD_FIELDS + self._MOE_FIELDS
                  + ("tp_group",))
        unknown = set(overrides) - set(fields)
        if unknown:
            raise ValueError(
                f"clone() takes {', '.join(fields)}, got {sorted(unknown)}")
        impl = overrides.get("decode_attend_impl", self.decode_attend_impl)
        if impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(f"decode_attend_impl must be 'xla' or 'fused', "
                             f"got {impl!r}")
        layout = overrides.get("kv_layout", self.kv_layout)
        if layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be 'paged' or 'dense', got "
                             f"{layout!r}")
        new = copy.copy(self)
        new._modules = dict(self._modules)
        for k, v in overrides.items():
            setattr(new, k, v)
        new.kv_heads = new.num_kv_heads or new.num_heads
        if new.num_heads % new.kv_heads:
            raise ValueError(f"num_heads={new.num_heads} is not a multiple "
                             f"of num_kv_heads={new.kv_heads}")
        reshaped = any(getattr(new, k) != getattr(self, k)
                       for k in self._SHARD_FIELDS)
        if reshaped:
            device = self.tok_emb.weight.device
            blocks = []
            for old in self.blocks:
                with torch.device("meta"):
                    b = new._block(None)
                for name in self._SHARDED + self._SHARDED_MOE:
                    if name in b._modules:
                        setattr(b, name,
                                getattr(b, name).to_empty(device=device))
                    elif name in b._parameters:
                        setattr(b, name, nn.Parameter(torch.empty_like(
                            getattr(b, name), device=device)))
                b.ln1, b.ln2 = old.ln1, old.ln2
                if b.n_experts > 0:
                    b.moe_router = old.moe_router
                blocks.append(b)
            new.blocks = nn.ModuleList(blocks)
        else:
            new.blocks = nn.ModuleList([copy.copy(b) for b in self.blocks])
            for b in new.blocks:
                b.decode_attend_impl = impl
                b.kv_layout = layout
                b.tp_group = new.tp_group
                b.expert_axis = new.expert_axis
                b.moe_dispatch_impl = new.moe_dispatch_impl
        return new

    def forward(self, tokens, *, segment_ids=None, positions=None,
                decode: bool = False, decode_positions=None,
                block_tables=None, cache=None, dropout_generator=None,
                decode_slots=None):
        """``segment_ids`` (optional ``[B, T]``) confines attention to
        packed documents and needs a segment-capable ``attention_fn``
        (:func:`~chainermn_tpu_torch.ops.flash_attention.flash_attention`).
        ``positions`` (optional ``[T]`` or ``[B, T]``) overrides
        ``arange(T)``. ``decode=True`` with ``decode_positions`` (``[B]``
        int32 first-new-token positions) and ``cache``
        (:func:`~chainermn_tpu_torch.serving.kv_blocks.init_serving_cache`,
        written in place) is the serving engine's slot path: row ``b``'s
        tokens sit at ``decode_positions[b] + [0, T)``; the paged layout
        also takes ``block_tables`` (``[B, M]`` int32), the dense one
        ``decode_slots`` (``[B]`` cache rows; None = row ``b`` is slot
        ``b``). ``decode=True`` without ``decode_positions`` is one token
        a row against :func:`init_cache`'s ring (:func:`generate`).
        ``dropout_generator`` (a ``torch.Generator`` on the tokens'
        device) draws the dropout masks; it is needed when ``dropout_rate
        > 0`` in training mode."""
        if decode and not self.causal:
            raise ValueError(
                "decode=True is autoregressive and requires causal=True")
        if decode_positions is not None and not decode:
            raise ValueError("decode_positions requires decode=True")
        if segment_ids is not None and self.attention_fn is None:
            raise ValueError(
                "segment_ids needs a segment-capable attention_fn: pass "
                "attention_fn=flash_attention (the default blockwise "
                "reference does not take segment masks)")
        B, T = tokens.shape
        dt = self.compute_dtype
        dev = tokens.device
        if decode_positions is not None and positions is None:
            positions = (decode_positions.long()[:, None]
                         + torch.arange(T, device=dev)[None])
        # flax Embed casts the table to the compute dtype, then takes rows
        x = self.tok_emb.weight[tokens.long()].to(dt)
        rope_positions = None
        if self.pos_encoding == "rope":
            if positions is None:
                positions = torch.arange(T, device=dev)
            rope_positions = positions
        else:
            pos = (self.pos_emb[:T] if positions is None
                   else self.pos_emb[positions.long()])
            if pos.dim() == 2:
                pos = pos[None]
            x = x + pos.to(dt)
        drop = self.dropout_rate > 0.0 and self.training and not decode
        if drop and dropout_generator is None:
            raise ValueError(
                "dropout_rate > 0 in training mode needs dropout_generator= "
                "(a torch.Generator on the tokens' device); call "
                "model.eval() to run without dropout")
        remat = self.remat and torch.is_grad_enabled() and not decode
        for i, blk in enumerate(self.blocks):
            masks = None
            if drop:
                # flax Dropout's bernoulli(keep_prob): uniform < 1 - rate
                keep = 1.0 - self.dropout_rate
                masks = tuple(torch.rand(x.shape, generator=dropout_generator,
                                         device=dev) < keep
                              for _ in range(2))
            if remat:
                kw = ({} if self._remat_context is None
                      else {"context_fn": self._remat_context})
                x = checkpoint(blk, x, segment_ids, rope_positions,
                               dropout_masks=masks, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = blk(x, segment_ids, rope_positions, decode,
                        decode_positions, block_tables,
                        None if cache is None else cache[i],
                        dropout_masks=masks, decode_slots=decode_slots)
        x = self.ln_f(x)
        if self.return_hidden:
            return x
        # weight-tied head, in the compute dtype (flax Embed.attend)
        return F.linear(x.to(dt), self.tok_emb.weight.to(dt))


def lm_loss(logits, tokens, mask=None):
    """Next-token cross-entropy: predict ``tokens[:, 1:]`` from positions
    ``[:, :-1]``; optional ``mask`` (tokens' shape, 1 = real target) gives
    the masked mean ``sum(loss * m) / max(sum(m), 1)``. The softmax runs
    in fp32 whatever the logits' dtype."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1), reduction="none")
    losses = losses.reshape(targets.shape)
    if mask is None:
        return losses.mean()
    m = mask[:, 1:].to(losses.dtype)
    return (losses * m).sum() / m.sum().clamp_min(1.0)


def mlm_loss(logits, targets, mask):
    """Masked-LM cross-entropy: predict the ORIGINAL token at each masked
    position (no shift: the encoder sees both directions). ``targets``
    are the tokens before corruption, ``mask`` is 1 where the input was
    corrupted (the only positions scored, as the BERT recipe does). The
    softmax runs in fp32 whatever the logits' dtype."""
    V = logits.shape[-1]
    losses = F.cross_entropy(logits.float().reshape(-1, V),
                             targets.reshape(-1).long(), reduction="none")
    m = mask.reshape(-1).to(losses.dtype)
    return (losses * m).sum() / m.sum().clamp_min(1.0)


def mlm_corrupt_from_draws(tokens, select, roll, rand_tok, *, mask_id: int,
                           vocab_size: int, rate: float = 0.15):
    """The BERT 80/10/10 rule on given draws (the deterministic half of
    the JAX ``mlm_corrupt``): a position is selected where ``select <
    rate``; a selected position becomes ``mask_id`` where ``roll < 0.8``,
    ``rand_tok`` where ``0.8 <= roll < 0.9`` and stays itself otherwise.
    A ``rand_tok`` equal to ``mask_id`` is shifted by one (mod
    ``vocab_size``) so the mix holds for small vocabularies.
    ``select``/``roll`` are fp32 uniforms and ``rand_tok`` integers, all
    of ``tokens``' shape. Returns ``(corrupted, selected)``."""
    sel = select < rate
    rand_tok = rand_tok.to(tokens.dtype)
    rand_tok = torch.where(rand_tok == mask_id, (rand_tok + 1) % vocab_size,
                           rand_tok)
    corrupted = torch.where(sel & (roll < 0.8),
                            torch.full_like(tokens, mask_id), tokens)
    corrupted = torch.where(sel & (roll >= 0.8) & (roll < 0.9), rand_tok,
                            corrupted)
    return corrupted, sel


def mlm_corrupt(generator: torch.Generator, tokens, *, mask_id: int,
                vocab_size: int, rate: float = 0.15):
    """BERT-style corruption: select ``rate`` of positions; of those 80%
    become ``mask_id``, 10% a random real token and 10% stay. The three
    draws (two fp32 uniforms and the random tokens, in that order) come
    from ``generator``, which must live on ``tokens``' device; torch
    cannot reproduce the JAX package's threefry draws, so the same seed
    gives other positions than JAX — :func:`mlm_corrupt_from_draws` is
    the rule both share. Returns ``(corrupted, selected)``."""
    kw = dict(generator=generator, device=tokens.device)
    select = torch.rand(tokens.shape, **kw)
    roll = torch.rand(tokens.shape, **kw)
    rand_tok = torch.randint(0, vocab_size, tokens.shape, **kw)
    return mlm_corrupt_from_draws(tokens, select, roll, rand_tok,
                                  mask_id=mask_id, vocab_size=vocab_size,
                                  rate=rate)


def _mm_f32(a, b):
    """``a @ b`` with fp32 accumulation and an fp32 result (JAX ``dot``
    with ``preferred_element_type=float32``): on the card the bf16
    tensor-core GEMM writing fp32; on the CPU the same products in fp32
    (a product of two bf16 values is exact in fp32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _TiedHeadLogits(torch.autograd.Function):
    """fp32 logits ``h @ w.T`` from the compute-dtype hidden rows ``h``
    and ``w``, the tied table cast once by the caller. The gradient goes
    to the fp32 ``table`` itself, in fp32, so the chunks' contributions
    add up in fp32."""

    @staticmethod
    def forward(ctx, h, table, w):
        ctx.save_for_backward(h, w)
        ctx.table_dtype = table.dtype
        return _mm_f32(h, w.t())

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = dtable = None
        if ctx.needs_input_grad[0]:
            dh = _mm_f32(g, w).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dtable = _mm_f32(g.t(), h).to(ctx.table_dtype)
        return dh, dtable, None


def _chunk_loss(h, t, m, table, w):
    """Summed ``logsumexp - gold logit`` of one chunk's rows (the
    cross-entropy, computed by torch's fused log-softmax), rows weighted
    by ``m``."""
    logits = _TiedHeadLogits.apply(h, table, w)
    return (F.cross_entropy(logits, t.long(), reduction="none") * m).sum()


def lm_loss_fused(hidden, emb_table, tokens, *, n_chunks: int = 8,
                  compute_dtype=torch.bfloat16):
    """Fused chunked tied head + next-token cross-entropy (the JAX
    ``lm_loss_fused``): equal to ``lm_loss(hidden @ emb_table.T, tokens)``
    up to compute-dtype rounding, without the ``[B, T, vocab]`` logits.

    The ``B * (T - 1)`` positions are split into ``n_chunks`` chunks (the
    tail padded with zero rows and masked out, as JAX pads it); each
    chunk's head runs in ``compute_dtype`` with fp32 accumulation and fp32
    logits, is reduced to its summed loss at once, and is recomputed in
    the backward (``torch.utils.checkpoint``, the role of
    ``jax.checkpoint``), so at most one chunk's logits live at a time.
    It takes no target mask, as in JAX.

    Args:
      hidden: final post-LN hidden states ``[B, T, D]``
        (``TransformerLM(return_hidden=True)``).
      emb_table: the tied embedding table ``[vocab, D]`` (the fp32
        ``tok_emb.weight``).
      tokens: integer tokens ``[B, T]``.
    """
    B, T, D = hidden.shape
    h = hidden[:, :-1].reshape(-1, D).to(compute_dtype)
    t = tokens[:, 1:].reshape(-1)
    n = h.shape[0]
    chunk = -(-n // n_chunks)
    pad = chunk * n_chunks - n
    h = F.pad(h, (0, 0, 0, pad))
    t = F.pad(t, (0, pad))
    valid = F.pad(torch.ones(n, dtype=torch.float32, device=h.device),
                  (0, pad))
    w = emb_table.detach().to(compute_dtype)  # the head's operand, cast once
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_chunk_loss, h[sl], t[sl], valid[sl],
                                   emb_table, w, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / n


# ---------------------------------------------------------------------------
# decoding: the legacy dense ring, sampling, generate and beam_search


def init_cache(model: TransformerLM, batch_size: int) -> list:
    """The fixed-shape KV ring of :func:`generate` on the model's device:
    per block, ``cached_key``/``cached_value`` ``[batch_size, L, kvh,
    dh]`` zeros in the compute dtype (``L = decode_cache_len or
    max_len``) and the 0-d int32 write index ``cache_index``."""
    device = model.tok_emb.weight.device
    L = model.decode_cache_len or model.max_len
    shape = (batch_size, L, model.kv_heads, model.head_dim)
    return [{"cached_key": torch.zeros(shape, dtype=model.compute_dtype,
                                       device=device),
             "cached_value": torch.zeros(shape, dtype=model.compute_dtype,
                                         device=device),
             "cache_index": torch.zeros((), dtype=torch.int32,
                                        device=device)}
            for _ in range(model.num_layers)]


def _decode_setup(model: TransformerLM, prompt, n_steps: int, pad_id: int):
    """Shared scaffolding of :func:`generate` and :func:`beam_search`:
    validation, each row's prompt length (the index of its FIRST pad, or
    ``P``: right padding; tokens after a mid-row pad are ignored), and
    the prompt padded with ``pad_id`` out to ``n_steps``. Returns ``(B, P,
    prompt_len, padded)`` on the model's device."""
    if model.return_hidden:
        raise ValueError("decoding needs logits; build the model with "
                         "return_hidden=False")
    if n_steps > model.max_len:
        raise ValueError(
            f"n_steps={n_steps} exceeds the cache capacity "
            f"max_len={model.max_len}")
    prompt = torch.as_tensor(prompt, device=model.tok_emb.weight.device)
    B, P = prompt.shape
    is_pad = prompt == pad_id
    prompt_len = torch.where(is_pad.any(dim=1),
                             is_pad.int().argmax(dim=1),
                             torch.full_like(prompt[:, 0], P)).int()
    padded = F.pad(prompt, (0, max(0, n_steps - P)), value=pad_id)
    return B, P, prompt_len, padded


def _filter_logits(logits, top_k, top_p):
    """Top-k / nucleus filtering of ``[B, V]`` logits: tokens outside the
    ``top_k`` highest, and outside the smallest set whose probability
    mass reaches ``top_p``, become -inf. With both, the nucleus is taken
    among the top-k survivors (renormalised after top-k)."""
    ninf = torch.full_like(logits, float("-inf"))
    if top_p is None:
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits < kth, ninf, logits)
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    if top_k is not None:
        kth = sorted_logits[:, top_k - 1:top_k]
        logits = torch.where(logits < kth, ninf, logits)
        beyond = torch.arange(sorted_logits.shape[-1],
                              device=logits.device)[None] >= top_k
        sorted_logits = sorted_logits.masked_fill(beyond, float("-inf"))
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens while the mass BEFORE them is < top_p (the first
    # token is always kept); the threshold is the smallest kept logit
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                      cum[:, :-1] < top_p], dim=-1)
    thresh = sorted_logits.masked_fill(~keep, float("inf")).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < thresh, ninf, logits)


def _tempered_filtered(logits, temperature, top_k, top_p):
    """Sampling logits: the temperature first, then top-k/top-p (the
    nucleus is chosen from the tempered distribution)."""
    return _filter_logits(logits / temperature, top_k, top_p)


def stream_sample_keys(base_key, seeds, counters):
    """Counter-based sampling keys: row ``i`` draws with
    ``fold_in(fold_in(base_key, seeds[i]), counters[i])`` — a pure
    function of the base key, the request's seed and the absolute
    position of the token being sampled, so :func:`generate` and the
    serving engine derive the same key for the same token whatever
    program asks. Returns ``[B, 2]`` key words."""
    return prng.fold_in(prng.fold_in(base_key, seeds), counters)


def _validate_filters(vocab_size: int, temperature, top_k, top_p):
    """The sampling filters' checks, shared with the serving engine."""
    if (top_k is not None or top_p is not None) and temperature <= 0.0:
        raise ValueError("top_k/top_p filtering is for sampling — set "
                         "temperature > 0")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and not 1 <= top_k <= vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={vocab_size}], got {top_k}")


@torch.no_grad()
def generate(model: TransformerLM, prompt, n_steps: int, *,
             temperature: float = 0.0, rng=None, seeds=None, pad_id: int = 0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             adapters=None):
    """Autoregressive generation over :func:`init_cache`'s ring, one
    token a step for every row: step ``t`` feeds the prompt token while
    ``t < prompt_len`` (teacher forcing) and the previous step's pick
    afterwards, so a ragged batch needs no separate prefill. The tokens
    stay on the model's device; nothing is read back per step.

    Args:
      model: a ``TransformerLM`` with ``return_hidden=False``.
      prompt: ``[B, P]`` integer tokens, right-padded with ``pad_id``.
      n_steps: the sequence length to produce, the prompt included
        (``<= model.max_len``).
      temperature: 0 is greedy (``argmax``, the first index on a tie);
        above 0 a counter-keyed categorical draw (needs ``rng``).
      rng: the sampling base key, ``[2]`` uint32 key words
        (:func:`chainermn_tpu_torch.utils.prng.PRNGKey`, or the data of a
        JAX key). Step ``t`` samples the token at position ``t + 1`` of
        row ``i`` with :func:`stream_sample_keys` ``(rng, seeds[i], t +
        1)``, so a fixed ``(rng, seeds)`` gives the serving engine's
        streams.
      seeds: ``[B]`` per-row stream seeds (default zeros); the serving
        scheduler derives one per request.
      top_k / top_p: filtering after the temperature; both need
        ``temperature > 0``.
      adapters: LoRA adapters are not ported (raises).

    Returns ``[B, n_steps]`` tokens of the prompt's dtype on the model's
    device (prompt positions pass through).
    """
    if adapters is not None:
        raise NotImplementedError(
            "adapters= is not ported yet (ROADMAP queue 1, item 7: "
            "multi-tenant adapters)")
    B, _, prompt_len, padded = _decode_setup(model, prompt, n_steps, pad_id)
    if temperature > 0.0 and rng is None:
        raise ValueError("sampling (temperature > 0) requires rng")
    _validate_filters(model.vocab_size, temperature, top_k, top_p)
    dev = padded.device
    cache = init_cache(model, B)
    sample = temperature > 0.0
    if sample:
        base = prng._as_key(rng, device=dev)
        seeds = (torch.zeros(B, dtype=torch.int64, device=dev)
                 if seeds is None else torch.as_tensor(seeds, device=dev))
    toks = []
    prev = padded[:, 0]
    for t in range(n_steps):
        tok = torch.where(t < prompt_len, padded[:, t], prev)
        logits = model(tok[:, None],
                       positions=torch.full((1,), t, device=dev),
                       decode=True, cache=cache)[:, 0]
        if sample:
            keys = stream_sample_keys(base, seeds,
                                      torch.full((B,), t + 1, device=dev))
            nxt = prng.categorical(keys, _tempered_filtered(
                logits, temperature, top_k, top_p))
        else:
            nxt = torch.argmax(logits, dim=-1)
        toks.append(tok)
        prev = nxt.to(padded.dtype)
    return torch.stack(toks, dim=1)


def _top_k_first(x, k: int):
    """``torch.topk`` over the last axis with ``lax.top_k``'s tie rule:
    equal values come lower index first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.no_grad()
def beam_search(model: TransformerLM, prompt, n_steps: int,
                beam_size: int, *, eos_id: Optional[int] = None,
                pad_id: int = 0, length_penalty: float = 0.0):
    """Beam search over :func:`init_cache`'s ring, batched ``B *
    beam_size`` rows and reordered by backpointers at every step.

    Two per-row phases, offset by one: the token CONSUMED at ``t`` is
    the prompt's while ``t < prompt_len``, but the expansion chosen at
    ``t`` is consumed at ``t + 1``, so a row expands from its last prompt
    step (``t == prompt_len - 1``, where the top-``K`` first tokens spread
    from the single live beam) and never on the final step. Before that
    its beams stay the identity with scores pinned at ``[0, -inf, ...]``.
    Which steps expand is known from the prompt lengths, read once, so a
    step with no expanding row skips the cache reorder without a per-step
    sync. Finished beams (``eos_id``) extend only with ``pad_id`` at no
    cost. The top-``K`` and every ordering break ties toward the lower
    index, as ``lax.top_k`` and ``jnp.argsort`` do.

    Args:
      model: ``TransformerLM`` with ``return_hidden=False``.
      prompt: ``[B, P]`` tokens right-padded with ``pad_id``.
      n_steps: total length, the prompt included (``<= model.max_len``).
      beam_size: hypotheses kept per row.
      eos_id: optional end token.
      length_penalty: GNMT alpha; hypotheses are RANKED by ``score / ((5
        + len) / 6) ** alpha`` (len = generated tokens up to and including
        EOS); 0 ranks by the raw score. The returned scores stay raw.

    Returns ``(tokens [B, beam_size, n_steps], scores [B, beam_size])``,
    best first, on the model's device.
    """
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    B, _, prompt_len, padded = _decode_setup(model, prompt, n_steps, pad_id)
    K, V = beam_size, model.vocab_size
    dev = padded.device
    cache = init_cache(model, B * K)
    scores = torch.full((B, K), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    seqs = torch.full((B, K, n_steps), pad_id, dtype=padded.dtype,
                      device=dev)
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    gen_len = torch.zeros(B, K, dtype=torch.int32, device=dev)
    steps = torch.arange(n_steps, device=dev)[:, None]
    # [n_steps, B]: the steps whose expansion each row commits
    expanding_at = (steps >= prompt_len[None] - 1) & (steps < n_steps - 1)
    first = min(int(n) for n in prompt_len.tolist())  # the one host read
    ident = torch.arange(K, device=dev).expand(B, K)
    bidx = torch.arange(B, device=dev)[:, None]
    frozen = None
    if eos_id is not None:
        frozen = torch.full((V,), float("-inf"), device=dev)
        frozen[pad_id] = 0.0
    prev = padded[:, :1].expand(B, K)
    for t in range(n_steps):
        expanding = expanding_at[t][:, None]  # [B, 1]
        tok = torch.where((t < prompt_len)[:, None], padded[:, t:t + 1],
                          prev)
        logits = model(tok.reshape(B * K, 1),
                       positions=torch.full((1,), t, device=dev),
                       decode=True, cache=cache)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
        logp = logp.reshape(B, K, V)
        if frozen is not None:
            logp = torch.where(finished[..., None], frozen, logp)
        total = scores[..., None] + logp
        top_scores, flat = _top_k_first(total.reshape(B, K * V), K)
        parents = torch.where(expanding, flat // V, ident)
        next_tok = (flat % V).to(padded.dtype)
        scores = torch.where(expanding, top_scores, scores)
        if first - 1 <= t < n_steps - 1:  # some row expands: reorder
            for c in cache:
                for name in ("cached_key", "cached_value"):
                    leaf = c[name]
                    c[name] = leaf.reshape(B, K, *leaf.shape[1:])[
                        bidx, parents].reshape(leaf.shape)
        seqs = torch.gather(seqs, 1, parents[..., None].expand_as(seqs))
        seqs[:, :, t] = torch.gather(tok, 1, parents)
        gen_len = torch.gather(gen_len, 1, parents)
        if eos_id is not None:
            finished = torch.gather(finished, 1, parents)
        gen_len = gen_len + (expanding & ~finished).int()
        if eos_id is not None:
            finished = finished | (expanding & (next_tok == eos_id))
        prev = next_tok
    if length_penalty != 0.0:
        return rank_beams(seqs, scores, gen_len, length_penalty)
    order = torch.argsort(-scores, dim=1, stable=True)
    return (torch.gather(seqs, 1, order[..., None].expand_as(seqs)),
            torch.gather(scores, 1, order))
