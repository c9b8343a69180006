"""Transformer-base causal LM (counterpart of
``chainermn_tpu/models/transformer.py``): 6 layers, d_model 512, 8 heads,
d_ff 2048 by default; pre-LN; bf16 compute over fp32 parameters.

What is ported: the dense-FFN block with GQA (``num_kv_heads``), learned
or rotary positions, the training forward through a pluggable
``attention_fn`` (default :func:`~chainermn_tpu_torch.ops.attention.
blockwise_attention`; pass :func:`~chainermn_tpu_torch.ops.
flash_attention.flash_attention` for packed ``segment_ids`` or a
``window``), ``return_hidden``, :func:`lm_loss`, and the serving
engine's paged slot-decode path with both attend impls —
``'fused'`` (the paged flash-decoding CUDA kernel,
:mod:`chainermn_tpu_torch.ops.paged_decode`) and ``'xla'`` (gather the
dense view, then masked softmax in torch ops). The numerics follow the
flax module: LayerNorm with epsilon 1e-6 and fp32 statistics, the tanh
GELU, parameters cast to the compute dtype for each product, and the
tied head computed in the compute dtype.

Left for later: the dense ``_decode_attend`` ring and ``generate`` /
``beam_search``, MoE, tensor parallelism, LoRA adapters, ``sow_kv``;
for training: dropout, remat, ``lm_loss_fused`` and the bidirectional
MLM encoder (``causal=False``, ``mlm_loss``, ``mlm_corrupt``) — each
raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.ops.attention import blockwise_attention
from chainermn_tpu_torch.ops.paged_decode import paged_flash_decode
from chainermn_tpu_torch.ops.paged_kv import paged_lookup, paged_update

DECODE_ATTEND_IMPLS = ("xla", "fused")


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


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + proj(attn(LN(x)))`` then ``x + FFN(LN(x))``."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, *,
                 compute_dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 num_kv_heads: Optional[int] = None,
                 window: Optional[int] = None,
                 decode_attend_impl: str = "xla", device=None) -> None:
        super().__init__()
        if decode_attend_impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(
                f"decode_attend_impl must be 'xla' or 'fused', got "
                f"{decode_attend_impl!r}")
        self.num_heads = num_heads
        self.d_ff = d_ff
        self.compute_dtype = compute_dtype
        #: the training forward's attention, called as ``attention_fn(q,
        #: k, v, causal=True, scale=..., [segment_ids=...])`` on BTHD
        #: heads; None means the blockwise reference, which takes neither
        #: a window nor segment ids
        self.attention_fn = attention_fn
        self.num_kv_heads = num_kv_heads
        self.window = window
        self.decode_attend_impl = decode_attend_impl
        self.head_dim = d_model // num_heads
        kv_heads = num_kv_heads or num_heads
        dt = dict(dtype=compute_dtype, device=device)
        self.ln1 = LayerNorm(d_model, **dt)
        self.qkv = nn.Linear(d_model, (num_heads + 2 * kv_heads)
                             * self.head_dim, bias=False, device=device)
        self.proj = nn.Linear(num_heads * self.head_dim, d_model, bias=False,
                              device=device)
        self.ln2 = LayerNorm(d_model, **dt)
        self.ff_up = nn.Linear(d_model, d_ff, device=device)
        self.ff_down = nn.Linear(d_ff, d_model, device=device)

    def _slot_decode_attend(self, qh, kh_new, vh_new, positions,
                            block_tables, cache):
        """Slot-array cached attention over the paged pool (the serving
        engine's path). Every batch row carries its OWN position: its
        ``T >= 1`` new tokens are written at ``positions[b] + t`` and
        query ``t`` attends to ``pos <= positions[b] + t``. ``T == 1`` is
        the decode step, ``T == bucket`` the prefill (pad writes land
        beyond the row's true length, or in scratch, and are re-written
        before any mask admits them).

        The K/V write is the same for both impls; only the read differs:
        ``'fused'`` is one pass of the CUDA kernel over the live blocks,
        ``'xla'`` gathers the dense view and attends with torch ops.
        """
        if cache is None or block_tables is None:
            raise ValueError("the paged slot-decode path needs cache= and "
                             "block_tables=")
        B, T = qh.shape[:2]
        kv_heads = kh_new.shape[2]
        dt = self.compute_dtype
        pk, pv = cache["pool_key"], cache["pool_value"]
        paged_update(pk, block_tables, positions, kh_new.to(dt))
        paged_update(pv, block_tables, positions, vh_new.to(dt))
        scale = self.head_dim ** -0.5
        if self.decode_attend_impl == "fused":
            # Scratch block 0 is masked in-kernel: a released slot's
            # garbage and beyond-horizon writes never reach a live row.
            return paged_flash_decode(
                qh.to(dt).contiguous(), pk, pv, block_tables, positions,
                window=self.window, scale=scale, scratch_block=0)
        keys = paged_lookup(pk, block_tables)
        vals = paged_lookup(pv, block_tables)
        L = keys.shape[1]
        pos_l = torch.arange(L, device=qh.device)
        qpos = (positions.long()[:, None]
                + torch.arange(T, device=qh.device)[None])
        mask = pos_l[None, None, :] <= qpos[:, :, None]  # [B, T, L]
        if self.window is not None:
            mask &= pos_l[None, None, :] > qpos[:, :, None] - self.window
        group = self.num_heads // kv_heads
        q = qh.reshape(B, T, kv_heads, group, self.head_dim)
        scores = torch.einsum("btngd,blnd->btngl", q.float(),
                              keys.float()) * scale
        scores = scores.masked_fill(~mask[:, :, None, None, :],
                                    float("-inf"))
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("btngl,blnd->btngd", w, vals.float())
        return o.reshape(B, T, self.num_heads, self.head_dim).to(dt)

    def forward(self, x, segment_ids=None, rope_positions=None,
                decode: bool = False, decode_positions=None,
                block_tables=None, cache=None):
        dt = self.compute_dtype
        kv_heads = self.num_kv_heads or self.num_heads
        hd = self.head_dim
        B, T = x.shape[:2]
        qkv = _dense(self.qkv, self.ln1(x), dt)
        q, k, v = torch.split(
            qkv, [self.num_heads * hd, kv_heads * hd, kv_heads * hd], dim=-1)
        qh = q.reshape(B, T, self.num_heads, hd)
        kh = k.reshape(B, T, kv_heads, hd)
        vh = v.reshape(B, T, kv_heads, hd)
        if rope_positions is not None:
            qh = apply_rope(qh, rope_positions)
            kh = apply_rope(kh, rope_positions)
        if decode:
            o = self._slot_decode_attend(qh, kh, vh, decode_positions,
                                         block_tables, cache)
        else:
            if self.window is not None and self.attention_fn is None:
                raise ValueError(
                    "window needs a window-honouring attention_fn (e.g. "
                    "flash_attention(..., window=W)); the default blockwise "
                    "reference has no window support")
            attn = self.attention_fn or blockwise_attention
            kw = {} if segment_ids is None else {"segment_ids": segment_ids}
            o = attn(qh, kh, vh, causal=True, scale=hd ** -0.5, **kw)
        x = x + _dense(self.proj, o.reshape(B, T, self.num_heads * hd), dt)
        h = F.gelu(_dense(self.ff_up, self.ln2(x), dt), approximate="tanh")
        return x + _dense(self.ff_down, h, dt)


class TransformerLM(nn.Module):
    """Causal LM over integer tokens ``[B, T]`` -> logits
    ``[B, T, vocab]`` in the compute dtype.

    ``attention_fn`` is the training forward's attention (see
    :class:`TransformerBlock`); ``return_hidden=True`` skips the tied head
    and returns the final post-LN hidden states.

    Weights are drawn from a ``torch.Generator`` seeded with ``seed``
    (the flax initialisers' scales: embedding ``1/sqrt(d_model)``, dense
    kernels ``1/sqrt(fan_in)``, learned positions 0.02), or loaded from a
    flax tree with :func:`chainermn_tpu_torch.convert.lm_state_from_flax`.
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
                 causal: bool = True, device=None) -> None:
        super().__init__()
        if dropout_rate:
            raise NotImplementedError(
                "dropout_rate is not ported yet (ROADMAP queue 1, item 2: "
                "training items left out of the second slice)")
        if remat:
            raise NotImplementedError(
                "remat is not ported yet (ROADMAP queue 1, item 2: training "
                "items left out of the second slice)")
        if not causal:
            raise NotImplementedError(
                "the bidirectional MLM encoder (causal=False) is not ported "
                "yet (ROADMAP queue 1, item 2: training items left out of "
                "the second slice)")
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
        self.head_dim = d_model // num_heads
        self.kv_heads = num_kv_heads or num_heads
        self.tok_emb = nn.Embedding(vocab_size, d_model, device=device)
        if pos_encoding == "learned":
            self.pos_emb = nn.Parameter(
                torch.empty(max_len, d_model, device=device))
        else:
            self.pos_emb = None
        self.blocks = nn.ModuleList([
            TransformerBlock(d_model, num_heads, d_ff,
                             compute_dtype=compute_dtype,
                             attention_fn=attention_fn,
                             num_kv_heads=num_kv_heads, window=window,
                             decode_attend_impl=decode_attend_impl,
                             device=device)
            for _ in range(num_layers)
        ])
        self.ln_f = LayerNorm(d_model, dtype=compute_dtype, device=device)
        self.init_weights(torch.Generator().manual_seed(seed))

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
            for lin in (blk.qkv, blk.proj, blk.ff_up, blk.ff_down):
                normal(lin.weight, lin.in_features ** -0.5)
                if lin.bias is not None:
                    lin.bias.zero_()
            for ln in (blk.ln1, blk.ln2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    def clone(self, **overrides) -> "TransformerLM":
        """A view of this model with decode fields changed and the SAME
        parameter tensors (flax ``Module.clone``'s role: the serving
        engine serves through a clone carrying its resolved
        ``decode_attend_impl``, leaving the caller's model untouched)."""
        unknown = set(overrides) - {"decode_attend_impl"}
        if unknown:
            raise ValueError(f"clone() takes decode_attend_impl only, got "
                             f"{sorted(unknown)}")
        impl = overrides.get("decode_attend_impl", self.decode_attend_impl)
        if impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(f"decode_attend_impl must be 'xla' or 'fused', "
                             f"got {impl!r}")
        new = copy.copy(self)
        new._modules = dict(self._modules)
        new.blocks = nn.ModuleList([copy.copy(b) for b in self.blocks])
        new.decode_attend_impl = impl
        for b in new.blocks:
            b.decode_attend_impl = impl
        return new

    def forward(self, tokens, *, segment_ids=None, positions=None,
                decode: bool = False, decode_positions=None,
                block_tables=None, cache=None):
        """``segment_ids`` (optional ``[B, T]``) confines attention to
        packed documents and needs a segment-capable ``attention_fn``
        (:func:`~chainermn_tpu_torch.ops.flash_attention.flash_attention`).
        ``positions`` (optional ``[T]`` or ``[B, T]``) overrides
        ``arange(T)``. ``decode=True`` with ``decode_positions`` (``[B]``
        int32 first-new-token positions), ``block_tables`` (``[B, M]``
        int32) and ``cache`` (:func:`~chainermn_tpu_torch.serving.
        kv_blocks.init_serving_cache`, written in place) is the serving
        engine's slot path: row ``b``'s tokens sit at
        ``decode_positions[b] + [0, T)``."""
        if decode and decode_positions is None:
            raise NotImplementedError(
                "decode=True without decode_positions is the dense "
                "KV-cache ring of generate(), not ported yet (ROADMAP "
                "queue 1, serving items left out of the first slice: the "
                "dense slot layout, generate and beam_search)")
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
        for i, blk in enumerate(self.blocks):
            x = blk(x, segment_ids, rope_positions, decode,
                    decode_positions, block_tables,
                    None if cache is None else cache[i])
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
