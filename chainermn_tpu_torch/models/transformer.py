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
:func:`lm_loss` and the chunked :func:`lm_loss_fused`, and the serving
engine's paged slot-decode path with both attend impls —
``'fused'`` (the paged flash-decoding CUDA kernel,
:mod:`chainermn_tpu_torch.ops.paged_decode`) and ``'xla'`` (gather the
dense view, then masked softmax in torch ops). The numerics follow the
flax module: LayerNorm with epsilon 1e-6 and fp32 statistics, the tanh
GELU, parameters cast to the compute dtype for each product, and the
tied head computed in the compute dtype.

Left for later: the dense ``_decode_attend`` ring and ``generate`` /
``beam_search``, MoE, tensor parallelism, LoRA adapters, ``sow_kv`` —
each raises ``NotImplementedError`` naming its ROADMAP item.
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
                 decode_attend_impl: str = "xla", causal: bool = True,
                 dropout_rate: float = 0.0, device=None) -> None:
        super().__init__()
        if decode_attend_impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(
                f"decode_attend_impl must be 'xla' or 'fused', got "
                f"{decode_attend_impl!r}")
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

    def _dropout(self, h, mask):
        """flax ``nn.Dropout``: kept entries scaled by 1/(1 - rate), the
        rest 0; ``mask`` (bool, True = keep) is None outside training."""
        if mask is None:
            return h
        return torch.where(mask, h / (1.0 - self.dropout_rate),
                           torch.zeros_like(h))

    def forward(self, x, segment_ids=None, rope_positions=None,
                decode: bool = False, decode_positions=None,
                block_tables=None, cache=None, dropout_masks=None):
        """``dropout_masks``: ``(attention branch, FFN branch)`` bool keep
        masks of ``x``'s shape, or None (no dropout). They are drawn by
        :class:`TransformerLM` outside any rematerialised region, so a
        recomputed block applies the same masks."""
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
            if not self.causal:
                raise ValueError("decode=True requires a causal block")
            o = self._slot_decode_attend(qh, kh, vh, decode_positions,
                                         block_tables, cache)
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
        x = x + self._dropout(o, m_attn)
        h = F.gelu(_dense(self.ff_up, self.ln2(x), dt), approximate="tanh")
        return x + self._dropout(_dense(self.ff_down, h, dt), m_ffn)


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
                 remat_policy: str = "dots", causal: bool = True,
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
                             causal=causal, dropout_rate=dropout_rate,
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
                block_tables=None, cache=None, dropout_generator=None):
        """``segment_ids`` (optional ``[B, T]``) confines attention to
        packed documents and needs a segment-capable ``attention_fn``
        (:func:`~chainermn_tpu_torch.ops.flash_attention.flash_attention`).
        ``positions`` (optional ``[T]`` or ``[B, T]``) overrides
        ``arange(T)``. ``decode=True`` with ``decode_positions`` (``[B]``
        int32 first-new-token positions), ``block_tables`` (``[B, M]``
        int32) and ``cache`` (:func:`~chainermn_tpu_torch.serving.
        kv_blocks.init_serving_cache`, written in place) is the serving
        engine's slot path: row ``b``'s tokens sit at
        ``decode_positions[b] + [0, T)``. ``dropout_generator`` (a
        ``torch.Generator`` on the tokens' device) draws the dropout
        masks; it is needed when ``dropout_rate > 0`` in training mode."""
        if decode and not self.causal:
            raise ValueError(
                "decode=True is autoregressive and requires causal=True")
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
                        dropout_masks=masks)
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
