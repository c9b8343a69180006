"""Attention primitives on one device (counterpart of
``chainermn_tpu/ops/attention.py``).

Layout throughout: ``[batch, seq, heads, head_dim]`` (BTHD). Softmax
statistics are accumulated in float32 whatever the input dtype, and
products take float32 inputs (a bf16 value widens to fp32 exactly), which
is what the JAX package's ``preferred_element_type=float32`` einsums
compute.

``q_offset`` / ``kv_offset`` are global sequence positions, so the same
local function serves single-device attention and the sequence-parallel
layers where each shard holds a slice of the sequence.

Left for later: ``impl='auto'`` and ``resolve_attention_impl`` — they
need the tuning registry resolved from H100 measurements (ROADMAP queue
8, tuning); until then ``attention(impl='auto')`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Score of a masked key. A large finite negative rather than ``-inf``:
#: ``exp(NEG_INF - m)`` underflows to an exact 0 and ``NEG_INF - NEG_INF``
#: stays 0, so fully masked rows never produce NaN.
NEG_INF = -1e30


def _scale(q, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


def _acc_dtype(x) -> torch.dtype:
    """fp32 accumulation, fp64 for fp64 inputs (the gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _repeat_kv(q, k, v):
    """GQA/MQA: repeat each kv head across its q-head group (kv head
    ``h // group`` serves q head ``h``)."""
    if k.shape[2] == q.shape[2]:
        return k, v
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads ({q.shape[2]}) not a multiple of kv heads "
                         f"({k.shape[2]})")
    rep = q.shape[2] // k.shape[2]
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


def dot_product_attention(q, k, v, *, causal: bool = False, q_offset=0,
                          kv_offset=0, scale: Optional[float] = None,
                          segment_ids=None, bias=None):
    """Plain softmax attention — the correctness reference.

    ``q``: ``[B, Tq, H, D]``; ``k``/``v``: ``[B, Tk, Hkv, D]`` with ``Hkv``
    dividing ``H``. ``causal`` masks ``kv_pos > q_pos`` (global positions,
    honouring the offsets). ``segment_ids`` (``[B, T]``, Tq == Tk)
    confines attention to equal ids; rows with no visible key return
    zeros. ``bias`` (``[B|1, H|1, Tq, Tk]``) is added after the scale and
    before the mask.
    """
    s = _scale(q, scale)
    k, v = _repeat_kv(q, k, v)
    acc = _acc_dtype(q)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * s
    if bias is not None:
        scores = scores + bias.to(acc)
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        # Fully masked rows: the softmax over all-NEG_INF is uniform garbage.
        probs = torch.where(mask.any(-1, keepdim=True), probs,
                            torch.zeros_like(probs))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(acc))
    return out.to(q.dtype)


def online_softmax_block(q, k_blk, v_blk, o, m, l, *, causal: bool = False,
                         q_offset=0, kv_offset=0,
                         scale: Optional[float] = None):
    """One online-softmax accumulation step over a K/V block (the flash
    inner update, and the ring-attention update over arriving blocks).

    ``q``: ``[B, Tq, H, D]``; ``k_blk``/``v_blk``: ``[B, Tk, H, D]``;
    ``o``: ``[B, Tq, H, D]`` fp32 running (unnormalised) output; ``m``,
    ``l``: ``[B, H, Tq]`` fp32 running max and normaliser. Returns the
    updated ``(o, m, l)``.
    """
    s = _scale(q, scale)
    acc = o.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k_blk.to(acc)) * s
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k_blk.shape[1], device=q.device)
        mask = (q_pos[:, None] >= kv_pos[None, :])[None, None]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # Guard fully masked rows: exp(NEG_INF - NEG_INF) would be 1.
    p = torch.exp(scores - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    # corr is [B, H, Tq]; o is [B, Tq, H, D]: align layouts for the rescale.
    o_new = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v_blk.to(acc)))
    return o_new, m_new, l_new


def finalize_online_softmax(o, l, dtype):
    """Normalise the accumulated output, ``o / l`` with the layout
    fix-up; fully masked rows (``l == 0``) return zeros, not NaN."""
    denom = l.transpose(1, 2)[..., None]
    out = torch.where(denom > 0, o / denom.clamp_min(1e-37),
                      torch.zeros_like(o))
    return out.to(dtype)


def attention(q, k, v, *, causal: bool = False,
              window: Optional[int] = None, scale: Optional[float] = None,
              segment_ids=None, bias=None, impl: str = "auto"):
    """The variant-dispatching entry point.

    ``impl``: ``'xla'`` (the materialised :func:`dot_product_attention`;
    the sliding window is reproduced as an additive band bias, exactly
    the kernel's band) or ``'flash'`` / ``'windowed'`` (the flash kernels,
    :func:`chainermn_tpu_torch.ops.flash_attention.flash_attention`). All
    compute the same attention. ``'auto'`` raises: the choice needs the
    tuning registry resolved from H100 measurements (ROADMAP queue 8).
    """
    if window is not None and not causal:
        # Validated here so the xla path can never silently compute a
        # different (future-visible) band.
        raise ValueError("window requires causal=True")
    if impl == "auto":
        raise NotImplementedError(
            "attention(impl='auto') resolves through the tuning registry, "
            "which is not ported yet (ROADMAP queue 8, tuning: resolved "
            "from H100 measurements only); pass impl='xla' or 'flash'")
    if impl == "xla":
        b = bias
        if window is not None:
            q_pos = torch.arange(q.shape[1], device=q.device)
            kv_pos = torch.arange(k.shape[1], device=q.device)
            band = torch.where((q_pos[:, None] - kv_pos[None, :]) < window,
                               0.0, NEG_INF)[None, None].to(_acc_dtype(q))
            b = band if b is None else b.to(band.dtype) + band
        return dot_product_attention(q, k, v, causal=causal, scale=scale,
                                     segment_ids=segment_ids, bias=b)
    if impl in ("flash", "windowed"):
        from chainermn_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids, bias=bias,
                               window=window)
    raise ValueError(f"unknown attention impl {impl!r} (expected auto|xla|"
                     "flash|windowed)")


def blockwise_attention(q, k, v, *, block_k: int = 512, causal: bool = False,
                        scale: Optional[float] = None):
    """Flash-style blockwise attention: a loop over K/V blocks with
    :func:`online_softmax_block`, ``O(Tq * block_k)`` live scores instead
    of ``[Tq, Tk]``. A ``Tk`` not divisible by ``block_k`` runs as one
    block (no padding), as in the JAX package."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    k, v = _repeat_kv(q, k, v)
    if Tk % block_k != 0:
        block_k = Tk
    acc = _acc_dtype(q)
    o = torch.zeros(B, Tq, H, D, dtype=acc, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=acc, device=q.device)
    l = torch.zeros(B, H, Tq, dtype=acc, device=q.device)
    for start in range(0, Tk, block_k):
        o, m, l = online_softmax_block(
            q, k[:, start:start + block_k], v[:, start:start + block_k],
            o, m, l, causal=causal, q_offset=0, kv_offset=start, scale=scale)
    return finalize_online_softmax(o, l, q.dtype)
