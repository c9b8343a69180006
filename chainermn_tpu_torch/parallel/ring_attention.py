"""Ring attention: sequence (context) parallelism over a process group
(counterpart of ``chainermn_tpu/parallel/ring_attention.py``).

The sequence is sharded over the ranks of a group (the JAX ``'seq'`` mesh
axis). Each rank keeps its Q block resident and the K/V blocks rotate
around the ring, one neighbour transfer a hop
(:func:`~chainermn_tpu_torch.parallel.collectives.ppermute`'s transfer,
``batch_isend_irecv``). Each arriving block goes through the flash
kernels' block entries (:func:`~chainermn_tpu_torch.ops.flash_attention.
flash_block_fwd`, K1), which return the block's output and its LSE rows;
the partials merge in log space (:func:`merge_partials`), so no rank ever
holds the full sequence's K/V or a ``[T, T]`` score matrix.

Each flash ring is one ``torch.autograd.Function``. Its backward is a
second ring pass from the rank's own (home) K/V: the blocks rotate again,
each hop runs the block backward (K2, K3) against the *global* LSE and
delta of the forward, and the dk/dv accumulators travel with their block
and arrive home after ``n`` hops. Every rank makes the same transfers in
the same order, forward and backward, whatever its branch at a hop: a
skipped hop launches no kernel but still passes the accumulator on.

In the causal contiguous ring a hop takes one of three branches by the
block's home rank ``src`` against this rank ``my``: ``src < my`` (the
block is entirely in the past: unmasked), ``src == my`` (the diagonal:
the causal mask of equal offsets) or ``src > my`` (the future: skipped,
no launch). So rank ``r`` runs K1 ``r + 1`` times a layer. The zigzag
layout (:func:`to_zigzag`) gives every rank the chunk pair ``(s, 2n - 1 -
s)`` of ``2n`` and so the same work at every hop.

The rings rotate ``n - 1`` times a forward pass: the home K/V are the
function's own saved inputs, so the JAX scan rings' homing hop is not
needed here. The backward makes ``n - 1`` K/V hops and ``n`` accumulator
hops. ``impl='einsum'`` is the plain version: the online-softmax block
update in torch ops, differentiated by autograd through
:func:`~chainermn_tpu_torch.parallel.collectives.ppermute`.

The ``*_local`` functions take this rank's shards (the JAX functions run
inside ``shard_map``): the gradient they give is that of the SUM of the
ranks' losses, as every collective of the port gives. ``group`` is a
process group or a communicator (``None``: the default group).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chainermn_tpu_torch.ops.attention import (
    NEG_INF,
    _acc_dtype,
    finalize_online_softmax,
    online_softmax_block,
)
from chainermn_tpu_torch.ops.flash_attention import (
    flash_block_bwd,
    flash_block_fwd,
)
from chainermn_tpu_torch.parallel import collectives as C


def merge_partials(o, lse, o_blk, lse_blk):
    """Merge two normalised attention partials in log space.

    ``o``/``o_blk``: ``[B, T, H, D]`` outputs, each normalised within its
    own key set (``o`` fp32); ``lse``/``lse_blk``: ``[B, H, T]`` fp32
    logsumexps of those key sets. The merged pair is the attention over
    the union of the key sets; where both are ``NEG_INF`` (no key seen
    yet, a fully masked row) the output stays 0."""
    lse_new = torch.logaddexp(lse, lse_blk)
    safe = lse_new > NEG_INF / 2
    zero = torch.zeros((), dtype=lse.dtype, device=lse.device)
    a = torch.where(safe, torch.exp(lse - lse_new), zero)
    b = torch.where(safe, torch.exp(lse_blk - lse_new), zero)
    o_new = (o * a.transpose(1, 2)[..., None]
             + o_blk.to(o.dtype) * b.transpose(1, 2)[..., None])
    return o_new, lse_new


def _ring_perm(n):
    return [(i, (i + 1) % n) for i in range(n)]


# ---------------------------------------------------------------------------
# zigzag layout
# ---------------------------------------------------------------------------

def zigzag_indices(n: int, total: int) -> np.ndarray:
    """Global -> zigzag gather indices: the sequence splits into ``2n``
    chunks and shard ``s`` holds the pair ``(s, 2n - 1 - s)``, so under a
    causal mask every shard owns half a past-heavy and half a future-heavy
    chunk (the same work at every hop)."""
    if total % (2 * n):
        raise ValueError(f"sequence length {total} not divisible by "
                         f"2n={2 * n}")
    c = total // (2 * n)
    idx = []
    for s in range(n):
        idx.extend(range(s * c, (s + 1) * c))
        idx.extend(range((2 * n - 1 - s) * c, (2 * n - s) * c))
    return np.asarray(idx, dtype=np.int64)


def to_zigzag(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Reorder a GLOBAL tensor's sequence axis so that contiguous equal
    slices are the zigzag shards (one gather, before sharding)."""
    idx = torch.from_numpy(zigzag_indices(n, x.shape[axis])).to(x.device)
    return torch.index_select(x, axis, idx)


def from_zigzag(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`to_zigzag`."""
    idx = zigzag_indices(n, x.shape[axis])
    inv = np.empty_like(idx)
    inv[idx] = np.arange(idx.size)
    return torch.index_select(x, axis, torch.from_numpy(inv).to(x.device))


# ---------------------------------------------------------------------------
# the contiguous flash ring
# ---------------------------------------------------------------------------

def _branch(src: int, my: int, causal: bool) -> str:
    if not causal or src < my:
        return "full"
    return "diag" if src == my else "skip"


def _rotate(kv, sk, group, perm):
    """One hop: the stacked K/V (and the segment ids riding with them) to
    the next rank, in one transfer."""
    moved = C._permute_all([kv] + ([sk] if sk is not None else []), group,
                           perm)
    return moved[0], (moved[1] if sk is not None else None)


def _delta(do, out, q):
    """``rowsum(dO * O)`` as ``[B, H, Tq]`` in the accumulation dtype."""
    acc = _acc_dtype(q)
    return (do.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)


class _RingFlash(torch.autograd.Function):
    """The contiguous ring: K1 a live hop forward; K2 + K3 a live hop
    backward from the home K/V with the global LSE; segment ids (when
    given) travel with their K/V block."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, causal, scale):
        n, my = C.axis_size_of(group), C.axis_index(group)
        B, Tq, H, D = q.shape
        kw = dict(scale=scale, seg_q=seg)
        o = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32,
                         device=q.device)
        perm = _ring_perm(n)
        kv, sk = torch.stack([k, v]), seg
        for s in range(n):
            br = _branch((my - s) % n, my, causal)
            if br != "skip":
                o_b, lse_b = flash_block_fwd(q, kv[0], kv[1],
                                             causal=br == "diag", seg_kv=sk,
                                             **kw)
                o, lse = merge_partials(o, lse, o_b, lse_b)
            if s + 1 < n:
                kv, sk = _rotate(kv, sk, group, perm)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.opts = (group, causal, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.opts
        n, my = C.axis_size_of(group), C.axis_index(group)
        do = g.to(q.dtype).contiguous()
        delta = _delta(do, out, q)
        kw = dict(scale=scale, seg_q=seg)
        perm = _ring_perm(n)
        kv, sk = torch.stack([k, v]), seg
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            br = _branch((my - s) % n, my, causal)
            if br != "skip":
                dq_c, dk_c, dv_c = flash_block_bwd(
                    q, kv[0], kv[1], do, lse, delta, causal=br == "diag",
                    seg_kv=sk, **kw)
                dq += dq_c
                dkv[0] += dk_c
                dkv[1] += dv_c
            # the accumulator travels with its block: after the n-th hop
            # each block's dk/dv is home with every rank's contribution
            dkv = C._permute(dkv, group, perm)
            if s + 1 < n:
                kv, sk = _rotate(kv, sk, group, perm)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


# ---------------------------------------------------------------------------
# the zigzag flash ring: shard s holds chunks (s, 2n-1-s) of 2n
# ---------------------------------------------------------------------------

def _halves(t, C_):
    return (None, None) if t is None else (t[:, :C_], t[:, C_:])


class _ZigzagRingFlash(torch.autograd.Function):
    """The balanced causal ring. Per (q shard i, kv block j) in chunk²
    units: j < i ("past": the whole local q against the block's front
    chunk) 2, j == i ("diag": front diagonal, back x front, back
    diagonal) 2, j > i ("future": the local back chunk against the whole
    block) 2. The block halves reach the kernels as strided views."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, scale):
        n, my = C.axis_size_of(group), C.axis_index(group)
        B, Tq, H, D = q.shape
        C_ = Tq // 2
        f32 = dict(dtype=torch.float32, device=q.device)
        qf, qb = q[:, :C_], q[:, C_:]
        sq_f, sq_b = _halves(seg, C_)
        of = torch.zeros((B, C_, H, D), **f32)
        ob = torch.zeros((B, C_, H, D), **f32)
        lf = torch.full((B, H, C_), NEG_INF, **f32)
        lb = torch.full((B, H, C_), NEG_INF, **f32)
        perm = _ring_perm(n)
        kv, sk = torch.stack([k, v]), seg
        for s in range(n):
            src = (my - s) % n
            k_blk, v_blk = kv[0], kv[1]
            sk_f, sk_b = _halves(sk, C_)
            if src < my:
                o_n, l_n = flash_block_fwd(q, k_blk[:, :C_], v_blk[:, :C_],
                                           causal=False, scale=scale,
                                           seg_q=seg, seg_kv=sk_f)
                of, lf = merge_partials(of, lf, o_n[:, :C_], l_n[..., :C_])
                ob, lb = merge_partials(ob, lb, o_n[:, C_:], l_n[..., C_:])
            elif src == my:
                o_fd, l_fd = flash_block_fwd(
                    qf, k_blk[:, :C_], v_blk[:, :C_], causal=True,
                    scale=scale, seg_q=sq_f, seg_kv=sk_f)
                o_bf, l_bf = flash_block_fwd(
                    qb, k_blk[:, :C_], v_blk[:, :C_], causal=False,
                    scale=scale, seg_q=sq_b, seg_kv=sk_f)
                o_bd, l_bd = flash_block_fwd(
                    qb, k_blk[:, C_:], v_blk[:, C_:], causal=True,
                    scale=scale, seg_q=sq_b, seg_kv=sk_b)
                of, lf = merge_partials(of, lf, o_fd, l_fd)
                ob, lb = merge_partials(ob, lb, o_bf, l_bf)
                ob, lb = merge_partials(ob, lb, o_bd, l_bd)
            else:
                o_n, l_n = flash_block_fwd(qb, k_blk, v_blk, causal=False,
                                           scale=scale, seg_q=sq_b,
                                           seg_kv=sk)
                ob, lb = merge_partials(ob, lb, o_n, l_n)
            if s + 1 < n:
                kv, sk = _rotate(kv, sk, group, perm)
        out = torch.cat([of, ob], dim=1).to(q.dtype)
        lse = torch.cat([lf, lb], dim=2)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.opts = (group, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg, out, lse = ctx.saved_tensors
        group, scale = ctx.opts
        n, my = C.axis_size_of(group), C.axis_index(group)
        C_ = q.shape[1] // 2
        do = g.to(q.dtype).contiguous()
        delta = _delta(do, out, q)
        qf, qb = q[:, :C_], q[:, C_:]
        sq_f, sq_b = _halves(seg, C_)
        do_f, do_b = do[:, :C_], do[:, C_:]
        lse_f, lse_b = lse[..., :C_], lse[..., C_:]
        dl_f, dl_b = delta[..., :C_], delta[..., C_:]
        perm = _ring_perm(n)
        kv, sk = torch.stack([k, v]), seg
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for s in range(n):
            src = (my - s) % n
            k_blk, v_blk = kv[0], kv[1]
            sk_f, sk_b = _halves(sk, C_)
            if src < my:
                dq_c, dkf, dvf = flash_block_bwd(
                    q, k_blk[:, :C_], v_blk[:, :C_], do, lse, delta,
                    causal=False, scale=scale, seg_q=seg, seg_kv=sk_f)
                dq += dq_c
                dkv[0, :, :C_] += dkf
                dkv[1, :, :C_] += dvf
            elif src == my:
                dqf, dkf1, dvf1 = flash_block_bwd(
                    qf, k_blk[:, :C_], v_blk[:, :C_], do_f, lse_f, dl_f,
                    causal=True, scale=scale, seg_q=sq_f, seg_kv=sk_f)
                dqb1, dkf2, dvf2 = flash_block_bwd(
                    qb, k_blk[:, :C_], v_blk[:, :C_], do_b, lse_b, dl_b,
                    causal=False, scale=scale, seg_q=sq_b, seg_kv=sk_f)
                dqb2, dkb, dvb = flash_block_bwd(
                    qb, k_blk[:, C_:], v_blk[:, C_:], do_b, lse_b, dl_b,
                    causal=True, scale=scale, seg_q=sq_b, seg_kv=sk_b)
                dq[:, :C_] += dqf
                dq[:, C_:] += dqb1 + dqb2
                dkv[0, :, :C_] += dkf1 + dkf2
                dkv[1, :, :C_] += dvf1 + dvf2
                dkv[0, :, C_:] += dkb
                dkv[1, :, C_:] += dvb
            else:
                dqb, dk_c, dv_c = flash_block_bwd(
                    qb, k_blk, v_blk, do_b, lse_b, dl_b, causal=False,
                    scale=scale, seg_q=sq_b, seg_kv=sk)
                dq[:, C_:] += dqb
                dkv[0] += dk_c
                dkv[1] += dv_c
            dkv = C._permute(dkv, group, perm)
            if s + 1 < n:
                kv, sk = _rotate(kv, sk, group, perm)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


# ---------------------------------------------------------------------------
# the plain version: online softmax, autograd through ppermute
# ---------------------------------------------------------------------------

def _ring_einsum(q, k, v, group, causal, scale):
    n, my = C.axis_size_of(group), C.axis_index(group)
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape[2] != H:
        # GQA: materialise the head repeat; autograd sums the group back
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    acc = _acc_dtype(q)
    o = torch.zeros((B, Tq, H, D), dtype=acc, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=acc, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=acc, device=q.device)
    perm = _ring_perm(n)
    k_blk, v_blk = k, v
    for s in range(n):
        src = (my - s) % n
        o, m, l = online_softmax_block(q, k_blk, v_blk, o, m, l,
                                       causal=causal, q_offset=my * Tq,
                                       kv_offset=src * Tk, scale=scale)
        if s + 1 < n:
            k_blk, v_blk = C.ppermute((k_blk, v_blk), group, perm)
    return finalize_online_softmax(o, l, q.dtype)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, *, causal: bool = False,
                         scale: Optional[float] = None, impl: str = "flash",
                         layout: str = "contiguous", segment_ids=None,
                         block_q: int = 512,
                         block_k: int = 1024) -> torch.Tensor:
    """Ring attention over this rank's shards of ``group``.

    Args:
      q/k/v: this rank's sequence shards ``[B, T_local, H|Hkv, D]``; the
        global sequence is the concatenation over the group in rank order
        (``layout='contiguous'``) or the zigzag chunk-pair order
        (``layout='zigzag'``, :func:`to_zigzag`). K/V may carry fewer
        heads than q (GQA/MQA): their blocks rotate at their own size.
      causal: a causal mask over *global* positions.
      impl: ``'flash'`` (the block kernels K1-K3, the ring backward by
        hand) or ``'einsum'`` (the plain version, autograd through the
        transfers).
      layout: ``'zigzag'`` balances causal work; it needs ``causal=True``
        and ``impl='flash'``.
      segment_ids: optional ``[B, T_local]`` packed-segment ids of this
        shard (flash only); the kv ids travel with their block.
      block_q/block_k: accepted for signature parity (the kernels' tiles
        are their own).

    Returns this rank's output shard ``[B, T_local, H, D]`` (q's dtype).
    """
    del block_q, block_k
    g = C.as_group(group)
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got "
                         f"{layout!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    seg = (None if segment_ids is None
           else segment_ids.to(torch.int32).contiguous())
    if layout == "zigzag":
        if not causal or impl != "flash":
            raise ValueError(
                "layout='zigzag' exists to balance CAUSAL work and is "
                "implemented for impl='flash' (non-causal rings are already "
                "balanced — use layout='contiguous')")
        if q.shape[1] % 2:
            raise ValueError(f"a zigzag shard holds two equal chunks; "
                             f"T_local {q.shape[1]} is odd")
        return _ZigzagRingFlash.apply(q, k, v, seg, g, float(scale))
    if impl == "flash":
        return _RingFlash.apply(q, k, v, seg, g, bool(causal), float(scale))
    if impl != "einsum":
        raise ValueError(f"impl must be 'flash' or 'einsum', got {impl!r}")
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids requires impl='flash' (the production path)")
    return _ring_einsum(q, k, v, g, causal, scale)


def seq_ring_attention_local(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, group=None, *,
                             causal: bool = True,
                             scale: Optional[float] = None,
                             segment_ids=None, block_q: int = 512,
                             block_k: int = 1024) -> torch.Tensor:
    """The ParallelPlan ``seq``-axis ring: the contiguous flash ring of
    :func:`ring_attention_local`, with exactly ``n - 1`` K/V hops a
    forward pass (each ONE transfer of the stacked K/V pair) and ``(n -
    1) + n`` a backward (K/V plus the travelling dk/dv accumulator). Its
    signature matches the ``attention_fn`` contract of
    :class:`~chainermn_tpu_torch.models.transformer.TransformerBlock`."""
    return ring_attention_local(q, k, v, group, causal=causal, scale=scale,
                                impl="flash", segment_ids=segment_ids,
                                block_q=block_q, block_k=block_k)


# ---------------------------------------------------------------------------
# global entry points
# ---------------------------------------------------------------------------

class _ShardSeq(torch.autograd.Function):
    """This rank's block of a replicated global tensor along ``dim``
    forward; the ranks' cotangent blocks all-gathered backward (so every
    rank gets the whole input gradient of a loss every rank computes
    alike)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n, r = C.axis_size_of(group), C.axis_index(group)
        if x.shape[dim] % n:
            raise ValueError(f"sequence length {x.shape[dim]} not "
                             f"divisible by the group size {n}")
        ctx.group, ctx.dim = group, dim
        t = x.shape[dim] // n
        return x.narrow(dim, r * t, t).contiguous()

    @staticmethod
    def backward(ctx, ct):
        return C._all_gather(ct.contiguous(), ctx.group, ctx.dim,
                             True), None, None


def shard_sequence(x: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous block of a global (replicated) tensor along
    ``dim``; its gradient is the whole input's, gathered from the ranks."""
    return _ShardSeq.apply(x, C.as_group(group), dim)


def gather_sequence(x: torch.Tensor, group=None, dim: int = 1) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``; backward, this rank's
    block of the (replicated) cotangent."""
    from chainermn_tpu_torch.parallel.tensor import gather_from_tp

    return gather_from_tp(x, C.as_group(group), dim)


def make_ring_attention(group=None, *, causal: bool = False,
                        scale: Optional[float] = None, impl: str = "flash",
                        layout: str = "contiguous",
                        with_segments: bool = False):
    """Ring attention over GLOBAL ``[B, T, H, D]`` tensors that every rank
    of ``group`` holds alike: ``fn(q, k, v)`` (``fn(q, k, v,
    segment_ids)`` with ``with_segments``) cuts this rank's shard (after
    the zigzag reorder with ``layout='zigzag'``), runs
    :func:`ring_attention_local` and gathers the global output on every
    rank. Its gradients are those of one loss that every rank computes
    alike from the output, the whole gradient on every rank (the JAX
    function's global view)."""
    g = C.as_group(group)

    def fn(q, k, v, segment_ids=None):
        if with_segments != (segment_ids is not None):
            raise ValueError("pass segment_ids exactly when the function "
                             "was made with_segments=True")
        n = C.axis_size_of(g)
        ins = [q, k, v] + ([segment_ids] if with_segments else [])
        if layout == "zigzag":
            ins = [to_zigzag(t, n, 1) for t in ins]
        q_l, k_l, v_l = (shard_sequence(t, g, 1) for t in ins[:3])
        seg = None
        if with_segments:
            t = ins[3].shape[1] // n
            seg = ins[3].narrow(1, C.axis_index(g) * t, t)
        out = gather_sequence(
            ring_attention_local(q_l, k_l, v_l, g, causal=causal,
                                 scale=scale, impl=impl, layout=layout,
                                 segment_ids=seg), g, 1)
        return from_zigzag(out, n, 1) if layout == "zigzag" else out

    return fn


__all__ = ["from_zigzag", "gather_sequence", "make_ring_attention",
           "merge_partials", "ring_attention_local",
           "seq_ring_attention_local", "shard_sequence", "to_zigzag",
           "zigzag_indices"]
