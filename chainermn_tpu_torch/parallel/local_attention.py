"""Sequence-parallel sliding-window (local) attention with O(window)
communication (counterpart of ``chainermn_tpu/parallel/local_attention.py``).

The distributed complement of ``flash_attention(window=W)``: a query
reaches only keys of the last ``W`` positions, which live on its own shard
and in the TAILS of its ``m = ceil((W - 1) / T_local)`` nearest
predecessors. So instead of rotating K/V around the whole ring, each rank
receives exactly the ``W - 1`` positions it needs, one transfer per
neighbour distance (:func:`~chainermn_tpu_torch.parallel.collectives.
shift`'s transfer, K/V and ids together):

1. predecessor ``s - d`` (``d = 1..m``) sends its last ``c_d = min(T_local,
   W - 1 - (d - 1) T_local)`` K/V positions ``d`` ranks forward; the
   receiver prepends them furthest first;
2. the flash kernel (K1) runs with the window and ``q_offset =`` the
   prefix length: local query row ``i`` sits at extended key position
   ``i + prefix``, so the causal band lands on the right keys;
3. slices that wrapped around the ring (rank ``s`` receiving from ``s - d
   < 0``) are masked through the segment ids: their ids become a
   sentinel no query carries;
4. backward (K2, K3 on the extended K/V): each prefix slice's gradient
   goes back to its owner (the transpose of the forward shift) and adds
   into the owner's last ``c_d`` positions; wrapped slices carry exact
   zeros (masked in the forward).

The port's kernels mask a ragged key tail themselves, so the extended K/V
need no padding to a block multiple. ``group`` is a process group or a
communicator (``None``: the default group).
"""

from __future__ import annotations

from typing import Optional

import torch

from chainermn_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_block_bwd,
    flash_block_fwd,
)
from chainermn_tpu_torch.parallel import collectives as C

#: the wrap-around mask sentinel: INT32_MIN is never a user segment id
_WRAP_SENTINEL = -(2 ** 31)


def _tail_slices(tail: int, L: int, n: int):
    """Predecessor ``s - d`` (``d = 1..m``) contributes its LAST ``c_d =
    min(L, tail - (d - 1) L)`` positions; ``m`` is capped at ``n - 1``.
    Returns ``[(d, c_d), ...]`` furthest first (the prefix order)."""
    m = min(-(-tail // L), n - 1)
    return [(d, min(L, tail - (d - 1) * L)) for d in range(m, 0, -1)]


def _shift_perm(n: int, d: int):
    return [(i, (i + d) % n) for i in range(n)]


def _ext_and_segs(k, v, seg, group, tail):
    """The extended K/V (the predecessors' tails prepended, furthest
    first) and the key segment ids, with the wrapped slices' ids set to
    the sentinel."""
    L = k.shape[1]
    n, me = C.axis_size_of(group), C.axis_index(group)
    k_parts, v_parts, id_parts = [], [], []
    for d, c in _tail_slices(tail, L, n):
        k_t, v_t, ids_t = C._permute_all(
            [k[:, L - c:], v[:, L - c:], seg[:, L - c:]], group,
            _shift_perm(n, d))
        if me < d:
            ids_t = torch.full_like(ids_t, _WRAP_SENTINEL)
        k_parts.append(k_t)
        v_parts.append(v_t)
        id_parts.append(ids_t)
    return (torch.cat(k_parts + [k], dim=1), torch.cat(v_parts + [v], dim=1),
            torch.cat(id_parts + [seg], dim=1))


class _LocalWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, group, window, scale):
        k_ext, v_ext, seg_k = _ext_and_segs(k, v, seg, group, window - 1)
        prefix = k_ext.shape[1] - k.shape[1]
        out, lse = flash_block_fwd(q, k_ext, v_ext, causal=True, scale=scale,
                                   window=window, q_offset=prefix, seg_q=seg,
                                   seg_kv=seg_k)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.opts = (group, window, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        from chainermn_tpu_torch.parallel.ring_attention import _delta

        q, k, v, seg, out, lse = ctx.saved_tensors
        group, window, scale = ctx.opts
        L = q.shape[1]
        n = C.axis_size_of(group)
        # rebuild the extended K/V: recomputing beats keeping an
        # overlapping copy
        k_ext, v_ext, seg_k = _ext_and_segs(k, v, seg, group, window - 1)
        prefix = k_ext.shape[1] - L
        do = g.to(q.dtype).contiguous()
        dq, dk_ext, dv_ext = flash_block_bwd(
            q, k_ext, v_ext, do, lse, _delta(do, out, q), causal=True,
            scale=scale, window=window, q_offset=prefix, seg_q=seg,
            seg_kv=seg_k)
        dk = dk_ext[:, prefix:prefix + L].clone()
        dv = dv_ext[:, prefix:prefix + L].clone()
        off = 0
        for d, c in _tail_slices(window - 1, L, n):
            # each prefix slice's gradient home to its owner (shift by -d)
            dk_b, dv_b = C._permute_all(
                [dk_ext[:, off:off + c], dv_ext[:, off:off + c]], group,
                _shift_perm(n, -d))
            dk[:, L - c:] += dk_b
            dv[:, L - c:] += dv_b
            off += c
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def sliding_window_attention_local(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, group=None, *,
                                   window: int,
                                   scale: Optional[float] = None,
                                   segment_ids=None, block_q: int = 512,
                                   block_k: int = 1024) -> torch.Tensor:
    """Causal sliding-window attention over this rank's sequence shard of
    ``group`` (the sequence sharded CONTIGUOUSLY in rank order; GQA/MQA
    supported).

    ``window`` is the band width ``W``: global query ``i`` sees keys ``(i -
    W, i]``; any width (the prefix gathers from ``ceil((W - 1) /
    T_local)`` predecessors, capped at the group). ``segment_ids``
    (optional ``[B, T_local]``) travel with the tails, so masking across
    a shard boundary stays exact; any int32 but ``INT32_MIN`` (the
    wrap-around sentinel) is a valid id. ``block_q``/``block_k`` are
    accepted for signature parity. Returns this rank's output shard."""
    del block_q, block_k
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window == 1:
        # each query sees only itself: no communication
        return flash_attention(q, k, v, causal=True, window=1, scale=scale,
                               segment_ids=segment_ids)
    seg = (segment_ids.to(torch.int32).contiguous()
           if segment_ids is not None
           else torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device))
    return _LocalWindow.apply(q, k, v, seg, C.as_group(group), int(window),
                              float(scale))


__all__ = ["sliding_window_attention_local"]
