"""Ulysses (DeepSpeed-style) sequence parallelism: the all-to-all
head-sequence reshard (counterpart of ``chainermn_tpu/parallel/ulysses.py``).

Where ring attention streams K/V around the ranks, Ulysses re-shards:
the inputs arrive sequence-sharded, one all-to-all turns them
head-sharded with the whole sequence on each rank, plain attention (the
flash kernels K1-K3, on ``H/n`` heads over the full sequence) runs on
the rank's heads, and a second all-to-all restores the sequence
sharding. The all-to-alls are
:func:`~chainermn_tpu_torch.parallel.collectives.alltoall`, whose
backward is the all-to-all with the axes swapped.

Constraint: the q and kv head counts must be divisible by the group
size (heads are the resharding currency). ``group`` is a process group
or a communicator (``None``: the default group).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from chainermn_tpu_torch.ops.attention import blockwise_attention
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.parallel import collectives as C


def check_ulysses_divisibility(q_heads: int, kv_heads: int, n: int, *,
                               axis_name: str = "seq") -> None:
    """Reject head counts Ulysses cannot reshard, naming BOTH numbers: the
    two all-to-alls split the head dim ``n`` ways, so ``q_heads % n`` and
    ``kv_heads % n`` must both be 0. Raised at entry, before any
    collective."""
    for name, h in (("q", int(q_heads)), ("kv", int(kv_heads))):
        if h % n != 0:
            raise ValueError(
                f"ulysses: {name} heads {h} not divisible by axis "
                f"{axis_name!r} size {n} — pad the head count, shrink the "
                f"seq axis, or use the ring provider (seq_attn_impl="
                f"'ring'), which has no divisibility constraint")


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, group=None, *,
                            causal: bool = False,
                            scale: Optional[float] = None,
                            attn_fn: Optional[Callable] = None,
                            impl: str = "flash", segment_ids=None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Ulysses attention over this rank's sequence shards of ``group``.

    Args:
      q/k/v: this rank's shards ``[B, T_local, H|Hkv, D]``; the global head
        counts must be divisible by the group size (GQA/MQA kv heads too).
      attn_fn: local attention ``fn(q, k, v, causal=..., scale=...)`` on
        ``[B, T, H_local, D]``; overrides ``impl`` when given.
      impl: ``'flash'`` (K1-K3, the production path) or ``'blockwise'``
        (the plain reference).
      segment_ids: optional ``[B, T_local]`` packed-segment ids of this
        shard; all-gathered (ids only) so the full-sequence attention sees
        the whole mask. Needs ``impl='flash'`` or a segment-capable
        ``attn_fn``.
      window: causal sliding-window width, handed to the flash kernels
        (each rank runs the full-sequence band over its own heads). Needs
        ``causal=True`` and ``impl='flash'``.

    Returns this rank's output shard ``[B, T_local, H, D]``.
    """
    g = C.as_group(group)
    n = C.axis_size_of(g)
    check_ulysses_divisibility(q.shape[2], k.shape[2], n)
    if window is not None and (impl != "flash" or attn_fn is not None):
        raise ValueError(
            "window is implemented by the flash kernel — use impl='flash' "
            "without a custom attn_fn (or honour the window inside your "
            "attn_fn yourself)")
    if attn_fn is None:
        if impl == "flash":
            def attn_fn(q, k, v, *, causal, scale, **kw):
                return flash_attention(q, k, v, causal=causal, scale=scale,
                                       window=window, **kw)
        elif impl == "blockwise":
            if segment_ids is not None:
                raise ValueError("segment_ids requires impl='flash' (or a "
                                 "segment-capable attn_fn)")
            attn_fn = blockwise_attention
        else:
            raise ValueError(f"impl must be 'flash' or 'blockwise', got "
                             f"{impl!r}")

    def seq_to_heads(x):  # [B, T/n, H, D] -> [B, T, H/n, D]
        return C.alltoall(x, g, split_axis=2, concat_axis=1, tiled=True)

    def heads_to_seq(x):
        return C.alltoall(x, g, split_axis=1, concat_axis=2, tiled=True)

    kw = {}
    if segment_ids is not None:
        kw["segment_ids"] = C._all_gather(
            segment_ids.to(torch.int32).contiguous(), g, 1, True)
    out = attn_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                  causal=causal, scale=scale, **kw)
    return heads_to_seq(out)


def make_ulysses_attention(group=None, *, causal: bool = False,
                           scale: Optional[float] = None,
                           attn_fn: Optional[Callable] = None,
                           impl: str = "flash", with_segments: bool = False,
                           window: Optional[int] = None):
    """Ulysses attention over GLOBAL ``[B, T, H, D]`` tensors that every
    rank of ``group`` holds alike (the counterpart of
    :func:`~chainermn_tpu_torch.parallel.ring_attention.
    make_ring_attention`, the same global-view gradients): ``fn(q, k,
    v[, segment_ids])`` checks the head counts at entry, cuts this rank's
    shard, runs :func:`ulysses_attention_local` and gathers the output."""
    from chainermn_tpu_torch.parallel.ring_attention import (
        gather_sequence,
        shard_sequence,
    )

    g = C.as_group(group)

    def fn(q, k, v, segment_ids=None):
        n = C.axis_size_of(g)
        # divisibility rejected at ENTRY, with the global head counts
        check_ulysses_divisibility(q.shape[2], k.shape[2], n)
        if with_segments != (segment_ids is not None):
            raise ValueError("pass segment_ids exactly when the function "
                             "was made with_segments=True")
        seg = None
        if with_segments:
            t = segment_ids.shape[1] // n
            seg = segment_ids.narrow(1, C.axis_index(g) * t, t)
        out = ulysses_attention_local(
            shard_sequence(q, g), shard_sequence(k, g), shard_sequence(v, g),
            g, causal=causal, scale=scale, attn_fn=attn_fn, impl=impl,
            segment_ids=seg, window=window)
        return gather_sequence(out, g)

    return fn


__all__ = ["check_ulysses_divisibility", "make_ulysses_attention",
           "ulysses_attention_local"]
