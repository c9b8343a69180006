"""Length bucketing for the serving engine's prefill (counterpart of
``chainermn_tpu/datasets/bucketing.py``).

Prompts are padded up to a small fixed ladder of lengths, so the
prefill runs at a handful of shapes. ``pad_to`` and ``bucket_batches``
land with the serving extensions (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import Sequence

#: power-of-two-ish default ladder; dense at short lengths
DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (sequences longer than the last bucket are
    truncated to it — callers choose buckets to make this rare)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
