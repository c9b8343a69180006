"""Percentile and fairness rules shared by the serving rollup
(counterpart of ``chainermn_tpu/observability/stats.py``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank_index(n: int, q: float) -> int:
    """0-based index of the nearest-rank percentile ``q`` in a sorted
    sequence of length ``n``: ``ceil(q * n) - 1`` clamped into
    ``[0, n - 1]``."""
    if n < 1:
        raise ValueError(f"need n >= 1 samples, got {n}")
    return min(n - 1, max(0, math.ceil(q * n) - 1))


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of ``values`` (None when empty)."""
    if not values:
        return None
    s = sorted(values)
    return s[nearest_rank_index(len(s), q)]


def jain_index(values: Sequence[float]) -> Optional[float]:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` — 1.0 is
    perfectly even; None when empty; an all-zero allocation reads 1.0."""
    xs = [float(v) for v in values]
    if not xs:
        return None
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    return (sum(xs) ** 2) / (len(xs) * sq)
