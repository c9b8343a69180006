"""Cross-rank aggregation of training observations (counterpart of
``chainermn_tpu/extensions/observation_aggregator.py``).

Reference: upstream's ``ObservationAggregator`` extension (SURVEY.md
section 5, "Metrics / logging"): every ``interval`` iterations the
observations gathered over the window are averaged over time AND across
ranks, so rank 0 logs global statistics while the collective runs once
per window, not once per step.
"""

from __future__ import annotations

from typing import Mapping, Optional

from chainermn_tpu_torch.communicators.base import CommunicatorBase


def _union_sum(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, (s, c) in b.items():
        s0, c0 = out.get(k, (0.0, 0.0))
        out[k] = (s0 + s, c0 + c)
    return out


class ObservationAggregator:
    """Average numeric host-side observations (Python numbers or 0-dim
    tensors) across ranks and over a window of calls.

    With ``interval == 1`` (the default) every call aggregates at once.
    With ``interval > 1`` calls buffer locally and return None until the
    window closes; then the window's mean is reduced across ranks in one
    object collective and returned. Keys may vary between calls inside a
    window: each key averages over the calls that reported it."""

    def __init__(self, communicator: CommunicatorBase, *,
                 interval: int = 1) -> None:
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.comm = communicator
        self.interval = interval
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._calls = 0

    def __call__(self, observation: Mapping[str, float]
                 ) -> Optional[dict[str, float]]:
        self.add(observation)
        if self._calls < self.interval:
            return None
        return self.flush()

    def add(self, observation: Mapping[str, float]) -> None:
        """Buffer one observation into the current window, with no
        collective."""
        for k, v in observation.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
            self._counts[k] = self._counts.get(k, 0) + 1
        self._calls += 1

    def flush(self) -> Optional[dict[str, float]]:
        """Aggregate whatever the current window holds (at the end of
        training a partial window would otherwise be lost); None when the
        window is empty on EVERY rank. Collective: every rank calls it at
        the same point, also one whose window is empty. Keys are the union
        over ranks; each averages over the ranks and calls that reported
        it."""
        local = {k: (self._sums[k], float(self._counts[k]))
                 for k in self._sums}
        self._sums.clear()
        self._counts.clear()
        self._calls = 0
        total = self.comm.allreduce_obj(local, op=_union_sum)
        if not total:
            return None
        return {k: s / c for k, (s, c) in total.items()}

    def flush_per_rank(self) -> list[dict[str, float]]:
        """Every rank's window mean, in rank order (an empty window gives
        ``{}``): one allgather, the same collective contract as
        :meth:`flush`."""
        local = {k: self._sums[k] / self._counts[k]
                 for k in self._sums if self._counts.get(k)}
        self._sums.clear()
        self._counts.clear()
        self._calls = 0
        return self.comm.allgather_obj(local)


__all__ = ["ObservationAggregator"]
