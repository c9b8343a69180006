"""Preemption-aware training: catch the eviction signal, agree across
ranks, checkpoint, exit clean (counterpart of
``chainermn_tpu/utils/preemption.py``).

The reference's fault story was restart-based: the global except hook
turned crashes into whole-job aborts and the checkpointer resumed from
the newest common snapshot (SURVEY.md section 5, "failure detection").
Cluster schedulers also preempt with warning — SIGTERM, then a grace
window — so the guard catches the signal, has every rank agree that a
checkpoint is due (one rank may be signalled before the others), saves
at the same iteration on every rank and exits 0. On restart,
``maybe_load`` resumes from that snapshot.

Usage::

    guard = install_preemption_guard()
    for it in range(start, steps):
        state, metrics = step(state, batch)
        if guard.should_checkpoint(comm, every=50, iteration=it):
            ckpt.save(state, it)
            guard.exit_if_preempted(comm)
"""

from __future__ import annotations

import os
import signal
from typing import Any, Optional, Sequence


class PreemptionGuard:
    """Holds the signal flag; see the module docstring for the loop."""

    def __init__(self, signals: Sequence[Any]) -> None:
        self._flag = False
        self._auto_iter = -1
        self._installed = []
        for sig in signals:
            prev = signal.signal(sig, self._handler)
            self._installed.append((sig, prev))

    def _handler(self, signum, frame):  # the signal module's signature
        del signum, frame
        self._flag = True

    @property
    def triggered(self) -> bool:
        """This process received a preemption signal (its own view only;
        :meth:`should_checkpoint` is the cross-rank decision)."""
        return self._flag

    def should_checkpoint(self, comm, *, every: Optional[int] = None,
                          iteration: Optional[int] = None) -> bool:
        """True when ANY rank was signalled (an agreement over the ranks,
        so every rank checkpoints the same iteration). With ``every``, the
        collective runs only at multiples of it: a signal waits at most
        ``every`` steps and the other steps cost nothing. ``iteration``
        gives the position explicitly; without it a per-guard call
        counter is used (each call one step)."""
        if every is not None:
            if iteration is None:
                self._auto_iter += 1
                iteration = self._auto_iter
            if iteration % every != 0:
                return False
        if comm.host.size == 1:
            return self._flag
        return bool(comm.allreduce_obj(int(self._flag)))

    def exit_if_preempted(self, comm) -> None:
        """After a preemption-triggered save: a barrier (every rank's
        snapshot is on disk), then exit 0 — a clean end the scheduler
        reads as graceful, unlike the except hook's abort."""
        if not self.should_checkpoint(comm):
            return
        comm.barrier()
        os._exit(0)

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed = []


def install_preemption_guard(signals: Sequence[Any] = (signal.SIGTERM,)
                             ) -> PreemptionGuard:
    """Install handlers for the preemption ``signals`` (default SIGTERM,
    what schedulers send before they evict) and return the guard."""
    return PreemptionGuard(signals)
