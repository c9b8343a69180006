"""Minimal trainer loop with rank-0 reporting and extension triggers
(counterpart of ``chainermn_tpu/training/trainer.py``).

``Trainer`` pulls lists of examples from an iterator, collates them into
numpy arrays, puts them on the communicator's device (through
:func:`~chainermn_tpu_torch.training.prefetch.prefetch_to_device` when
``prefetch`` > 0) and runs the step; every ``log_interval`` iterations
rank 0 prints the metrics, and registered extensions run at their
intervals.

Checkpointing is an extension like any other: the MNIST twin registers
a ``MultiNodeCheckpointer.save`` at ``--checkpoint-interval``.

Left for later: the step-phase window (``consume_phase_window``, the
straggler monitor's input) and the trace, metrics and hang-watchdog
hooks (ROADMAP queue 8, observability).
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Iterable

import numpy as np

from chainermn_tpu_torch.communicators.base import CommunicatorBase
from chainermn_tpu_torch.training.prefetch import (
    prefetch_to_device,
    to_device,
)


def default_collate(batch: list) -> Any:
    """list of examples -> stacked numpy arrays. Examples may be tuples
    (``(x, y)``), dicts, or plain arrays."""
    first = batch[0]
    if isinstance(first, tuple):
        return tuple(np.stack([b[i] for b in batch])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: np.stack([b[k] for b in batch]) for k in first}
    return np.stack(batch)


def host_local_batch_to_global(batch: Any, comm: CommunicatorBase,
                               spec=None) -> Any:
    """The identity: this rank's local batch IS its share of the step.

    The JAX package runs one process per host over a device mesh, so it
    assembles the hosts' batches into global sharded arrays here. The port
    runs one rank per device with no mesh: each rank's step takes its own
    local batch, and the gradient mean over the ranks joins them."""
    del comm, spec
    return batch


class Trainer:
    """Drive ``step_fn(state, batch) -> (state, metrics)`` over an
    iterator with periodic extensions ``ext(trainer)``.

    ``prefetch``: batches copied to the device ahead of the step (0 =
    copy each batch when it is needed; 2 = double buffering). ``out``:
    where rank 0 logs (``sys.stdout`` at the time of the print by
    default).
    """

    def __init__(self, step_fn: Callable, state: Any, train_iter: Iterable,
                 comm: CommunicatorBase, *,
                 collate: Callable = default_collate,
                 log_interval: int = 100, out=None,
                 prefetch: int = 0) -> None:
        self.step_fn = step_fn
        self.state = state
        self.train_iter = train_iter
        self.comm = comm
        self.collate = collate
        self.log_interval = log_interval
        self.out = out
        self.prefetch = prefetch
        self.iteration = 0
        #: the rank-mean metrics at the last log point, on every rank
        self.observation: dict = {}
        self._extensions: list = []

    def extend(self, extension: Callable, *, interval: int = 1) -> None:
        self._extensions.append((interval, extension))

    def _log(self, msg: str) -> None:
        if self.comm.rank == 0:
            print(msg, file=self.out or sys.stdout, flush=True)

    def _collated_batches(self, n: int):
        """Exactly ``n`` collated batches, restarting the epoch iterator
        as needed (and refusing an epoch that yields nothing)."""
        produced = 0
        it = iter(self.train_iter)
        fresh_epoch = True
        while produced < n:
            try:
                batch = next(it)
                fresh_epoch = False
            except StopIteration:
                if fresh_epoch:
                    raise RuntimeError(
                        "train iterator yielded no batches in a full epoch "
                        "(dataset shard smaller than batch size with "
                        "drop_last?) — aborting instead of spinning")
                it = iter(self.train_iter)
                fresh_epoch = True
                continue
            produced += 1
            yield host_local_batch_to_global(self.collate(batch), self.comm)

    def run(self, max_iterations: int) -> Any:
        """Run until ``max_iterations`` steps in all; return the state."""
        t0 = time.perf_counter()
        batches = self._collated_batches(max_iterations - self.iteration)
        device = self.comm.device
        if self.prefetch:
            batches = prefetch_to_device(batches, self.prefetch,
                                         device=device)
        else:
            batches = (to_device(b, device) for b in batches)
        for batch in batches:
            self.state, metrics = self.step_fn(self.state, batch)
            self.iteration += 1
            if (self.iteration % self.log_interval == 0
                    or self.iteration == max_iterations):
                self.observation = {k: float(v) for k, v in metrics.items()}
                rate = self.iteration / (time.perf_counter() - t0)
                pretty = " ".join(f"{k}={v:.4f}"
                                  for k, v in self.observation.items())
                self._log(f"iter {self.iteration}/{max_iterations} "
                          f"{pretty} ({rate:.1f} it/s)")
            for interval, ext in self._extensions:
                if self.iteration % interval == 0:
                    ext(self)
        return self.state

    def consume_phase_window(self) -> dict:
        raise NotImplementedError(
            "the step-phase window is not ported yet (ROADMAP queue 8, "
            "observability: the straggler monitor and its phase timings)")


__all__ = ["Trainer", "default_collate", "host_local_batch_to_global"]
