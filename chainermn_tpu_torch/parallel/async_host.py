"""Staleness-1 gradient reduction on a background thread (counterpart of
``chainermn_tpu/parallel/async_host.py``).

A background thread reduces step *t*'s gradients over the communicator's
host plane while the caller computes step *t+1*; the caller applies the
reduced gradients one step late, the reference
``_DoubleBufferingOptimizer``'s staleness-1 semantics with the overlap
made literal (a thread for the CUDA side stream; pickling and the
``torch.distributed`` wait release the GIL). In the port the host plane
is the communicator itself (``comm.host is comm``, one rank a process),
and the reduction is its ``allreduce_obj`` of host copies of the
gradients, summed in rank order.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import torch
from torch.utils import _pytree as pytree

__all__ = ["AsyncHostGradReducer"]


def _tree_sum(a: Any, b: Any) -> Any:
    return pytree.tree_map(lambda x, y: x + y, a, b)


class AsyncHostGradReducer:
    """Staleness-1 gradient reduction over ``comm.host``, the collective
    running on a background thread::

        reducer = AsyncHostGradReducer(comm)
        for batch in data:
            grads = compute_grads(params, batch)   # step t
            stale = reducer.exchange(grads)        # t-1's mean, None at 0
            if stale is not None:
                apply(params, stale)
        last = reducer.flush()                     # the final step's mean

    ``exchange`` collects the previous step's mean first, so at most one
    reduction is in flight. The gradients (a tensor or a tree of them)
    are copied to the host before the thread starts, so the caller may
    overwrite them at once; the means come back as host tensors.

    **Exclusivity (hard constraint):** while a reduction is in flight
    (``in_flight``), no other collective may run on the communicator's
    group from any thread on any rank: a ``torch.distributed`` group
    orders its collectives by issue, and a second one issued meanwhile
    (an ``allreduce_obj``, a ``barrier``, and on the card the train
    step's metrics ``all_reduce`` and gradient reduction) mismatches
    the ranks' sequences and deadlocks or mixes them. Reduce metrics
    before ``exchange`` or after ``flush``, never between.
    ``simulated_dcn_latency_s`` floors each reduction's wall time (the
    wait of a slow inter-host hop, applied to :meth:`reduce_sync` alike
    so that a comparison stays like for like)."""

    def __init__(self, comm, *, average: bool = True,
                 simulated_dcn_latency_s: float = 0.0) -> None:
        self._host = comm.host
        self._n = comm.host.size
        self._average = average
        self._latency = simulated_dcn_latency_s
        self._thread: threading.Thread | None = None
        self._result: Any = None
        self._error: BaseException | None = None

    # -- internals -----------------------------------------------------

    def _run(self, grads_host) -> None:
        try:
            t_floor = time.perf_counter() + self._latency
            total = self._host.allreduce_obj(grads_host, op=_tree_sum)
            if self._average:
                total = pytree.tree_map(lambda x: x / self._n, total)
            if self._latency > 0.0:
                remaining = t_floor - time.perf_counter()
                if remaining > 0:
                    time.sleep(remaining)
            self._result = total
        except BaseException as e:  # raised again on the caller's thread
            self._error = e

    def _submit(self, grads) -> None:
        if self._thread is not None:
            raise RuntimeError("a reduction is already in flight")
        # the host snapshot BEFORE the thread starts: the caller may
        # overwrite the device buffers afterwards
        grads_host = pytree.tree_map(
            lambda g: torch.as_tensor(g).detach().to("cpu", copy=True),
            grads)
        self._thread = threading.Thread(target=self._run,
                                        args=(grads_host,), daemon=True)
        self._thread.start()

    def _collect(self) -> Any:
        if self._thread is None:
            return None
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        out, self._result = self._result, None
        return out

    # -- public --------------------------------------------------------

    @property
    def in_flight(self) -> bool:
        """True while a background reduction owns the group (see the
        exclusivity constraint)."""
        return self._thread is not None

    def exchange(self, grads) -> Any:
        """Collect step *t-1*'s mean (None on the first call), then start
        step *t*'s reduction in the background."""
        prev = self._collect()
        self._submit(grads)
        return prev

    def flush(self) -> Any:
        """Drain the in-flight reduction (the last step's mean)."""
        return self._collect()

    def reduce_sync(self, grads) -> Any:
        """The sequential baseline: the same wire and bytes, blocking."""
        self._submit(grads)
        return self._collect()
