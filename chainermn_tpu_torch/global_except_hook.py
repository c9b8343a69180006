"""Global exception hook: one crashed rank ends the whole job
(counterpart of ``chainermn_tpu/global_except_hook.py``).

Reference: ``chainermn/global_except_hook.py`` (SURVEY.md sections 2.7,
5): a ``sys.excepthook`` that prints the traceback and calls
``MPI_Abort(MPI_COMM_WORLD)``, so one rank's Python exception tears the
job down instead of leaving the other ranks hung in a collective.

Here the hook prints a banner naming the rank (from ``torch.distributed``)
and the traceback; with more than one rank it makes a bounded attempt at
``dist.destroy_process_group()`` on a daemon thread (joined after 5 s:
the peers may be blocked in a collective that waits on this rank, so an
unbounded teardown could hang) and then calls ``os._exit(1)``
unconditionally. The process's sockets close, the peers' pending
collectives fail, and their own hooks take them down the same way.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback

_hook_installed = False
#: seconds the hook waits for destroy_process_group before exiting
TEARDOWN_S = 5.0


def _rank_and_size():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None, None


def _try_destroy() -> None:
    import torch.distributed as dist

    try:
        dist.destroy_process_group()
    except Exception:  # best effort: the hard exit follows regardless
        pass


def _global_except_hook(exctype, value, tb) -> None:
    try:
        rank, size = _rank_and_size()
        sys.stderr.write("\n*****************************************************\n")
        if rank is not None:
            sys.stderr.write(f"chainermn_tpu_torch: uncaught exception on "
                             f"rank {rank}/{size}\n")
        traceback.print_exception(exctype, value, tb)
        sys.stderr.write("*****************************************************\n\n")
        sys.stderr.flush()
        if size is not None and size > 1:
            try:
                t = threading.Thread(target=_try_destroy, daemon=True)
                t.start()
                t.join(TEARDOWN_S)
            finally:
                # the MPI_Abort of the reference: falling through to a
                # normal exit could block in the group's teardown
                os._exit(1)
    except Exception:
        # the hook must never hide the original error
        sys.__excepthook__(exctype, value, tb)


def _add_hook() -> None:
    """Install the hook (idempotent); the examples call it right after
    they create their communicator."""
    global _hook_installed
    if _hook_installed:
        return
    sys.excepthook = _global_except_hook
    _hook_installed = True
