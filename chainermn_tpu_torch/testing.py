"""Testing utilities of the port (counterpart of ``chainermn_tpu/testing.py``).

The JAX package tests distributed code in one process over N virtual CPU
devices. The port runs one process per rank, as the reference ChainerMN
did under ``mpiexec -n N pytest``, so its harness is a launcher:
:func:`run_distributed` starts ``size`` gloo ranks on the CPU with the
``forkserver`` method (the server imports torch once, so a rank starts
without importing it), hands each the same numpy inputs and returns
each rank's numpy results::

    from chainermn_tpu_torch.testing import run_distributed

    outs = run_distributed(my_worker, 2, {"x": x})   # one dict per rank

``my_worker(inputs) -> {name: array}`` is a module-level function (it
is pickled by its import path), and the module that holds it must import
no JAX: a child imports it before it runs anything. Inputs and results
cross as ``.npz`` files in a temporary directory, which also holds the
``FileStore`` the ranks rendezvous on, so no port is chosen. Every child
has a deadline: a rank that hangs is killed and the call raises, with
each failing rank's traceback.

:func:`launch_ranks` is the launch for drills in which a rank ends its
own process — a preemption guard's ``os._exit(0)``, the except hook's
``os._exit(1)``: each rank is a command of its own (a script that calls
:func:`init_rank_from_env` first), every rank runs until it exits or
reaches the deadline, and the call returns each rank's exit code,
output and time instead of raising.

:func:`assert_distributed_equals_single` is the suite's invariant,
distributed result == single-process result, in torch form.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

#: torch threads per child: ranks share the machine with the other test
#: workers, and the tests run at small sizes
CHILD_THREADS = 1
#: what the ranks' fork server imports once, so that no rank pays for
#: importing torch itself
_PRELOAD = ["numpy", "torch", "torch.distributed"]


def _child(worker: Callable, rank: int, size: int, tmp: str) -> None:
    """One rank: join the gloo group, run ``worker`` on the inputs, save
    its results (or its traceback), and end the process at once.

    The rank leaves with ``os._exit``, without the interpreter's teardown:
    a worker that imports ``torch.distributed.checkpoint`` while its group
    exists keeps the gloo group's threads running past
    ``destroy_process_group``, and tearing the process down around them
    aborts it now and then (SIGABRT, "terminate called without an active
    exception"), after its results were written."""
    import torch.distributed as dist

    torch.set_num_threads(CHILD_THREADS)
    code = 0
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=rank, world_size=size)
        try:
            with np.load(os.path.join(tmp, "in.npz")) as f:
                inputs = {k: f[k] for k in f.files}
            out = worker(inputs) or {}
            np.savez(os.path.join(tmp, f"out{rank}.npz"),
                     **{k: np.asarray(v) for k, v in out.items()})
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        code = 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def run_distributed(worker: Callable[[dict], Mapping[str, Any]], size: int,
                    inputs: Optional[Mapping[str, Any]] = None, *,
                    timeout: float = 120.0) -> list:
    """Run ``worker(inputs)`` on ``size`` gloo ranks, one process each
    (forked by the fork server); return the ranks' results, ``[{name:
    ndarray}, ...]`` in rank order.

    Raises ``RuntimeError`` when a rank raises, dies or outlives
    ``timeout`` seconds (it is killed, and so are the others)."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    ctx = torch.multiprocessing.get_context("forkserver")
    # the ranks fork from one server that has imported torch already
    ctx.set_forkserver_preload(_PRELOAD)
    with tempfile.TemporaryDirectory(prefix="cmt_ranks_") as tmp:
        np.savez(os.path.join(tmp, "in.npz"),
                 **{k: np.asarray(v) for k, v in (inputs or {}).items()})
        procs = [ctx.Process(target=_child, args=(worker, r, size, tmp),
                             daemon=True) for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # a rank that fails leaves its peers waiting in a collective:
            # stop them all at the first failure or at the deadline
            while (any(p.is_alive() for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        finally:
            timed_out = time.monotonic() >= deadline
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"err{r}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"--- rank {r} ---\n{f.read()}")
            elif r in alive:
                errors.append(f"--- rank {r} --- " + (
                    f"still running after {timeout} s" if timed_out
                    else "stopped after another rank failed") + "; killed")
            elif p.exitcode != 0:
                errors.append(f"--- rank {r} --- exit code {p.exitcode}")
        if errors:
            raise RuntimeError(
                f"{getattr(worker, '__name__', worker)} failed on "
                f"{len(errors)} of {size} ranks:\n" + "\n".join(errors))
        outs = []
        for r in range(size):
            with np.load(os.path.join(tmp, f"out{r}.npz")) as f:
                outs.append({k: f[k] for k in f.files})
        return outs


class RankExit(NamedTuple):
    """How one rank of :func:`launch_ranks` ended."""

    returncode: Optional[int]  # None: killed at the deadline
    output: str  # stdout and stderr, interleaved
    seconds: float  # from the launch to its exit (or the deadline)
    timed_out: bool


def init_rank_from_env() -> tuple[int, int]:
    """Join the gloo group a :func:`launch_ranks` rank was started for
    (its ``CMT_RANK``, ``CMT_WORLD_SIZE`` and ``CMT_STORE`` file);
    returns ``(rank, size)``."""
    import torch.distributed as dist

    rank = int(os.environ["CMT_RANK"])
    size = int(os.environ["CMT_WORLD_SIZE"])
    torch.set_num_threads(CHILD_THREADS)
    dist.init_process_group("gloo",
                            init_method="file://" + os.environ["CMT_STORE"],
                            rank=rank, world_size=size)
    return rank, size


def launch_ranks(argv: Sequence[str], size: int, *, timeout: float = 120.0,
                 env: Optional[Mapping[str, str]] = None) -> list:
    """Run ``python argv...`` as ``size`` ranks (one process each, the
    rank in ``CMT_RANK``, the world size in ``CMT_WORLD_SIZE``, a fresh
    store file in ``CMT_STORE``, plus ``env``) and let each end on its
    own: nothing is killed at another rank's failure, only at the
    deadline. Returns a :class:`RankExit` per rank, in rank order."""
    with tempfile.TemporaryDirectory(prefix="cmt_launch_") as tmp:
        procs, logs = [], []
        t0 = time.monotonic()
        for r in range(size):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, **(env or {}), "CMT_RANK": str(r),
                     "CMT_WORLD_SIZE": str(size),
                     "CMT_STORE": os.path.join(tmp, "store")}))
        ended = [None] * size
        try:
            while (any(e is None for e in ended)
                   and time.monotonic() - t0 < timeout):
                for r, p in enumerate(procs):
                    if ended[r] is None and p.poll() is not None:
                        ended[r] = time.monotonic() - t0
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            timed_out = ended[r] is None
            out.append(RankExit(None if timed_out else p.returncode, text,
                                timeout if timed_out else ended[r],
                                timed_out))
        return out


def assert_allclose_tree(actual: Any, desired: Any, *, rtol: float = 1e-5,
                         atol: float = 1e-6, path: str = "") -> None:
    """``np.testing.assert_allclose`` leaf by leaf over nested dicts,
    lists and tuples of tensors or arrays, naming the failing leaf."""
    if isinstance(desired, Mapping):
        assert set(actual) == set(desired), (path, sorted(actual),
                                             sorted(desired))
        for k in desired:
            assert_allclose_tree(actual[k], desired[k], rtol=rtol,
                                 atol=atol, path=f"{path}/{k}")
        return
    if isinstance(desired, (list, tuple)):
        assert len(actual) == len(desired), path
        for i, (a, d) in enumerate(zip(actual, desired)):
            assert_allclose_tree(a, d, rtol=rtol, atol=atol,
                                 path=f"{path}[{i}]")
        return

    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().cpu().numpy()
        return np.asarray(x)

    np.testing.assert_allclose(arr(actual), arr(desired), rtol=rtol,
                               atol=atol, err_msg=path)


def assert_distributed_equals_single(distributed_fn: Callable,
                                     single_fn: Callable, comm, batch: Any,
                                     *, rtol: float = 1e-4,
                                     atol: float = 1e-5) -> None:
    """``distributed_fn(comm, batch)`` on this rank against
    ``single_fn(batch)``, the one-process result on the same GLOBAL
    batch; ``distributed_fn`` takes this rank's share of ``batch``
    itself, as the code under test does."""
    assert_allclose_tree(distributed_fn(comm, batch), single_fn(batch),
                         rtol=rtol, atol=atol)


__all__ = ["RankExit", "assert_allclose_tree",
           "assert_distributed_equals_single", "init_rank_from_env",
           "launch_ranks", "run_distributed"]
