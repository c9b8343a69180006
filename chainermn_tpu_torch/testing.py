"""Testing utilities of the port (counterpart of ``chainermn_tpu/testing.py``).

The JAX package tests distributed code in one process over N virtual CPU
devices. The port runs one process per rank, as the reference ChainerMN
did under ``mpiexec -n N pytest``, so its harness is a launcher:
:func:`run_distributed` starts ``size`` gloo ranks on the CPU with the
``spawn`` method, hands each the same numpy inputs and returns each
rank's numpy results::

    from chainermn_tpu_torch.testing import run_distributed

    outs = run_distributed(my_worker, 2, {"x": x})   # one dict per rank

``my_worker(inputs) -> {name: array}`` is a module-level function (spawn
pickles it by its import path), and the module that holds it must import
no JAX: a child imports it before it runs anything. Inputs and results
cross as ``.npz`` files in a temporary directory, which also holds the
``FileStore`` the ranks rendezvous on, so no port is chosen. Every child
has a deadline: a rank that hangs is killed and the call raises, with
each failing rank's traceback.

:func:`assert_distributed_equals_single` is the suite's invariant,
distributed result == single-process result, in torch form.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

#: torch threads per child: ranks share the machine with the other test
#: workers, and the tests run at small sizes
CHILD_THREADS = 1


def _child(worker: Callable, rank: int, size: int, tmp: str) -> None:
    """One rank: join the gloo group, run ``worker`` on the inputs, save
    its results (or its traceback)."""
    import torch.distributed as dist

    torch.set_num_threads(CHILD_THREADS)
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
        raise


def run_distributed(worker: Callable[[dict], Mapping[str, Any]], size: int,
                    inputs: Optional[Mapping[str, Any]] = None, *,
                    timeout: float = 120.0) -> list:
    """Run ``worker(inputs)`` on ``size`` gloo ranks, one spawned process
    each; return the ranks' results, ``[{name: ndarray}, ...]`` in rank
    order.

    Raises ``RuntimeError`` when a rank raises, dies or outlives
    ``timeout`` seconds (it is killed, and so are the others)."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    ctx = torch.multiprocessing.get_context("spawn")
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


__all__ = ["run_distributed", "assert_allclose_tree",
           "assert_distributed_equals_single"]
