"""The pipeline example twin (``chainermn_tpu_torch.examples.pipeline.
train_pipeline_mlp``) against the JAX example (``examples/pipeline/
train_pipeline_mlp.py``) at 2 and 4 gloo ranks against a 2- and
4-device CPU mesh, under each ``--schedule`` (gpipe, 1f1b, hetero), with
the JAX test's batch 64 and width 64 (``tests/torch_pipeline_workers.py::
twin_worker``, one launch per world size). Compared: the final loss the
JAX example prints and the accuracy it returns, after the same
iterations from the same weights (drawn as ``jax.random`` draws them),
batches and Adam; every rank reports the same losses.

Tolerance: the loss within half a unit of the printed 4th decimal plus
1e-4 relative (the weights' draws round a few ulps apart, and the
frameworks sum in other orders); the accuracy within one example of 64.
"""

import re
import sys

import jax
import numpy as np
import pytest

import chainermn_tpu
from chainermn_tpu import global_except_hook as jax_hook
from conftest import load_example
from torch_comm_workers import shared_launch
from torch_pipeline_workers import SCHEDULES, TWIN_FLAGS, twin_worker
from torch_rank_workers import (  # noqa: F401
    few_threads,
    restore_excepthook,
)

SIZES = (2, 4)
ITERATIONS = 8
BATCH = 64


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: shared_launch(f"pipeline_twin_worker{n}", tmp_path_factory,
                             twin_worker, n, {"iterations": ITERATIONS},
                             timeout=240) for n in SIZES}


def _jax_run(n, schedule, capsys, monkeypatch):
    """The JAX example on an n-device mesh: (printed final loss, returned
    accuracy); its except hook is put back."""
    ex = load_example("pipeline", "train_pipeline_mlp.py")
    make = chainermn_tpu.create_communicator
    monkeypatch.setattr(
        chainermn_tpu, "create_communicator",
        lambda name, **kw: make(name, devices=jax.devices("cpu")[:n], **kw))
    hook, installed = sys.excepthook, jax_hook._hook_installed
    capsys.readouterr()
    try:
        acc = ex.main(["--iterations", str(ITERATIONS), "--schedule",
                       schedule, *TWIN_FLAGS])
    finally:
        sys.excepthook, jax_hook._hook_installed = hook, installed
        monkeypatch.undo()
    final = re.search(r"final: loss=([0-9.]+) acc=([0-9.]+)",
                      capsys.readouterr().out)
    return float(final.group(1)), acc


@pytest.mark.parametrize("n,schedule", [(n, s) for n in SIZES
                                        for s in SCHEDULES])
def test_twin_matches_the_jax_example(runs, n, schedule, capsys,
                                      monkeypatch):
    loss, acc = _jax_run(n, schedule, capsys, monkeypatch)
    for o in runs[n]:
        losses = o[f"{schedule}/losses"]
        assert len(losses) == ITERATIONS
        assert abs(losses[-1] - loss) <= 5e-5 + 1e-4 * abs(loss), (
            losses[-1], loss)
        assert abs(o[f"{schedule}/accs"][-1] - acc) <= 1 / BATCH + 1e-9
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("n", SIZES)
def test_every_rank_reports_the_same_losses(runs, n):
    for s in SCHEDULES:
        for o in runs[n][1:]:
            np.testing.assert_array_equal(o[f"{s}/losses"],
                                          runs[n][0][f"{s}/losses"])
            np.testing.assert_array_equal(o[f"{s}/accs"],
                                          runs[n][0][f"{s}/accs"])
