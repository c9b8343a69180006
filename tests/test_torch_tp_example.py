"""The tensor-parallel example twin
(``chainermn_tpu_torch.examples.tensor_parallel.train_tp_transformer``)
against the JAX example (``examples/tensor_parallel/
train_tp_transformer.py``) on the same mesh shapes: at 2 gloo ranks
``--dp 1`` (tp 2) and the default (dp 2 x tp 1), at 4 the default (dp 2 x
tp 2) and ``--dp 1`` (tp 4), against the JAX example on a 2- and 4-device
CPU mesh with the same flags (``tests/torch_tp_workers.py::
tp_example_worker``, one launch per world size). Compared: the loss
after 30 iterations (the JAX example returns its final loss), the same
teacher, batches and Adam; the twin's loss falls.

Tolerance: 1e-4 relative. The weights are drawn as ``jax.random`` draws
them, but ``erfinv`` rounds a few ulps apart on ~5% of the draws, and
the two frameworks sum the attention and the products in other orders.
"""

import sys

import jax
import numpy as np
import pytest

import chainermn_tpu
from chainermn_tpu import global_except_hook as jax_hook
from conftest import load_example
from torch_comm_workers import shared_launch
from torch_rank_workers import few_threads, restore_excepthook  # noqa: F401
from torch_tp_workers import EXAMPLE_RUNS, tp_example_worker

ITERATIONS = 30
REL = 1e-4


def _jax_loss(n, flags, iterations, monkeypatch):
    """The JAX example's final loss on an n-device mesh (its communicator
    made over the first n CPU devices); its except hook is put back."""
    ex = load_example("tensor_parallel", "train_tp_transformer.py")
    make = chainermn_tpu.create_communicator
    monkeypatch.setattr(
        chainermn_tpu, "create_communicator",
        lambda name, **kw: make(name, devices=jax.devices("cpu")[:n], **kw))
    hook, installed = sys.excepthook, jax_hook._hook_installed
    try:
        return ex.main(["--iterations", str(iterations), *flags])
    finally:
        sys.excepthook, jax_hook._hook_installed = hook, installed
        monkeypatch.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: shared_launch(f"tp_example_worker{n}", tmp_path_factory,
                             tp_example_worker, n,
                             {"iterations": ITERATIONS}, timeout=180)
            for n in EXAMPLE_RUNS}


@pytest.mark.parametrize("n,run", [(n, name) for n, rs in
                                   EXAMPLE_RUNS.items() for name, _ in rs])
def test_twin_losses_match_the_jax_example(runs, n, run, monkeypatch):
    flags = dict(EXAMPLE_RUNS[n])[run]
    last = _jax_loss(n, flags, ITERATIONS, monkeypatch)
    for o in runs[n]:
        losses = o[run]
        assert len(losses) == ITERATIONS
        np.testing.assert_allclose(losses[-1], last, rtol=REL)
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("n", sorted(EXAMPLE_RUNS))
def test_every_rank_reports_the_same_losses(runs, n):
    for name, _ in EXAMPLE_RUNS[n]:
        for o in runs[n][1:]:
            np.testing.assert_array_equal(o[name], runs[n][0][name])
