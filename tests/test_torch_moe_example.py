"""The MoE example twin (``chainermn_tpu_torch.examples.moe.
train_moe_mlp``) against the JAX example (``examples/moe/
train_moe_mlp.py``) at 2 and 4 gloo ranks against a 2- and 4-device CPU
mesh, top-1 and top-2 routing, with the JAX test's batch 64 and width 32
(``tests/torch_moe_workers.py::twin_worker``, one launch per world
size): the twin starts from the JAX example's own initial weights
(``run(..., params=)``), and the same batches, routing and Adam give the
final loss the JAX example prints and the accuracy it returns; every rank
reports the same losses. The twin's own draws (``init_weights``, by the
port's ``prng``) equal ``jax.random``'s to a few ulps, and a convergence
run like ``test_moe_example_converges`` (150 iterations, batch 128,
width 32, 2 ranks) reaches accuracy 0.9.

Tolerance: the loss within half a unit of the printed 4th decimal plus
1e-4 relative (the frameworks sum in other orders); the accuracy within
one example of 64.
"""

import re
import sys

import jax
import numpy as np
import pytest

import chainermn_tpu
from chainermn_tpu import global_except_hook as jax_hook
from chainermn_tpu.parallel.moe import make_expert_params
from chainermn_tpu_torch.examples.moe import train_moe_mlp
from conftest import load_example
from torch_comm_workers import shared_launch
from torch_moe_workers import TWIN_FLAGS, twin_worker
from torch_rank_workers import (  # noqa: F401
    few_threads,
    restore_excepthook,
)

SIZES = (2, 4)
ITERATIONS = 8
BATCH = 64
WIDTH = 32


def _jax_weights(n, width):
    """The JAX example's initial draws (its main's code)."""
    W = width

    def expert_init(rng):
        k1, k2 = jax.random.split(rng)
        return {"w1": jax.random.normal(k1, (W, 2 * W)) / np.sqrt(W),
                "w2": jax.random.normal(k2, (2 * W, W)) / np.sqrt(2 * W)}

    dense = {"w_in": jax.random.normal(jax.random.key(0), (20, W)) * 0.3,
             "router": jax.random.normal(jax.random.key(1), (W, n)) * 0.1,
             "w_out": jax.random.normal(jax.random.key(3), (W, 10)) * 0.1}
    experts = make_expert_params(expert_init, jax.random.key(2), n)
    return (jax.tree.map(np.asarray, dense),
            jax.tree.map(np.asarray, experts))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for n in SIZES:
        dense, experts = _jax_weights(n, WIDTH)
        inputs = {"iterations": ITERATIONS,
                  **{f"dense/{k}": v for k, v in dense.items()},
                  **{f"experts/{k}": v for k, v in experts.items()}}
        out[n] = shared_launch(f"moe_twin_worker{n}", tmp_path_factory,
                               twin_worker, n, inputs, timeout=240)
    return out


def _jax_run(n, topk, capsys, monkeypatch):
    """The JAX example on an n-device mesh: (printed final loss, returned
    accuracy); its except hook is put back."""
    ex = load_example("moe", "train_moe_mlp.py")
    make = chainermn_tpu.create_communicator
    monkeypatch.setattr(
        chainermn_tpu, "create_communicator",
        lambda name, **kw: make(name, devices=jax.devices("cpu")[:n], **kw))
    hook, installed = sys.excepthook, jax_hook._hook_installed
    capsys.readouterr()
    try:
        acc = ex.main(["--iterations", str(ITERATIONS), "--topk", str(topk),
                       "--dispatch-impl", "sort", *TWIN_FLAGS])
    finally:
        sys.excepthook, jax_hook._hook_installed = hook, installed
        monkeypatch.undo()
    final = re.search(r"final: loss=([0-9.]+) acc=([0-9.]+)",
                      capsys.readouterr().out)
    return float(final.group(1)), acc


@pytest.mark.parametrize("n,topk", [(n, k) for n in SIZES for k in (1, 2)])
def test_twin_matches_the_jax_example(runs, n, topk, capsys, monkeypatch):
    loss, acc = _jax_run(n, topk, capsys, monkeypatch)
    for o in runs[n]:
        losses = o[f"k{topk}/losses"]
        assert len(losses) == ITERATIONS and np.isfinite(losses).all()
        assert abs(losses[-1] - loss) <= 5e-5 + 1e-4 * abs(loss), (
            losses[-1], loss)
        assert abs(o[f"k{topk}/accs"][-1] - acc) <= 1 / BATCH + 1e-9
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("n", SIZES)
def test_every_rank_reports_the_same_losses(runs, n):
    for k in (1, 2):
        for o in runs[n][1:]:
            np.testing.assert_array_equal(o[f"k{k}/losses"],
                                          runs[n][0][f"k{k}/losses"])
            np.testing.assert_array_equal(o[f"k{k}/accs"],
                                          runs[n][0][f"k{k}/accs"])


@pytest.mark.parametrize("n", SIZES)
def test_twin_draws_the_jax_weights(n):
    want_d, want_e = _jax_weights(n, WIDTH)
    got_d, got_e = train_moe_mlp.init_weights(n, WIDTH)
    for got, want in ((got_d, want_d), (got_e, want_e)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_twin_converges(runs):
    """tests/test_moe.py::test_moe_example_converges at 2 ranks."""
    for o in runs[2]:
        accs, losses = o["converge/accs"], o["converge/losses"]
        assert np.isfinite(losses).all()
        assert accs[-1] > 0.9, accs[-1]
        assert accs[-1] > accs[0]


def test_auto_dispatch_exits_naming_item_8():
    with pytest.raises(SystemExit, match="queue 8"):
        train_moe_mlp.main(["--device", "cpu", "--dispatch-impl", "auto"])
