"""The port's example twins of ``examples/mnist/train_mnist.py`` and
``examples/imagenet/train_imagenet.py`` run end to end on the CPU, at
world size 1 in this process and at 2 gloo ranks through the launcher.

The MNIST twin trains 60 iterations (per-rank batch 64, a quarter of
the example's, to keep the CPU suite short) on the example's synthetic
blobs; its final validation accuracy must pass 0.9. With ``--checkpoint``
it stops at 20 iterations and a second run to 40 resumes from the
snapshot of iteration 20, through each backend (``npz``, and ``orbax``,
the JAX example's name, which stores through
``torch.distributed.checkpoint``).
The ImageNet twin trains ResNet18 at image 32, batch 2, for 3
iterations to a finite loss. The options the twins leave out exit naming
their ROADMAP item.
"""

import math
import sys

import numpy as np
import pytest
from conftest import load_example

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.examples.imagenet import train_imagenet
from chainermn_tpu_torch.examples.mnist import train_mnist
from chainermn_tpu_torch.testing import run_distributed
from torch_rank_workers import (  # noqa: F401
    examples_worker,
    few_threads,
    kept_excepthook,
    restore_excepthook,
)

MNIST_ITERATIONS = 60
MNIST_BATCH = 64
MNIST = ["--device", "cpu", "--batchsize", str(MNIST_BATCH)]
IMAGENET_TINY = ["--device", "cpu", "--arch", "resnet18", "--image-size",
                 "32", "--batchsize", "2", "--iterations", "3"]


@pytest.mark.parametrize("flags", [[], ["--double-buffering", "--prefetch",
                                        "2", "--allreduce-grad-dtype",
                                        "bfloat16"]],
                         ids=["plain", "db-prefetch-bf16"])
def test_mnist_twin_learns_the_blobs(flags, capsys):
    final = train_mnist.main(MNIST + ["--iterations", str(MNIST_ITERATIONS),
                                      *flags])
    assert final["val_acc"] > 0.9, final
    out = capsys.readouterr().out
    assert f"iter {MNIST_ITERATIONS}/{MNIST_ITERATIONS}" in out
    assert "final:" in out


def test_the_twins_except_hook_is_put_back(capsys):
    before = sys.excepthook
    with kept_excepthook():
        train_mnist.main(MNIST + ["--iterations", "2"])
        # the twin installs the port's hook for the rest of the process
        assert sys.excepthook is global_except_hook._global_except_hook
    assert sys.excepthook is before


def test_imagenet_twin_trains_resnet18_to_a_finite_loss(capsys):
    metrics = train_imagenet.main(IMAGENET_TINY)
    assert math.isfinite(float(metrics["loss"]))
    out = capsys.readouterr().out
    assert "iter 3/3 loss=" in out and "images/sec" in out


def test_imagenet_twin_draws_the_jax_examples_batches():
    """Rank r of n takes its slice of the global batch the JAX example
    draws from ``np.random.default_rng(0)``."""
    jax_example = load_example("imagenet", "train_imagenet.py")
    want = jax_example.synthetic_batch(np.random.default_rng(0), 6, 8)
    for rank in range(3):
        got = train_imagenet.local_batch(np.random.default_rng(0), 2, 8,
                                         rank, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[2 * rank:2 * rank + 2])


def test_both_twins_at_two_ranks():
    outs = run_distributed(examples_worker, 2,
                           {"mnist_iterations": MNIST_ITERATIONS,
                            "mnist_batch": MNIST_BATCH})
    for out in outs:
        assert float(out["mnist/val_acc"]) > 0.9
        assert math.isfinite(float(out["imagenet/loss"]))
    # the metrics are rank-means: every rank reports the same
    assert float(outs[0]["mnist/val_acc"]) == float(outs[1]["mnist/val_acc"])
    assert float(outs[0]["imagenet/loss"]) == float(outs[1]["imagenet/loss"])


@pytest.mark.parametrize("flag", [
    ["--reduction-schedule", "auto"],
    ["--allreduce-grad-dtype", "auto"]])
def test_mnist_left_out_flags_exit_naming_their_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit):
        train_mnist.main(MNIST + flag)
    assert "ROADMAP queue" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--arch", "alex"], ["--arch", "vit_s16"], ["--native-loader", "x.bin"],
    ["--train-root", "data"], ["--remat"],
    ["--allreduce-grad-dtype", "auto"]])
def test_imagenet_left_out_flags_exit_naming_their_roadmap_item(flag,
                                                                capsys):
    with pytest.raises(SystemExit):
        train_imagenet.main(IMAGENET_TINY + flag)
    assert "ROADMAP queue" in capsys.readouterr().err


def test_imagenet_space_to_depth_stem_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 3.6"):
        train_imagenet.main(IMAGENET_TINY + ["--stem", "space_to_depth"])


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_mnist_twin_saves_and_resumes(backend, tmp_path, capsys):
    flags = MNIST + ["--checkpoint", str(tmp_path), "--checkpoint-interval",
                     "10", "--checkpoint-backend", backend]
    train_mnist.main(flags + ["--iterations", "20"])
    assert "resumed from" not in capsys.readouterr().out
    final = train_mnist.main(flags + ["--iterations", "40"])
    out = capsys.readouterr().out
    assert "resumed from iteration 20" in out
    assert "iter 20/20" in out  # the 20 iterations left, counted from 0
    assert final["val_acc"] > 0.9, final
    if backend == "npz":
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "snapshot_mnist_0_30.npz", "snapshot_mnist_0_40.npz"]
    else:
        assert sorted(p.name for p in (tmp_path / "mnist_dcp_rank0")
                      .iterdir()) == ["30", "40"]
