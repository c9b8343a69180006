"""The port's twin of ``examples/transformer/train_transformer_lm.py``
runs end to end on the CPU at a tiny size."""

import math

import pytest

from chainermn_tpu_torch.examples.transformer import train_transformer_lm
from torch_rank_workers import restore_excepthook  # noqa: F401

TINY = ["--device", "cpu", "--num-layers", "1", "--d-model", "32",
        "--seq-len", "48", "--batchsize", "2", "--iterations", "2"]


@pytest.mark.parametrize("mode", [["--packed"], ["--packed", "--window", "9"],
                                  [], ["--window", "9", "--double-buffering"]],
                         ids=["packed", "packed-window", "plain",
                              "plain-window-db"])
def test_example_twin_trains_to_a_finite_loss(mode, capsys):
    metrics = train_transformer_lm.main(TINY + mode)
    assert math.isfinite(float(metrics["loss"]))
    out = capsys.readouterr().out
    assert "iter 2/2 loss=" in out
    assert ("done (packed)" if "--packed" in mode
            else "done (data-parallel)") in out


@pytest.mark.parametrize("flag", [["--sequence-parallel"], ["--local-sgd", "4"],
                                  ["--error-feedback"], ["--generate", "4"],
                                  ["--beam", "2"]])
def test_left_out_flags_exit_naming_their_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit):
        train_transformer_lm.main(TINY + flag)
    assert "ROADMAP" in capsys.readouterr().err
