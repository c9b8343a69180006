"""The port's twin of ``examples/transformer/train_transformer_lm.py``
runs end to end on the CPU at a tiny size."""

import math

import pytest

from chainermn_tpu_torch.examples.transformer import train_transformer_lm
from torch_rank_workers import (  # noqa: F401
    few_threads,
    restore_excepthook,
)

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


@pytest.mark.parametrize("flag", [
    ["--allreduce-grad-dtype", "auto"],
    ["--communicator", "two_dimensional", "--allreduce-grad-dtype", "auto"]])
def test_left_out_flags_exit_naming_their_roadmap_item(flag, capsys):
    with pytest.raises(SystemExit):
        train_transformer_lm.main(TINY + flag)
    assert "ROADMAP" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--generate", "5"],
                                   ["--generate", "5", "--beam", "3"]],
                         ids=["generate", "generate-beam"])
def test_generate_and_beam_decode_after_training(flags, capsys):
    """The JAX example's demo: an 8-token prompt of 2 rows, decoded to 13
    tokens (beam search first with ``--beam``), printed as it prints."""
    train_transformer_lm.main(TINY + flags)
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("generate:"))
    assert "prompt (2, 8) -> (2, 13)" in line
    assert ("beam_search (K=3): best scores" in out) == ("--beam" in flags)
    assert "done (data-parallel)" in out


@pytest.mark.parametrize("flag", [["--generate", "4"], ["--beam", "2"]])
def test_mlm_refuses_decoding_as_jax_does(flag, capsys):
    with pytest.raises(SystemExit):
        train_transformer_lm.main(TINY + ["--mlm"] + flag)
    assert "--mlm is an encoder" in capsys.readouterr().err
