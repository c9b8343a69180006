"""The Transformer twin's ``--sequence-parallel`` mode
(``chainermn_tpu_torch.examples.transformer.train_transformer_lm``, the
JAX example's long-context mode) at 2 gloo ranks: one sequence sharded
over the ranks, attention through the ring or, with ``--window``, the
sliding window; the losses are finite, fall, and are the same on both
ranks (the fp32 means over the ranks), also over a process group given
in place of the communicator's. The ring and the window
themselves are held to the JAX package in
tests/test_torch_sequence_parallel.py."""

import numpy as np
import pytest

from torch_comm_workers import shared_launch
from torch_rank_workers import few_threads  # noqa: F401

ARGS = ["--device", "cpu", "--sequence-parallel", "--num-layers", "2",
        "--d-model", "32", "--seq-len", "64", "--iterations", "6",
        "--lr", "3e-3"]


def _twin_worker(inputs):
    from chainermn_tpu_torch.examples.transformer import (
        train_transformer_lm,
    )
    from torch_rank_workers import kept_excepthook

    import torch.distributed as dist

    out = {}
    with kept_excepthook():
        for name, extra in (("ring", []), ("window", ["--window", "24"])):
            m = train_transformer_lm.main(ARGS + extra)
            out[name] = m["losses"].numpy()
        # over a process group given in place of the communicator's
        m = train_transformer_lm.main(ARGS, group=dist.group.WORLD)
        out["ring_group"] = m["losses"].numpy()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_launch("seq_twin_worker", tmp_path_factory, _twin_worker,
                         2, timeout=240)


@pytest.mark.parametrize("mode", ["ring", "window"])
def test_sequence_parallel_twin_trains(ranks, mode):
    losses = ranks[0][mode]
    assert losses.shape == (6,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    np.testing.assert_array_equal(ranks[1][mode], losses)


def test_sequence_parallel_twin_over_a_given_group(ranks):
    np.testing.assert_array_equal(ranks[0]["ring_group"], ranks[0]["ring"])
