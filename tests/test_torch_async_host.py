"""The port's ``AsyncHostGradReducer`` (``chainermn_tpu_torch.parallel.
async_host``) at 4 gloo ranks (the 2 x 2 launch of
``tests/torch_composition_workers.py::worker4``, shared with
``tests/test_torch_composition_ranks.py``) against the JAX package's.

The staleness-1 loop over 5 steps: ``exchange`` returns None at step 0
and step t-1's mean after, ``flush`` the last one, ``in_flight`` while
a reduction runs; every mean bitwise equal to ``reduce_sync`` of the same
gradients on the same rank, and to the JAX reducer's (its host plane
stubbed by the four ranks' gradients, summed in rank order as
``allreduce_obj`` sums them) within fp32 summation-order error (4 units
in the last place of the sum of the magnitudes over 4). No speed gate:
the JAX package's overlap test is unsteady under load.
"""

import numpy as np
import pytest

from chainermn_tpu.parallel.async_host import (
    AsyncHostGradReducer as JaxReducer,
)
from chainermn_tpu_torch.parallel.async_host import AsyncHostGradReducer
from torch_composition_workers import ASYNC_STEPS, inputs4, launch4
from torch_rank_workers import few_threads  # noqa: F401

N = 4
KEYS = "uv"


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    inputs = inputs4()
    return inputs, launch4(inputs, tmp_path_factory)


class _StubHost:
    """The JAX reducer's host plane at rank ``rank`` of 4: the ranks'
    gradients of the current call, reduced in rank order."""

    size = N

    def __init__(self, inputs, rank):
        self.inputs, self.rank, self.calls = inputs, rank, 0

    def allreduce_obj(self, obj, op):
        s = self.calls
        self.calls += 1
        items = [[self.inputs[f"async/{k}"][s % ASYNC_STEPS, r]
                  for k in KEYS] for r in range(N)]
        items[self.rank] = obj
        out = items[0]
        for item in items[1:]:
            out = op(out, item)
        return out


class _StubComm:
    def __init__(self, host):
        self.host = host


def _jax_means(inputs, rank):
    red = JaxReducer(_StubComm(_StubHost(inputs, rank)))
    return [red.reduce_sync([inputs[f"async/{k}"][s, rank] for k in KEYS])
            for s in range(ASYNC_STEPS)]


def _tol(inputs, s, k):
    mag = np.abs(inputs[f"async/{k}"][s]).sum(0) / N
    return 4 * np.finfo(np.float32).eps * mag


def test_staleness_one_means_equal_reduce_sync_bitwise(ranks4):
    _, outs = ranks4
    for o in outs:
        assert bool(o["async/none0"])
        for s in range(ASYNC_STEPS):
            assert bool(o[f"async/in_flight{s}"])
        for s in range(1, ASYNC_STEPS):
            for k in KEYS:
                np.testing.assert_array_equal(o[f"async/stale{s}/{k}"],
                                              o[f"async/sync{s - 1}/{k}"])
        for k in KEYS:
            np.testing.assert_array_equal(
                o[f"async/flush/{k}"], o[f"async/sync{ASYNC_STEPS - 1}/{k}"])
        assert bool(o["async/drained"])


def test_means_follow_jax_within_summation_order(ranks4):
    inputs, outs = ranks4
    for r, o in enumerate(outs):
        want = _jax_means(inputs, r)
        for s in range(ASYNC_STEPS):
            for i, k in enumerate(KEYS):
                got = o[f"async/sync{s}/{k}"]
                assert got.dtype == want[s][i].dtype == np.float32
                assert np.all(np.abs(got - want[s][i])
                              <= _tol(inputs, s, k)), (r, s, k)
                # every rank holds the same mean
                np.testing.assert_array_equal(got,
                                              outs[0][f"async/sync{s}/{k}"])


def test_average_false_is_the_sum(ranks4):
    inputs, outs = ranks4
    total = inputs["async/u"][0].sum(0)
    tol = 4 * np.finfo(np.float32).eps * np.abs(inputs["async/u"][0]).sum(0)
    for o in outs:
        assert np.all(np.abs(o["async/sum0"] - total) <= tol)


def test_one_rank_exchange_flush_and_refusals():
    import torch

    from chainermn_tpu_torch.communicators import create_communicator

    comm = create_communicator("naive")
    red = AsyncHostGradReducer(comm, simulated_dcn_latency_s=0.01)
    assert red.flush() is None and not red.in_flight
    g = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    assert red.exchange(g) is None
    g["w"] += 100.0  # the snapshot was taken before the thread started
    got = red.exchange(g)
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    with pytest.raises(RuntimeError, match="in flight"):
        red._submit(g)
    assert torch.equal(red.flush()["w"], g["w"])
