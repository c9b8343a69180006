"""The port's dataset scatter, iterators and object calls against the JAX
package's.

- ``scatter_dataset`` shards for n in {1, 2, 3, 4}, both ``shuffle``
  values and ``force_equal_length``: the port's rank ``r`` of ``n`` must
  get exactly the indices of the JAX call with ``size=n, rank=r``, first
  in this process through the ``rank``/``size`` overrides, then on n
  real gloo ranks (2 and 4) where ``comm.rank`` decides;
- the synchronized iterator's batches over 2 epochs, the multi-node
  iterator's broadcast batches, the object calls, the evaluator's
  reductions and ``AllreducePersistent`` on the same ranks;
- the launcher itself: a rank that raises fails the call with its
  traceback at once, and a rank that hangs is killed at the deadline.

Everything here is exact: indices and batches are integers.
"""

import time

import jax
import numpy as np
import pytest

import chainermn_tpu
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.datasets import (
    SubDataset,
    create_empty_dataset,
    scatter_dataset,
)
from chainermn_tpu_torch.iterators import (
    create_multi_node_iterator,
    create_synchronized_iterator,
)
from chainermn_tpu_torch.testing import (
    assert_distributed_equals_single,
    run_distributed,
)
from torch_comm_workers import shared_launch
from torch_rank_workers import (
    datasets_worker,
    failing_worker,
    hanging_worker,
    few_threads,  # noqa: F401
)

N_ITEMS = 23
BATCH = 2


def _jax_comm(n):
    return chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:n])


def _jax_shard(n, r, **kw):
    return chainermn_tpu.scatter_dataset(list(range(N_ITEMS)), _jax_comm(n),
                                         rank=r, size=n, **kw).indices


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ranks(request, tmp_path_factory):
    n = request.param
    return n, shared_launch(f"datasets_worker{n}", tmp_path_factory,
                            datasets_worker, n,
                            {"n_items": N_ITEMS, "batch": BATCH})


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("shuffle,force", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_shards_equal_jax_by_override(n, shuffle, force):
    comm = create_communicator("naive")
    for length in (N_ITEMS, 3, 0):
        data = list(range(length))
        for r in range(n):
            kw = dict(shuffle=shuffle, seed=5 if shuffle else None,
                      force_equal_length=force)
            got = scatter_dataset(data, comm, rank=r, size=n, **kw)
            want = chainermn_tpu.scatter_dataset(data, _jax_comm(1), rank=r,
                                                 size=n, **kw)
            np.testing.assert_array_equal(got.indices, want.indices)
            assert list(got) == list(want)


def test_shards_on_real_ranks_equal_jax(ranks):
    n, outs = ranks
    for shuffle in (False, True):
        for force in (False, True):
            for r, out in enumerate(outs):
                want = _jax_shard(n, r, shuffle=shuffle,
                                  seed=7 if shuffle else None,
                                  force_equal_length=force)
                np.testing.assert_array_equal(
                    out[f"shard/{int(shuffle)}{int(force)}"], want)
    # an unseeded shuffle is drawn once and broadcast: the shards tile
    # one permutation, identically on every rank
    for out in outs:
        np.testing.assert_array_equal(out["unseeded"], outs[0]["unseeded"])
        assert sorted(out["unseeded"]) == list(range(N_ITEMS))


def test_synchronized_iterator_two_epochs_equal_jax(ranks):
    n, outs = ranks
    data = list(range(N_ITEMS))
    for r, out in enumerate(outs):
        shard = chainermn_tpu.scatter_dataset(
            data, _jax_comm(n), shuffle=True, seed=42, rank=r, size=n)
        it = chainermn_tpu.create_synchronized_iterator(
            shard, BATCH, _jax_comm(n), seed=1)
        want = [b for _ in range(2) for b in it]
        np.testing.assert_array_equal(out["sync"], np.array(want))


def test_multi_node_iterator_broadcasts_the_masters_batches(ranks):
    n, outs = ranks
    it = chainermn_tpu.create_multi_node_iterator(
        list(range(N_ITEMS)), 4, _jax_comm(1), seed=3)
    want = np.array([b for b in it])
    for out in outs:
        np.testing.assert_array_equal(out["multi_node"], want)


def test_object_calls_and_reductions(ranks):
    n, outs = ranks
    for r, out in enumerate(outs):
        assert int(out["host_size"]) == n
        assert int(out["bcast"]) == 10 * (n - 1) + 1
        np.testing.assert_array_equal(
            out["gather"], [3 * i for i in range(n)] if r == 0 else [-1])
        np.testing.assert_array_equal(out["allgather"],
                                      [i * i for i in range(n)])
        assert float(out["allreduce_a"]) == sum(range(n))
        np.testing.assert_array_equal(out["allreduce_b"],
                                      [sum(range(n)), n])
        # weighted by each rank's 'n' = rank + 1
        want = sum(i * (i + 1) for i in range(n)) / sum(i + 1
                                                        for i in range(n))
        np.testing.assert_allclose(float(out["eval_mean"]), want,
                                   rtol=1e-12)
        assert float(out["eval_sum"]) == sum(i + 1 for i in range(n))
        np.testing.assert_allclose(out["persistent"], [(n - 1) / 2] * 3,
                                   rtol=1e-6)


def test_size_one_iterators_equal_jax():
    comm = create_communicator("naive")
    data = list(range(N_ITEMS))
    for make, jmake, kw in (
            (create_synchronized_iterator,
             chainermn_tpu.create_synchronized_iterator, dict(seed=4)),
            (create_multi_node_iterator,
             chainermn_tpu.create_multi_node_iterator, dict(seed=4)),
            (create_synchronized_iterator,
             chainermn_tpu.create_synchronized_iterator,
             dict(seed=0, shuffle=False))):
        it, jit = make(data, 5, comm, **kw), jmake(data, 5, _jax_comm(1),
                                                   **kw)
        for _ in range(3):  # epochs
            assert [b for b in it] == [b for b in jit]


def test_sub_and_empty_datasets():
    sub = SubDataset(list("abcdef"), np.array([4, 0, 2]))
    assert len(sub) == 3 and sub[0] == "e" and sub[1:] == ["a", "c"]
    assert list(sub) == ["e", "a", "c"]
    empty = create_empty_dataset(range(4))
    assert len(empty) == 4 and list(empty) == [None] * 4
    assert empty[1:3] == [None, None] and empty[-1] is None
    with pytest.raises(IndexError):
        empty[4]


def test_launcher_reports_a_failing_rank_without_waiting_for_its_peer():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_distributed(failing_worker, 2, timeout=120)
    assert time.monotonic() - t0 < 60


def test_launcher_kills_a_hung_rank_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="still running after 8"):
        run_distributed(hanging_worker, 2, {"x": np.ones(2)}, timeout=8)
    assert time.monotonic() - t0 < 30


def test_assert_distributed_equals_single_at_one_rank():
    comm = create_communicator("naive")
    batch = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert_distributed_equals_single(
        lambda c, b: {"s": comm.allreduce_obj(b.sum(0))},
        lambda b: {"s": b.sum(0)}, comm, batch)
    with pytest.raises(AssertionError):
        assert_distributed_equals_single(
            lambda c, b: {"s": b.sum(0) + 1}, lambda b: {"s": b.sum(0)},
            comm, batch)
