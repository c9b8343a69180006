"""The port's reduction schedules (``chainermn_tpu_torch.parallel.
reduction_schedule``: ``SCHEDULES``, ``DEFAULT_BUCKET_BYTES``,
``bucket_partition``, ``reduce_tree``, ``OverlappedBucketReducer``) and the
optimizer's ``reduction_schedule=`` against the JAX package's.

``bucket_partition`` runs in this process against JAX's output. The rest
runs at 4 gloo ranks (``tests/torch_comm_workers.py::schedule_worker``,
one launch) against the JAX functions inside ``shard_map`` on the
4-device CPU mesh, on the 2 x 2 ``('inter', 'intra')`` layout and on the
flat one, with the default bucket and one that splits the leaves into
several buckets; the JAX ``OverlappedBucketReducer`` runs eagerly on the
stacked gradients. The stale-update loop of
``tests/test_reduction_schedule.py`` runs inside the worker against the
double-buffered optimizer.

Tolerances: fp32 wires rtol 1e-6 (atol 1e-6); bf16 one bf16 rounding of
the sum's magnitude (2^-7 of the largest |mean|); int8 within one code
of the stage-2 scale over n of JAX's (the shard's max-abs / 127 / n)
with at least 99% of the elements on the same code (2 ulp); the
optimizer after 3 SGD-momentum steps (lr 0.1): fp32 rtol 1e-5 (atol
1e-6), bf16 and int8 the per-step tolerance times lr times the momentum's
1 + 1.9 + 2.71; the stale-update loop bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import create_communicator as jax_comm
from chainermn_tpu import create_multi_node_optimizer as jax_mno
from chainermn_tpu.communicators.xla_communicator import (
    TwoDimensionalCommunicator as JaxTwoD,
)
from chainermn_tpu.parallel import reduction_schedule as JRS
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.parallel import reduction_schedule as RS
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import LEAVES, SMALL_BUCKET, run_once, schedule_worker
from torch_rank_workers import few_threads  # noqa: F401

N = 4
AX2 = ("inter", "intra")
TOL = dict(rtol=1e-6, atol=1e-6)
LR, MOMENTUM_SUM = 0.1, 1 + 1.9 + 2.71
WIRES = (None, "bfloat16", "int8")


def _inputs():
    rs = np.random.RandomState(5)
    out = {}
    for k, shape in LEAVES:
        out[f"g/{k}"] = rs.randn(N, *shape).astype(np.float32)
        out[f"p/{k}"] = rs.randn(*shape).astype(np.float32)
        out[f"gs/{k}"] = rs.randn(3, N, *shape).astype(np.float32)
    out["g/d"][2] *= 0.01
    out["stale"] = rs.randn(4, N, 6).astype(np.float32)
    return out


def _meshes():
    devs = np.array(jax.devices("cpu")[:N])
    return {"2x2": (Mesh(devs.reshape(2, 2), AX2), AX2),
            "flat": (Mesh(devs, ("data",)), ("data",))}


def _jax_reduce_tree(inputs, cname, sched, wire, bb):
    mesh, axes = _meshes()[cname]
    dt = None if wire is None else getattr(jnp, wire)

    def body(*gs):
        red = JRS.reduce_tree([g[0] for g in gs], schedule=sched, axes=axes,
                              compress_dtype=dt, bucket_bytes=bb)
        return tuple(v[None] for v in red)

    got = jax.jit(shard_map(body, mesh=mesh, in_specs=P(axes),
                            out_specs=P(axes), check_vma=False))(
        *[inputs[f"g/{k}"] for k, _ in LEAVES])
    return {k: np.asarray(v) for (k, _), v in zip(LEAVES, got)}


def _jax_optimizer(inputs, cname, sched, wire):
    mesh, axes = _meshes()[cname]
    comm = (JaxTwoD(mesh=mesh) if cname == "2x2"
            else jax_comm("naive", devices=list(mesh.devices.flat)))
    opt = jax_mno(optax.sgd(LR, momentum=0.9), comm,
                  allreduce_grad_dtype=None if wire is None
                  else getattr(jnp, wire), reduction_schedule=sched)
    params = {k: jnp.asarray(inputs[f"p/{k}"]) for k, _ in LEAVES}
    state = opt.init(params)
    sspec = opt.opt_state_spec()

    @jax.jit
    def step(params, state, grads):
        def body(params, state, grads):
            g = {k: v[0] for k, v in grads.items()}
            upd, state = opt.update(g, state, params)
            return optax.apply_updates(params, upd), state

        return shard_map(body, mesh=mesh, in_specs=(P(), sspec, P(axes)),
                         out_specs=(P(), sspec), check_vma=False)(
            params, state, grads)

    for s in range(3):
        grads = {k: jnp.asarray(inputs[f"gs/{k}"][s]) for k, _ in LEAVES}
        params, state = step(params, state, grads)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    outs = run_once("schedule_worker", lambda: run_distributed(
        schedule_worker, N, inputs, timeout=300), tmp_path_factory)
    return inputs, outs


# -- bucket_partition's edge contract ----------------------------------

PARTITIONS = [
    ([3, 0, 5, 2], 4, 16), ([0, 0], 4, 8), ([10], 4, 8), ([2, 2, 2, 2], 4, 16),
    ([1, 100, 1], 4, 8), ([5, 5, 5], 2, 20), ([7, 0, 0, 7], 4, 1 << 20),
    ([], 4, 8), ([4, 4, 4], 4, None),
]


@pytest.mark.parametrize("sizes,itemsize,bucket", PARTITIONS)
def test_bucket_partition_matches_jax(sizes, itemsize, bucket):
    idxs = list(range(len(sizes)))
    got = RS.bucket_partition(idxs, sizes, itemsize, bucket)
    assert got == JRS.bucket_partition(idxs, sizes, itemsize, bucket)
    assert all(b for b in got)  # never an empty bucket
    assert all(sizes[i] for b in got for i in b)  # zero-size skipped
    assert RS.SCHEDULES == JRS.SCHEDULES
    assert RS.DEFAULT_BUCKET_BYTES == JRS.DEFAULT_BUCKET_BYTES == 64 << 20


# -- reduce_tree ---------------------------------------------------------

def _assert_wire(got, want, wire, exact_mean, n_shards):
    if got.size == 0:
        return
    if wire is None:
        np.testing.assert_allclose(got, want, **TOL)
    elif wire == "bfloat16":
        scale = max(np.abs(exact_mean).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7 * scale)
    else:
        code = np.abs(exact_mean).max() * N / 127.0 / N * 1.01 + 1e-9
        diff = np.abs(got - want)
        assert (diff <= code).all(), (diff.max(), code)
        same = diff <= 2 * np.spacing(np.abs(want).astype(np.float32))
        assert np.mean(same) >= 0.99, np.mean(same)


@pytest.mark.parametrize("bb", [None, SMALL_BUCKET], ids=["one", "small"])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("sched", ["flat", "two_level"])
@pytest.mark.parametrize("cname", ["2x2", "flat"])
def test_reduce_tree_matches_jax(runs, cname, sched, wire, bb):
    inputs, outs = runs
    want = _jax_reduce_tree(inputs, cname, sched, wire, bb)
    n_shards = 2 if (cname == "2x2" and sched == "two_level") else N
    for r, o in enumerate(outs):
        for k, _ in LEAVES:
            got = o[f"rt/{cname}/{sched}/{wire}/{bb}/{k}"]
            assert got.shape == inputs[f"g/{k}"].shape[1:]
            _assert_wire(got, want[k][r], wire, inputs[f"g/{k}"].mean(0),
                         n_shards)
            np.testing.assert_array_equal(got, outs[0][
                f"rt/{cname}/{sched}/{wire}/{bb}/{k}"])


def test_overlapped_reducer_matches_jax_and_the_mean(runs):
    inputs, outs = runs
    jred = JRS.OverlappedBucketReducer(
        jax_comm("naive", devices=jax.devices("cpu")[:N]),
        bucket_bytes=SMALL_BUCKET, slices=3)
    jred.dispatch([jnp.asarray(inputs[f"g/{k}"]) for k, _ in LEAVES])
    want = jred.collect()
    for o in outs:
        assert bool(o["overlap/in_flight"])
        assert bool(o["overlap/double_raised"])
        assert int(o["overlap/buckets"]) == len(RS.bucket_partition(
            list(range(len(LEAVES))),
            [int(np.prod(s)) for _, s in LEAVES], 4, SMALL_BUCKET))
        for (k, _), w in zip(LEAVES, want):
            np.testing.assert_allclose(o[f"overlap/{k}"], np.asarray(w),
                                       **TOL)
            np.testing.assert_allclose(o[f"overlap/{k}"],
                                       inputs[f"g/{k}"].mean(0), **TOL)


# -- the optimizer's schedules ------------------------------------------

OPT_CASES = [("flat", None), ("flat", "int8"), ("two_level", None),
             ("two_level", "int8"), ("two_level", "bfloat16"),
             ("zero", None), ("zero", "bfloat16")]


@pytest.mark.parametrize("cname", ["2x2", "flat"])
@pytest.mark.parametrize("sched,wire", OPT_CASES)
def test_optimizer_schedule_follows_jax_over_three_steps(runs, sched, wire,
                                                         cname):
    inputs, outs = runs
    want = _jax_optimizer(inputs, cname, sched, wire)
    for o in outs:
        for k, _ in LEAVES:
            got = o[f"opt/{cname}/{sched}/{wire}/{k}"]
            g = np.abs(inputs[f"gs/{k}"]).max() if got.size else 0.0
            if wire is None:
                np.testing.assert_allclose(got, want[k], rtol=1e-5,
                                           atol=1e-6)
            else:
                per_step = g * (2 ** -7 if wire == "bfloat16" else 2 / 127)
                np.testing.assert_allclose(
                    got, want[k], rtol=0,
                    atol=LR * MOMENTUM_SUM * per_step * 1.01 + 1e-7)


def test_double_buffer_matches_the_stale_update_reference_model(runs):
    """tests/test_reduction_schedule.py's loop: step t applies the bank
    (step t-1's mean), then banks step t's; bit for bit."""
    _, outs = runs
    for o in outs:
        np.testing.assert_array_equal(o["stale/params"], o["stale/ref"])
        np.testing.assert_array_equal(o["stale/bank"], o["stale/last_mean"])


def test_schedule_refusals_as_jax():
    import torch

    comm = create_communicator("naive")
    p = [torch.zeros(3, requires_grad=True)]
    sgd = torch.optim.SGD(p, lr=0.1)
    with pytest.raises(ValueError, match="double_buffering"):
        create_multi_node_optimizer(sgd, comm, reduction_schedule="zero",
                                    double_buffering=True)
    with pytest.raises(ValueError, match="int8"):
        create_multi_node_optimizer(sgd, comm, reduction_schedule="zero",
                                    allreduce_grad_dtype="int8")
    with pytest.raises(ValueError, match="error_feedback"):
        create_multi_node_optimizer(sgd, comm, reduction_schedule="two_level",
                                    allreduce_grad_dtype="int8",
                                    error_feedback=True)
    with pytest.raises(ValueError, match="reduction_schedule"):
        create_multi_node_optimizer(sgd, comm, reduction_schedule="ring")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        create_multi_node_optimizer(sgd, comm, reduction_schedule="auto")
    with pytest.raises(ValueError, match="sharded_update"):
        create_multi_node_optimizer(
            sgd, comm, reduction_schedule="rs(data)>su>ag(data)")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        RS.resolve_schedule("cpu", 1 << 20, (4,))
    with pytest.raises(ValueError, match="structural"):
        RS.reduce_tree(p, schedule="zero", axes=comm)
