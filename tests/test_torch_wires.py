"""The port's multi-axis wires (``chainermn_tpu_torch.parallel.
collectives``: ``axes_size``/``axes_index``, the two-level and decomposed
all-reduces, the staged primitives, the int8 wires and their error-
feedback forms) against the JAX package's, on a 2 x 2 ``('inter',
'intra')`` layout: the same seeded inputs (stacked ``[4, ...]``, rank
``r`` taking row ``r``) through the JAX function inside ``shard_map``
on the 4-device CPU mesh and through the port at 4 gloo ranks
(``tests/torch_comm_workers.py::wires_worker``, one launch).

Tolerances: the fp32 wires rtol 1e-6 (atol 1e-6: a sum over 4 ranks may
round in another order); the broadcast tree exactly (it adds zeros);
the int8 wires at most one code of the stage-2 scale over n an element
against JAX, with at least 99% of the elements on the same code (equal
bit for bit but for the fp32 rounding of the dequantization, 2 ulp:
XLA may fold the division by n into the scale), and within
the wire's own bound of the exact mean (half a code of each stage's
scale); stage 1's round trip and the residuals as the int8 means, with
one code of the stage-1 scale; at n == 1 the int8 wire is the value
itself, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import collectives as JC
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import COUNTED, run_once, wires_worker
from torch_rank_workers import few_threads  # noqa: F401

N = 4
AX = ("inter", "intra")
TOL = dict(rtol=1e-6, atol=1e-6)
SHAPE = (5, 7)
SIZE = 35
INT8_EQUAL_SHARE = 0.99


def _inputs():
    rs = np.random.RandomState(0)
    x = rs.randn(N, *SHAPE).astype(np.float32)
    x[1] *= 0.01  # one rank far smaller: per-member scales matter
    res = (0.01 * rs.randn(N, JC.two_level_shard_len(SIZE, 2))
           ).astype(np.float32)
    ct = rs.randn(N, *SHAPE).astype(np.float32)
    return {"x": x, "res": res, "ct": ct}


def _srs(x):
    return JC.staged_reduce_scatter(x.reshape(-1), AX)


#: each JAX case, run as a program of its own (fused into one program,
#: XLA may round the int8 wire's divisions otherwise)
JAX_CASES = {
    "two_level": lambda x, r: JC.two_level_allreduce(x, "intra", "inter"),
    "two_level_sum": lambda x, r: JC.two_level_allreduce(
        x, "intra", "inter", op="sum"),
    "decomposed": lambda x, r: JC.decomposed_allreduce(x, AX),
    "decomposed_intra": lambda x, r: JC.decomposed_allreduce(x, ("intra",)),
    "staged_rs": lambda x, r: _srs(x),
    "staged_rs_intra": lambda x, r: JC.staged_reduce_scatter(
        x.reshape(-1), ("intra",)),
    "staged_ar": lambda x, r: JC.staged_allreduce(x, AX),
    "staged_ag": lambda x, r: JC.staged_allgather(_srs(x), AX, SIZE),
    "bcast_r2_root2": lambda x, r: JC.staged_broadcast(x, AX, radix=2,
                                                       root=2),
    "bcast_r3_root1": lambda x, r: JC.staged_broadcast(x, AX, radix=3,
                                                       root=1),
    "bcast_intra_root1": lambda x, r: JC.staged_broadcast(x, ("intra",),
                                                          root=1),
    "int8": lambda x, r: JC.int8_allreduce_mean(x, AX),
    "int8_intra": lambda x, r: JC.int8_allreduce_mean(x, ("intra",)),
    "int8_decomposed": lambda x, r: JC.int8_decomposed_allreduce_mean(x, AX),
    "int8_two_level": lambda x, r: JC.int8_two_level_allreduce_mean(
        x, "intra", "inter"),
    "int8_fb_mean": lambda x, r: JC.int8_allreduce_mean_with_feedback(
        x, AX)[0],
    "int8_fb_rt": lambda x, r: JC.int8_allreduce_mean_with_feedback(
        x, AX)[1],
    "int8_tl_fb_mean": lambda x, r: (
        JC.int8_two_level_allreduce_mean_with_feedback(
            x, r, "intra", "inter")[0]),
    "int8_tl_fb_res": lambda x, r: (
        JC.int8_two_level_allreduce_mean_with_feedback(
            x, r, "intra", "inter")[1]),
    "axes_size": lambda x, r: jnp.asarray(JC.axes_size(AX)),
    "axes_index": lambda x, r: JC.axes_index(AX),
    "axes_index_intra": lambda x, r: JC.axes_index(("intra",)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    mesh = Mesh(np.array(jax.devices("cpu")[:N]).reshape(2, 2), AX)
    ref = {}
    for name, fn in JAX_CASES.items():
        def body(x, res, fn=fn):
            return jnp.asarray(fn(x[0], res[0]))[None]

        ref[name] = np.asarray(jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P(AX), P(AX)), out_specs=P(AX),
            check_vma=False))(inputs["x"], inputs["res"]))
    outs = run_once("wires_worker", lambda: run_distributed(
        wires_worker, N, inputs, timeout=240), tmp_path_factory)
    return inputs, ref, outs


FP32 = ("two_level", "two_level_sum", "decomposed", "decomposed_intra",
        "staged_rs", "staged_rs_intra", "staged_ar", "staged_ag")
BCAST = ("bcast_r2_root2", "bcast_r3_root1", "bcast_intra_root1")
INT8 = ("int8", "int8_intra", "int8_decomposed", "int8_two_level",
        "int8_fb_mean", "int8_tl_fb_mean")


def _stage2_code(x, groups):
    """One code of the stage-2 scale over n, per element of the mean:
    the max-abs of each shard of the exact sum over ``groups`` members
    (the wire's stage 2 requantizes each shard against its own)."""
    s = x.sum(0).reshape(-1)
    n = x.shape[0]
    rows = np.pad(s, (0, -(-s.size // groups) * groups - s.size))
    rows = rows.reshape(groups, -1)
    scale = np.abs(rows).max(1, keepdims=True) / 127.0
    return (np.broadcast_to(scale, rows.shape).reshape(-1)[:s.size]
            .reshape(x.shape[1:]) / n * 1.01 + 1e-9)


def _assert_int8(got, want, code, magnitude=None):
    """Within one code everywhere; the same code (equal up to the fp32
    rounding of the dequantization, 2 ulp: XLA may fold the division by
    n into the scale) for at least INT8_EQUAL_SHARE of the elements. The
    ulp is ``want``'s own, or ``magnitude``'s where ``want`` is a
    difference of values of that size (a residual: the message less its
    round trip)."""
    diff = np.abs(got - want)
    assert (diff <= code).all(), (diff.max(), code.min())
    ref = np.abs(want if magnitude is None else magnitude)
    same = diff <= 2 * np.spacing(ref.astype(np.float32))
    assert np.mean(same) >= INT8_EQUAL_SHARE, np.mean(same)


@pytest.mark.parametrize("name", FP32)
def test_fp32_wires_match_jax(runs, name):
    _, ref, outs = runs
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[name], ref[name][r], **TOL)


@pytest.mark.parametrize("name", BCAST)
def test_staged_broadcast_tree_matches_jax_exactly(runs, name):
    _, ref, outs = runs
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[name], ref[name][r])


@pytest.mark.parametrize("name", INT8)
def test_int8_wires_within_one_code_of_jax(runs, name):
    inputs, ref, outs = runs
    x = inputs["x"]
    code = _stage2_code(x, 2 if name in ("int8_intra",) else N)
    if name in ("int8_two_level", "int8_decomposed", "int8_tl_fb_mean"):
        code = _stage2_code(x, 2)  # the shard crossing inter: 1/2 of it
    if name == "int8_intra":
        pairs = [x[[0, 1]], x[[0, 1]], x[[2, 3]], x[[2, 3]]]
    for r, o in enumerate(outs):
        c = _stage2_code(pairs[r], 2) if name == "int8_intra" else code
        _assert_int8(o[name], ref[name][r], c)
        np.testing.assert_array_equal(o[name], outs[0][name]
                                      if name != "int8_intra"
                                      else outs[r - r % 2][name])


@pytest.mark.parametrize("name", ["int8", "int8_decomposed"])
def test_int8_wire_within_its_bound_of_the_exact_mean(runs, name):
    """Two roundings: half a code of each member's stage-1 scale, summed
    over the members and divided by n, plus half a code of the stage-2
    scale over n."""
    inputs, _, outs = runs
    x = inputs["x"]
    exact = x.mean(0)
    stage1 = sum(np.abs(x[r]).max() / 127 / 2 for r in range(N)) / N
    stage2 = np.abs(x.sum(0)).max() / 127 / 2 / N
    assert np.abs(outs[0][name] - exact).max() <= (stage1 + stage2) * 1.01


def test_int8_feedback_forms_round_trip_and_residual(runs):
    """Stage 1's local round trip and the shard-level residual held as the
    int8 means are: within one code of the stage-1 scale of JAX's (the
    largest |message| over 127; the shard-level message is the intra
    pair's sum plus the residual), the same value for at least
    INT8_EQUAL_SHARE of the elements (the residual up to 2 ulp of the
    message's largest element: it is the message less its round trip). The residual is per rank, and a
    zero residual fails the comparison."""
    inputs, ref, outs = runs
    x, res = inputs["x"], inputs["res"]
    for r, o in enumerate(outs):
        code1 = np.full(SHAPE, np.abs(x[r]).max() / 127 * 1.01)
        _assert_int8(o["int8_fb_rt"], ref["int8_fb_rt"][r], code1)
        pair = x[r - r % 2] + x[r - r % 2 + 1]
        msg = np.abs(pair).max() + np.abs(res[r]).max()
        code_tl = np.full(res.shape[1:], msg / 127 * 1.01)
        got, want = o["int8_tl_fb_res"], ref["int8_tl_fb_res"][r]
        assert got.shape == (C.two_level_shard_len(SIZE, 2),)
        _assert_int8(got, want, code_tl, msg)
        with pytest.raises(AssertionError):
            _assert_int8(0 * got, want, code_tl, msg)
    assert not np.array_equal(outs[0]["int8_tl_fb_res"],
                              outs[1]["int8_tl_fb_res"])


def test_axes_size_and_index_match_jax(runs):
    _, ref, outs = runs
    for r, o in enumerate(outs):
        assert int(o["axes_size"]) == int(ref["axes_size"][r]) == N
        assert int(o["axes_index"]) == int(ref["axes_index"][r]) == r
        assert int(o["axes_index_intra"]) == int(ref["axes_index_intra"][r])


def test_merged_axes_without_their_product_raise(runs):
    """A collective over several axes runs as one call on their product
    group: over a plain tuple of the axis groups, which carries none, it
    raises, the tree broadcast too."""
    _, _, outs = runs
    for o in outs:
        for name in ("staged_ar", "staged_rs", "int8", "bcast"):
            assert bool(o[f"plain_raised/{name}"]), name


def test_calls_of_each_wire(runs):
    """One call a stage on the product group: the int8 wire is one all-to-all and three
    all-gathers (scales, codes, stage-2 scales); the two-level all-reduce
    a reduce-scatter, an all-reduce and an all-gather; the int8 two-level
    wire a reduce-scatter, an all-to-all and four all-gathers; the tree
    broadcast ceil(log2 4) = 2 rounds (1 + 2 pairs over the ranks)."""
    _, _, outs = runs
    idx = {k: i for i, k in enumerate(COUNTED)}
    for o in outs:
        assert list(o["count/int8"]) == [0, 0, 3, 1, 0]
        assert list(o["count/two_level"]) == [1, 1, 1, 0, 0]
        assert list(o["count/int8_two_level"]) == [0, 1, 4, 1, 0]
    assert sum(int(o["count/bcast_r2"][idx["batch_isend_irecv"]])
               for o in outs) == 2 + 4


@pytest.mark.parametrize("name", ["int8", "int8_two_level", "two_level"])
def test_straight_through_gradient_is_the_exact_mean(runs, name):
    inputs, _, outs = runs
    want = inputs["ct"].mean(0)
    for o in outs:
        np.testing.assert_allclose(o[f"grad/{name}"], want, **TOL)


def test_stage_one_codes_match_jax(runs):
    inputs, _, outs = runs
    for r, o in enumerate(outs):
        flat = inputs["x"][r].reshape(-1)
        rows = np.pad(flat, (0, 36 - SIZE)).reshape(N, 9)
        amax = jnp.max(jnp.abs(rows))
        scale = jnp.maximum(amax, 1e-30) / 127.0
        q = np.asarray(jnp.clip(jnp.round(rows / scale), -127, 127))
        assert np.abs(o["codes"] - q).max() <= 1
        assert np.mean(o["codes"] == q) >= INT8_EQUAL_SHARE
        np.testing.assert_allclose(float(o["scale"]), float(scale),
                                   rtol=1e-7)


def test_one_rank_int8_wire_is_the_value_itself(runs):
    inputs, _, outs = runs
    x = inputs["x"]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["n1/int8"], x[r])
        np.testing.assert_array_equal(o["n1/int8_rt"], x[r])
        pair = x[[r - r % 2, r - r % 2 + 1]]
        np.testing.assert_allclose(o["n1/tl_mean"], pair.mean(0), **TOL)
        np.testing.assert_array_equal(o["n1/tl_res"], 0 * o["n1/tl_res"])


@pytest.mark.parametrize("size,n", [(35, 2), (35, 4), (36, 4), (1, 8),
                                    (0, 2), (1 << 20, 3)])
def test_two_level_shard_len_matches_jax(size, n):
    assert C.two_level_shard_len(size, n) == JC.two_level_shard_len(size, n)


def test_tuned_wire_and_bucket_stay_left_for_the_registry():
    for name in C.LEFT_OUT:
        assert hasattr(JC, name)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
            getattr(C, name)(None, 4)
