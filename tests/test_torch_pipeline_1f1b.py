"""The port's 1F1B engine (``chainermn_tpu_torch.parallel.pipeline.
make_pipeline_1f1b``) and the engines' compositions with data and tensor
parallelism, against the JAX package's: 1F1B at 2 and 4 gloo ranks
against a 2- and 4-device CPU mesh; dp x pp over a (data 2, stage n/2)
mesh at 4 and 8 ranks, and dp x pp x tp over (data 2, stage 2, model 2)
at 8, against JAX meshes of the same layout (rank programs in
``tests/torch_pipeline_workers.py``, one launch per world size and
file).

Compared on every rank: the loss, the rank's stage gradients against its
slice of JAX's stacked ones (its tensor-parallel shard at 3-D), and the
head's and the input's gradients. The counterparts of
tests/test_pipeline.py are cases here: loss and grads at 8 and 16
microbatches, one microbatch, a loss with a pole at zero, a trainable
head with input grads, the memory claim, the one-op-a-tick schedule, dp
x pp for GPipe and 1F1B, dp x pp x tp, and the heterogeneous engine with
a batch axis. Where JAX compares the compiled programs' temp memory, the
port counts the stage inputs each engine holds for its backward: 1F1B's
ring holds ``n - s`` on stage ``s`` (at most ``n``); GPipe with remat
holds one an execution, ``n_micro`` (the JAX scan saves one a tick,
``n_micro + n - 1``). Where JAX finds its ``lax.switch`` in the HLO, the
port traces each tick: at most one stage call and exactly two transfers.

Tolerance: fp32, values rtol 1e-5 atol 1e-6, gradients rtol 1e-4 atol
1e-6, 3-D gradients atol 1e-5 (tests/test_pipeline.py's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from chainermn_tpu.parallel import pipeline as jpl
from torch_comm_workers import shared_launch
from torch_pipeline_workers import (
    D,
    MEM_MICRO,
    ONE_F_ONE_B,
    T_MICRO,
    case,
    composed_worker,
    hetero_case,
    onef1b_worker,
    pole_targets,
    tp_case,
    tp_data,
)
from torch_rank_workers import few_threads  # noqa: F401

SIZES = (2, 4)
VALUES = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: shared_launch(f"onef1b_worker{n}", tmp_path_factory,
                             onef1b_worker, n, timeout=240)
            for n in SIZES}


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    return {n: shared_launch(f"composed_worker{n}", tmp_path_factory,
                             composed_worker, n, timeout=240)
            for n in (4, 8)}


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("stage",))


def jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stacked(c):
    return jpl.stack_stage_params(
        [{k: jnp.asarray(a) for k, a in s.items()} for s in c["stages"]])


def _mse_lg():
    return jax.value_and_grad(lambda y, t: ((y - t) ** 2).mean())


def _check_stage_grads(o, prefix, g, r):
    for k, a in g.items():
        np.testing.assert_allclose(o[f"{prefix}/g/{k}"], np.asarray(a)[r],
                                   **GRADS)


@functools.lru_cache(maxsize=None)
def jax_1f1b(n, tag):
    m, batch = ONE_F_ONE_B[tag]
    c = case(n, seed=20 + m, batch=batch)
    fn = jpl.make_pipeline_1f1b(jstage, _mse_lg(), _mesh(n),
                                n_microbatches=m)
    loss, g = fn(_stacked(c), jnp.asarray(c["x"]), jnp.asarray(c["y"]))
    return float(loss), g


@pytest.mark.parametrize("n,tag", [(n, t) for n in SIZES
                                   for t in ONE_F_ONE_B])
def test_1f1b_loss_and_grads_match_jax(runs, n, tag):
    loss, g = jax_1f1b(n, tag)
    for r, o in enumerate(runs[n]):
        np.testing.assert_allclose(o[f"1f1b/{tag}/loss"], loss, **VALUES)
        _check_stage_grads(o, f"1f1b/{tag}", g, r)


@pytest.mark.parametrize("n,tag", [(n, t) for n in SIZES
                                   for t in ONE_F_ONE_B])
def test_1f1b_one_op_a_tick(runs, n, tag):
    """Ticks ``2(n + n_micro - 1)``; each tick at most one stage call (a
    forward, or a backward's recompute) and exactly two transfers; each
    stage runs ``n_micro`` forwards and ``n_micro`` recomputes; the
    calls: two transfers a tick and the loss's broadcast."""
    m, _ = ONE_F_ONE_B[tag]
    ticks = 2 * (n + m - 1)
    for r, o in enumerate(runs[n]):
        trace = list(o[f"1f1b/{tag}/trace"])
        assert trace.count("transfer") == 2 * ticks
        # walk the ticks: [op?] transfer transfer
        i, ticks_seen = 0, 0
        while i < len(trace):
            ops = 0
            while trace[i] == "op":
                ops += 1
                i += 1
            assert ops <= 1, (r, ticks_seen, trace)
            assert trace[i:i + 2] == ["transfer", "transfer"]
            i += 2
            ticks_seen += 1
        assert ticks_seen == ticks
        saved = o[f"1f1b/{tag}/stats"][3]
        np.testing.assert_array_equal(
            o[f"1f1b/{tag}/stats"], [ticks, m, m, saved])
        assert saved == min(n - r, m)
        np.testing.assert_array_equal(o[f"1f1b/{tag}/calls"],
                                      [2 * ticks, 1, 0])


@pytest.mark.parametrize("n", SIZES)
def test_1f1b_loss_with_pole_at_zero_stays_finite(runs, n):
    def pos_stage(p, x):
        return jax.nn.sigmoid(x @ p["w"] + p["b"]) + 0.5

    c = case(n, seed=13, batch=16)
    fn = jpl.make_pipeline_1f1b(
        pos_stage, jax.value_and_grad(lambda y, t: -(t * jnp.log(y)).mean()),
        _mesh(n), n_microbatches=8)
    loss, g = fn(_stacked(c), jnp.asarray(c["x"]),
                 jnp.asarray(pole_targets(15, 16)))
    for r, o in enumerate(runs[n]):
        assert np.isfinite(o["pole/loss"])
        np.testing.assert_allclose(o["pole/loss"], float(loss), **VALUES)
        _check_stage_grads(o, "pole", g, r)


def _head_lg():
    def head_loss(w, y, t):
        return (((y @ w) - t) ** 2).mean()

    def lg(w, y, t):
        loss, (dw, dy) = jax.value_and_grad(head_loss, argnums=(0, 1))(
            w, y, t)
        return loss, (dw, dy)
    return lg


@pytest.mark.parametrize("n", SIZES)
def test_1f1b_trainable_head_and_input_grads(runs, n):
    """The head's and the input's gradients on every rank."""
    c = case(n, seed=21, batch=16)
    fn = jpl.make_pipeline_1f1b(jstage, _head_lg(), _mesh(n),
                                n_microbatches=8)
    loss, g, hg, xg = fn(_stacked(c), jnp.asarray(c["x"]),
                         jnp.asarray(c["y"]), jnp.asarray(0.6 * c["w_out"]),
                         collect_input_grads=True)
    for r, o in enumerate(runs[n]):
        np.testing.assert_allclose(o["head/loss"], float(loss), **VALUES)
        _check_stage_grads(o, "head", g, r)
        np.testing.assert_allclose(o["head/head"], np.asarray(hg), **GRADS)
        np.testing.assert_allclose(o["head/x"], np.asarray(xg), **GRADS)


@pytest.mark.parametrize("n", SIZES)
def test_1f1b_saves_fewer_inputs_than_gpipe(runs, n):
    """At 32 microbatches: 1F1B holds at most ``n`` stage inputs on any
    stage, GPipe with remat ``n_micro`` on every stage (the JAX scan's
    ``n_micro + n - 1``), so 1F1B's is well below 0.8 of GPipe's."""
    for r, o in enumerate(runs[n]):
        assert int(o["memory/gpipe"]) == MEM_MICRO
        assert int(o["memory/gpipe"]) <= MEM_MICRO + n - 1
        assert int(o["memory/1f1b"]) == n - r
        assert int(o["memory/1f1b"]) < 0.8 * int(o["memory/gpipe"])


# ---------------------------------------------------------------------------
# dp x pp, dp x pp x tp
# ---------------------------------------------------------------------------

def _mesh2d(size):
    devs = np.array(jax.devices("cpu")[:size]).reshape(2, size // 2)
    return Mesh(devs, ("data", "stage"))


def _rank_coords(size):
    return [(r // (size // 2), r % (size // 2)) for r in range(size)]


@pytest.mark.parametrize("size", (4, 8))
def test_gpipe_values_with_batch_axis(composed, size):
    n = size // 2
    c = case(n, seed=40, batch=32)
    fn = jpl.make_pipeline(jstage, _mesh2d(size), axis_name="stage",
                           n_microbatches=4, batch_axis="data")
    want = np.asarray(fn(_stacked(c), jnp.asarray(c["x"])))
    for o, (d, s) in zip(composed[size], _rank_coords(size)):
        np.testing.assert_allclose(o["dp/gpipe/y"],
                                   want[d * 16:(d + 1) * 16], **VALUES)


@pytest.mark.parametrize("size", (4, 8))
def test_1f1b_dp_grads_match_jax(composed, size):
    n = size // 2
    c = case(n, seed=42, batch=32)
    fn = jpl.make_pipeline_1f1b(jstage, _mse_lg(), _mesh2d(size),
                                axis_name="stage", n_microbatches=8,
                                batch_axis="data")
    loss, g = fn(_stacked(c), jnp.asarray(c["x"]), jnp.asarray(c["y"]))
    for o, (d, s) in zip(composed[size], _rank_coords(size)):
        np.testing.assert_allclose(o["dp/1f1b/loss"], float(loss), **VALUES)
        _check_stage_grads(o, "dp/1f1b", g, s)


@pytest.mark.parametrize("size", (4, 8))
def test_1f1b_dp_head_and_input_grads_match_jax(composed, size):
    """With ``batch_axis``: the head's gradients averaged over the data
    axis, the input's per shard scaled by ``1/n_data``."""
    n = size // 2
    c = case(n, seed=42, batch=32)
    fn = jpl.make_pipeline_1f1b(jstage, _head_lg(), _mesh2d(size),
                                axis_name="stage", n_microbatches=8,
                                batch_axis="data")
    loss, g, hg, xg = fn(_stacked(c), jnp.asarray(c["x"]),
                         jnp.asarray(c["y"]), jnp.asarray(0.6 * c["w_out"]),
                         collect_input_grads=True)
    xg = np.asarray(xg)
    for o, (d, s) in zip(composed[size], _rank_coords(size)):
        np.testing.assert_allclose(o["dp/head/loss"], float(loss), **VALUES)
        np.testing.assert_allclose(o["dp/head/g/w"], np.asarray(g["w"])[s],
                                   **GRADS)
        np.testing.assert_allclose(o["dp/head/head"], np.asarray(hg),
                                   **GRADS)
        np.testing.assert_allclose(o["dp/head/x"], xg[d * 16:(d + 1) * 16],
                                   **GRADS)


@pytest.mark.parametrize("size", (4, 8))
def test_hetero_pipeline_with_batch_axis(composed, size):
    n = size // 2

    def embed_fn(p, tok):
        return p["emb"][tok]

    def block_fn(p, h):
        return h + jnp.tanh(h @ p["w"] + p["b"])

    def head_fn(p, h):
        return h @ p["out"]

    hc = hetero_case(n, seed=50)
    fn = jpl.make_pipeline_hetero(
        [embed_fn] + [block_fn] * (n - 2) + [head_fn], _mesh2d(size),
        axis_name="stage", n_microbatches=4, batch_axis="data")
    want = np.asarray(fn(tuple({k: jnp.asarray(a) for k, a in p.items()}
                               for p in hc["params"]),
                         jnp.asarray(hc["tok"])))
    for o, (d, s) in zip(composed[size], _rank_coords(size)):
        np.testing.assert_allclose(o["dp/hetero/y"], want[d * 8:(d + 1) * 8],
                                   **VALUES)


def test_3d_composition_dp_pp_tp(composed):
    """dp 2 x pp 2 x tp 2: 1F1B over 'stage', each stage's MLP
    hidden-sharded over 'model' (the port's ``tp_mlp``), the batch over
    'data'; loss and each rank's weight shards' gradients against the
    JAX program of tests/test_pipeline.py::test_3d_composition_dp_pp_tp
    and the sequential computation."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from chainermn_tpu.parallel.tensor import stack_tp_params, tp_mlp

    devs = np.array(jax.devices("cpu")[:8]).reshape(2, 2, 2)
    mesh = Mesh(devs, ("data", "stage", "model"))
    fulls = [{k: jnp.asarray(a) for k, a in p.items()} for p in tp_case()]
    stacked = jpl.stack_stage_params([
        {"w1": stack_tp_params(p["w1"], 2, 1),
         "w2": stack_tp_params(p["w2"], 2, 0)} for p in fulls])

    def stage_fn(p, x):
        return x + tp_mlp(x, p["w1"], None, p["w2"], None, axis_name="model")

    lg = _mse_lg()

    def local(sp, x, t):
        params = jax.tree.map(lambda leaf: leaf[0, 0], sp)
        xm = x.reshape((T_MICRO, x.shape[0] // T_MICRO, D))
        tm = t.reshape((T_MICRO, t.shape[0] // T_MICRO, D))
        loss, grads = jpl.pipeline_1f1b_local(stage_fn, lg, params, xm, tm,
                                              "stage")
        loss = jax.lax.pmean(loss, "data")
        grads = jax.lax.pmean(grads, "data")
        return loss, jax.tree.map(lambda g: g[None, None], grads)

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P("stage", "model"), P("data"),
                                    P("data")),
        out_specs=(P(), P("stage", "model")), check_vma=False))
    x, t = (jnp.asarray(a) for a in tp_data())
    loss, grads = fn(stacked, x, t)

    def seq_loss(fs):
        out = x
        for p in fs:
            out = out + jax.nn.gelu(out @ p["w1"]) @ p["w2"]
        return ((out - t) ** 2).mean()

    ref_loss = seq_loss(fulls)
    g1, g2 = np.asarray(grads["w1"]), np.asarray(grads["w2"])
    for r, o in enumerate(composed[8]):
        d, s, m = (int(v) for v in o["3d/coords"])
        assert (d, s, m) == (r // 4, (r // 2) % 2, r % 2)
        np.testing.assert_allclose(o["3d/loss"], float(loss), **VALUES)
        np.testing.assert_allclose(o["3d/loss"], float(ref_loss), rtol=1e-5)
        np.testing.assert_allclose(o["3d/g/w1"], g1[s, m], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(o["3d/g/w2"], g2[s, m], rtol=1e-4,
                                   atol=1e-5)
