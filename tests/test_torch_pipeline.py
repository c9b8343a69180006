"""The port's GPipe engines (``chainermn_tpu_torch.parallel.pipeline``:
plain, interleaved, rematerialised, heterogeneous) and mesh
(``parallel/mesh.py``) against the JAX package's, at 2 and 4 gloo ranks
against a 2- and 4-device CPU mesh, one launch per world size (rank
programs in ``tests/torch_pipeline_workers.py``).

Every case runs the loss ``mean((pipe(tanh(x @ w_in)) @ w_out - y)^2)``
with the embed ``w_in`` before and the head ``w_out`` after the
conveyor, on every rank in the port and through ``jax.grad`` from
outside ``shard_map`` in JAX; compared on every rank: the output, the
rank's stage gradients against its slice of JAX's stacked ones, and the
embed's and head's gradients. The counterparts of tests/test_pipeline.py
are cases here: values at 8 and 16 microbatches, gradients, batch
divisibility, interleaving at v 2 and 3, the bubble and the stacking
layout, remat against plain, and the heterogeneous engine's values,
gradients and conveyor-break error.

Tolerance: fp32, values rtol 1e-5 atol 1e-6, gradients rtol 1e-4 atol
1e-6 (tests/test_pipeline.py's); the two frameworks sum the products
and the microbatches in other orders. Rematerialised against plain: bit
for bit (the same ops on the same inputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from chainermn_tpu.parallel import mesh as jmesh
from chainermn_tpu.parallel import pipeline as jpl
from chainermn_tpu_torch.parallel import mesh as tmesh
from chainermn_tpu_torch.parallel import pipeline as tpl
from torch_comm_workers import shared_launch
from torch_pipeline_workers import (
    CALLS,
    GPIPE,
    HV,
    LOCAL_SEED,
    case,
    gpipe_worker,
    hetero_case,
    mesh_worker,
)
from torch_rank_workers import few_threads  # noqa: F401

SIZES = (2, 4)
VALUES = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: shared_launch(f"gpipe_worker{n}", tmp_path_factory,
                             gpipe_worker, n, timeout=240) for n in SIZES}


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("stage",))


def jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jstack(stages, n, v):
    trees = [{k: jnp.asarray(a) for k, a in s.items()} for s in stages]
    if v == 1:
        return jpl.stack_stage_params(trees)
    return jpl.stack_interleaved_stage_params(trees, n, v)


@functools.lru_cache(maxsize=None)
def jax_gpipe(n, tag):
    """JAX's output, loss and gradients of a GPipe case on an n-device
    mesh (stage grads in the stacked layout)."""
    m, v, remat, seed = GPIPE[tag]
    c = case(n * v, seed)
    fn = jpl.make_pipeline(jstage, _mesh(n), n_microbatches=m or n,
                           virtual_stages=v, remat_stages=remat)
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])

    def loss(stacked, w_in, w_out):
        h = fn(stacked, jnp.tanh(x @ w_in))
        return ((h @ w_out - y) ** 2).mean(), h

    (val, h), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        _jstack(c["stages"], n, v), jnp.asarray(c["w_in"]),
        jnp.asarray(c["w_out"]))
    return (np.asarray(h), float(val),
            {k: np.asarray(a) for k, a in g[0].items()},
            np.asarray(g[1]), np.asarray(g[2]))


CASES = [(n, tag) for n in SIZES for tag in GPIPE]


@pytest.mark.parametrize("n,tag", CASES)
def test_gpipe_values_match_jax(runs, n, tag):
    h, val, *_ = jax_gpipe(n, tag)
    for o in runs[n]:
        np.testing.assert_allclose(o[f"gpipe/{tag}/y"], h, **VALUES)
        np.testing.assert_allclose(o[f"gpipe/{tag}/loss"], val, **VALUES)


@pytest.mark.parametrize("n,tag", CASES)
def test_gpipe_grads_match_jax_on_every_rank(runs, n, tag):
    """Each rank's stage gradients (its ``[v, ...]`` chunks under
    interleaving) and, on every rank, the embed's and the head's: the
    global view's gradients of the one loss."""
    _, _, g_stages, g_in, g_out = jax_gpipe(n, tag)
    v = GPIPE[tag][1]
    for r, o in enumerate(runs[n]):
        for k, g in g_stages.items():
            want = g[r] if v == 1 else g[r * v:(r + 1) * v]
            np.testing.assert_allclose(o[f"gpipe/{tag}/g/{k}"], want, **GRADS)
        np.testing.assert_allclose(o[f"gpipe/{tag}/g/w_in"], g_in, **GRADS)
        np.testing.assert_allclose(o[f"gpipe/{tag}/g/w_out"], g_out, **GRADS)


@pytest.mark.parametrize("n", SIZES)
def test_remat_stages_matches_plain(runs, n):
    for o in runs[n]:
        for key in o:
            if key.startswith("gpipe/plain/") and "/calls/" not in key:
                np.testing.assert_array_equal(
                    o[key.replace("/plain/", "/remat/")], o[key], err_msg=key)


@pytest.mark.parametrize("n,tag", CASES)
def test_schedule_counts(runs, n, tag):
    """Ticks (``pipeline_total_ticks``), forward stage executions (``v *
    n_micro``: idle ticks run nothing), saved inputs (one an execution),
    and the calls: one transfer a tick each way, the output's broadcast
    from the last stage forward and the input cotangent's from stage 0
    backward, no all_reduce."""
    m, v, _, _ = GPIPE[tag]
    m = m or n
    ticks = jpl.pipeline_total_ticks(n, m, v)
    for o in runs[n]:
        np.testing.assert_array_equal(o[f"gpipe/{tag}/stats"],
                                      [ticks, v * m, v * m])
        want = dict(zip(CALLS, [ticks, 1, 0]))
        np.testing.assert_array_equal(o[f"gpipe/{tag}/calls/forward"],
                                      [want[k] for k in CALLS])
        np.testing.assert_array_equal(o[f"gpipe/{tag}/calls/backward"],
                                      [want[k] for k in CALLS])


@pytest.mark.parametrize("n", SIZES)
def test_local_keeps_the_inside_meaning(runs, n):
    """``pipeline_local`` sums the ranks' cotangents (n x the gradient of
    one replicated loss); ``unscale_replicated_grads`` restores it, equal
    to ``make_pipeline``'s and to JAX's."""
    c = case(n, LOCAL_SEED)
    fn = jpl.make_pipeline(jstage, _mesh(n))
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    g = jax.grad(lambda s: ((fn(s, x) - y) ** 2).mean())(
        _jstack(c["stages"], n, 1))
    for r, o in enumerate(runs[n]):
        np.testing.assert_allclose(o["local/make/g/w"], g["w"][r], **GRADS)
        np.testing.assert_allclose(o["local/unscaled/g/w"],
                                   o["local/make/g/w"], **GRADS)
        np.testing.assert_allclose(o["local/local/g/w"],
                                   n * o["local/make/g/w"], **GRADS)


@pytest.mark.parametrize("n", SIZES)
def test_no_grad_runs_the_same_forward(runs, n):
    c = case(n, LOCAL_SEED)
    fn = jpl.make_pipeline(jstage, _mesh(n))
    want = fn(_jstack(c["stages"], n, 1), jnp.asarray(c["x"]))
    for o in runs[n]:
        np.testing.assert_allclose(o["nograd/y"], want, **VALUES)


@pytest.mark.parametrize("n", SIZES)
def test_batch_divisibility_enforced(runs, n):
    with pytest.raises(ValueError, match="not divisible"):
        jpl.make_pipeline(jstage, _mesh(n), n_microbatches=7)(
            _jstack(case(n, 0)["stages"], n, 1), jnp.zeros((16, 8)))
    for o in runs[n]:
        assert "not divisible" in str(o["refused/divisibility"])
        assert "stack_interleaved_stage_params" in str(o["refused/virtual"])


def test_bubble_fraction_shrinks():
    n, m = 8, 32
    for v in (1, 2, 4):
        total = tpl.pipeline_total_ticks(n, m, v)
        assert total == jpl.pipeline_total_ticks(n, m, v) == v * m + n - 1
    assert tpl.pipeline_total_ticks(n, m, 4) / 4 < tpl.pipeline_total_ticks(
        n, m, 1)
    assert tpl.pipeline_total_ticks(4, 6, 2) == 2 * 4 * 2 + 3
    for n in range(1, 6):
        for m in range(1, 10):
            for v in (1, 2, 3):
                assert (tpl.pipeline_total_ticks(n, m, v)
                        == jpl.pipeline_total_ticks(n, m, v))


def test_stacking_layout_validates():
    import torch

    stages = [{"w": torch.full((2,), float(g))} for g in range(6)]
    with pytest.raises(ValueError, match="stage params"):
        tpl.stack_interleaved_stage_params(stages, 4, 2)
    got = tpl.stack_interleaved_stage_params(stages, 3, 2)["w"][:, 0]
    want = jpl.stack_interleaved_stage_params(
        [{"w": jnp.full((2,), float(g))} for g in range(6)], 3, 2)["w"][:, 0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tpl.stack_stage_params(stages)["w"]
    assert tuple(plain.shape) == (6, 2)


@pytest.mark.parametrize("jax_mod,port_mod", [(jpl, tpl), (jmesh, tmesh)],
                         ids=["pipeline", "mesh"])
def test_every_public_name_has_a_counterpart(jax_mod, port_mod):
    names = [n for n, f in vars(jax_mod).items()
             if not n.startswith("_") and callable(f)
             and getattr(f, "__module__", None) == jax_mod.__name__]
    assert names
    for n in names:
        assert callable(getattr(port_mod, n, None)), n
        assert n in port_mod.__all__, n


def test_pipe_plan_axis_is_the_jax_descriptor():
    assert tpl.pipe_plan_axis() == jpl.pipe_plan_axis()
    assert tpl.pipe_plan_axis("p") == jpl.pipe_plan_axis("p")


# ---------------------------------------------------------------------------
# heterogeneous stages
# ---------------------------------------------------------------------------

def _jhetero(n):
    def embed_fn(p, tok):
        return p["emb"][tok]

    def block_fn(p, h):
        return h + jnp.tanh(h @ p["w"] + p["b"])

    def head_fn(p, h):
        return h @ p["out"]

    return [embed_fn] + [block_fn] * (n - 2) + [head_fn]


def _jparams(c):
    return tuple({k: jnp.asarray(a) for k, a in p.items()}
                 for p in c["params"])


@pytest.mark.parametrize("n", SIZES)
def test_hetero_matches_jax(runs, n):
    c = hetero_case(n, seed=11)
    fn = jpl.make_pipeline_hetero(_jhetero(n), _mesh(n), n_microbatches=8)
    want = np.asarray(fn(_jparams(c), jnp.asarray(c["tok"])))
    for o in runs[n]:
        np.testing.assert_allclose(o["hetero/values"], want, **VALUES)


@pytest.mark.parametrize("n", SIZES)
def test_hetero_grads_match_jax_on_every_rank(runs, n):
    """Remat stages, cross-entropy over the banked logits: every stage's
    parameter gradients on every rank (the parameters are replicated)."""
    c = hetero_case(n, seed=12)
    fn = jpl.make_pipeline_hetero(_jhetero(n), _mesh(n), n_microbatches=8,
                                  remat_stages=True)
    lab = jnp.asarray(c["lab"])

    def xent(ps):
        logp = jax.nn.log_softmax(fn(ps, jnp.asarray(c["tok"])))
        return -jnp.mean(jnp.take_along_axis(logp, lab[..., None], -1))

    g = jax.grad(xent)(_jparams(c))
    for o in runs[n]:
        assert o["hetero/logits"].shape == (16, 4, HV)
        for s, p in enumerate(g):
            for k, a in p.items():
                np.testing.assert_allclose(o[f"hetero/g/{s}/{k}"],
                                           np.asarray(a), **GRADS)
        np.testing.assert_array_equal(o["hetero/stats"], [8 + n - 1, 8, 8])


@pytest.mark.parametrize("n", SIZES)
def test_hetero_refusals_come_before_any_transfer(runs, n):
    """A middle stage that widens the activation breaks the conveyor
    (JAX raises too), with no call made; a last stage that reduces a
    microbatch to a scalar cannot be reassembled."""
    for o in runs[n]:
        assert "reduce losses" in str(o["refused/bank"])
    if n < 3:
        return  # no middle stage
    fns = _jhetero(n)
    fns[1] = lambda p, h: jnp.concatenate([h, h], axis=-1)
    c = hetero_case(n, seed=11)
    with pytest.raises(ValueError, match="conveyor"):
        jpl.make_pipeline_hetero(fns, _mesh(n))(
            _jparams(c), jnp.zeros((16, 4), jnp.int32))
    for o in runs[n]:
        assert "breaks the conveyor" in str(o["refused/conveyor"])
        assert not o["refused/conveyor/calls"].any()


@pytest.mark.parametrize("n", SIZES)
def test_gloo_host_staging_keeps_values_and_grads(runs, n):
    """The transfer of a CUDA tensor over a gloo group goes through a host
    copy; forced on the CPU, a ring ``ppermute``'s values and gradients
    are the direct path's bit for bit."""
    for o in runs[n]:
        np.testing.assert_array_equal(o["staged1/y"], o["staged0/y"])
        np.testing.assert_array_equal(o["staged1/g"], o["staged0/g"])


# ---------------------------------------------------------------------------
# mesh.py
# ---------------------------------------------------------------------------

class TestBestMeshShape:
    """tests/test_plan.py::TestBestMeshShape, and the port against the
    JAX function on every n <= 64 over 1-4 dims."""

    def test_two_dim_unchanged(self):
        assert tmesh.best_mesh_shape(8, 2) == (4, 2)
        assert tmesh.best_mesh_shape(16, 2) == (4, 4)
        assert tmesh.best_mesh_shape(6, 2) == (3, 2)
        assert tmesh.best_mesh_shape(7, 2) == (7, 1)
        assert tmesh.best_mesh_shape(12, 2) == (4, 3)

    def test_n_dim_balanced_larger_first(self):
        assert tmesh.best_mesh_shape(8, 3) == (2, 2, 2)
        assert tmesh.best_mesh_shape(16, 3) == (4, 2, 2)
        assert tmesh.best_mesh_shape(12, 3) == (3, 2, 2)
        assert tmesh.best_mesh_shape(24, 4) == (3, 2, 2, 2)
        assert tmesh.best_mesh_shape(64, 3) == (4, 4, 4)
        assert tmesh.best_mesh_shape(7, 3) == (7, 1, 1)
        assert tmesh.best_mesh_shape(1, 3) == (1, 1, 1)

    def test_one_dim_and_errors(self):
        assert tmesh.best_mesh_shape(5, 1) == (5,)
        with pytest.raises(ValueError):
            tmesh.best_mesh_shape(8, 0)
        with pytest.raises(ValueError):
            tmesh.best_mesh_shape(0, 2)

    def test_covers_device_count(self):
        import math

        for n in (4, 8, 12, 30, 36):
            for k in (2, 3, 4):
                assert math.prod(tmesh.best_mesh_shape(n, k)) == n

    def test_equals_jax(self):
        for n in range(1, 65):
            for k in (1, 2, 3, 4):
                assert (tmesh.best_mesh_shape(n, k)
                        == jmesh.best_mesh_shape(n, k)), (n, k)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return shared_launch("mesh_worker4", tmp_path_factory, mesh_worker, 4,
                         timeout=120)


def test_make_mesh_at_four_ranks(mesh_runs):
    """The JAX rule's shapes, the axis names, each axis group's ranks laid
    out as the JAX mesh lays out device ids, the refusal, and the
    topology view."""
    devs = jax.devices("cpu")[:4]
    for axes, given in ((("data",), None), (("data", "stage"), None),
                        (("data", "stage", "model"), None),
                        (("data", "stage"), (1, 4))):
        jm = jmesh.make_mesh(axes, given, devices=devs)
        ids = np.vectorize(lambda d: devs.index(d))(jm.devices)
        key = "x".join(axes) + ("" if given is None else "/given")
        for r, o in enumerate(mesh_runs):
            np.testing.assert_array_equal(o[f"{key}/shape"], ids.shape)
            assert tuple(o[f"{key}/names"]) == axes
            pos = np.argwhere(ids == r)[0]
            for a, name in enumerate(axes):
                line = np.moveaxis(ids, a, -1)[
                    tuple(np.delete(pos, a))]
                np.testing.assert_array_equal(o[f"{key}/group/{name}"],
                                              line)
    for r, o in enumerate(mesh_runs):
        assert "does not cover 4 ranks" in str(o["refused"])
        # size, rank, inter size/rank, intra size/rank, data, stage
        np.testing.assert_array_equal(o["topology"],
                                      [4, r, 4, r, 4, r, 2, 2])
        np.testing.assert_array_equal(o["topology/bare"], [1, 0])
    with pytest.raises(ValueError, match="does not cover"):
        jmesh.make_mesh(("data",), (3,), devices=devs)
