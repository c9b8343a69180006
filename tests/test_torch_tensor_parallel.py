"""The port's tensor-parallel layers (``chainermn_tpu_torch.parallel.
tensor``) against the JAX package's, case for case with
``tests/test_tensor_parallel.py``: the MLP, the column layer gathered,
``tp_slice`` with the row layer, attention (causal and not), the f/g
adjoint pairs alone, tp x dp, the head-count refusal and the sharding
helpers.

The JAX side runs inside ``shard_map`` on an n-device ``'model'`` mesh
(the tp x dp case on a 2 x 2 ``('data', 'model')`` mesh), the port at n
gloo ranks (``tests/torch_cross_rank_workers.py::tp_worker``, one launch
per world size, 2 and 4), each rank with its shard of the same seeded
weights. Compared: values and every gradient (the shards' per rank).

The JAX test that counts the all-reduces in the compiled MLP has no
torch analog; the ``torch.distributed`` calls of one ``tp_mlp`` forward
and backward are counted instead: one all-reduce each.

Tolerances: 1e-6 absolute and relative in fp32, except where a case
says why not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import tensor as JT
from chainermn_tpu_torch.parallel import tensor as T
from torch_comm_workers import shared_launch
from torch_cross_rank_workers import DIST_CALLS, tp_worker
from torch_rank_workers import few_threads  # noqa: F401

SIZES = (2, 4)
TOL = dict(rtol=1e-6, atol=1e-6)
#: attention's softmax over scores summed in another order: 1e-5
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)
AX = "model"


def _rand(rs, *shape, scale=0.3):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _smap(mesh, fn, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _jax_side(n, rs):
    """The inputs of every case and the JAX results."""
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), (AX,))
    inputs, want = {}, {}

    # tp_mlp, loss sum(y ** 2), grads inside shard_map (the JAX test)
    d, d_ff, b = 6, 16, 4
    x, w1, b1 = _rand(rs, b, d), _rand(rs, d, d_ff), _rand(rs, d_ff)
    w2, b2 = _rand(rs, d_ff, d), _rand(rs, d, scale=0.1)
    w1s, b1s = JT.stack_tp_params(w1, n, 1), JT.stack_tp_params(b1, n, 0)
    w2s = JT.stack_tp_params(w2, n, 0)
    inputs.update({"mlp/x": x, "mlp/w1s": np.asarray(w1s),
                   "mlp/b1s": np.asarray(b1s), "mlp/w2s": np.asarray(w2s),
                   "mlp/b2": b2})

    def mlp_step(w1l, b1l, w2l, b2, x):
        def loss(w1l, b1l, w2l, b2, x):
            return jnp.sum(JT.tp_mlp(x, w1l, b1l, w2l, b2,
                                     axis_name=AX) ** 2)

        l, g = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(
            w1l[0], b1l[0], w2l[0], b2, x)
        return l, (g[0][None], g[1][None], g[2][None], g[3][None],
                   g[4][None])

    l, g = _smap(mesh, mlp_step, (P(AX), P(AX), P(AX), P(), P()),
                 (P(), (P(AX),) * 5))(w1s, b1s, w2s, b2, x)
    want["mlp/loss"] = np.asarray(l)
    for key, v in zip(("w1", "b1", "w2", "b2", "x"), g):
        want[f"mlp/g/{key}"] = np.asarray(v)

    # column layer, gather_output: y and grads of sum(y ** 2)
    d, d_out, b = 4, 16, 3
    x, w, bias = _rand(rs, b, d), _rand(rs, d, d_out), _rand(rs, d_out)
    ws, bs = JT.stack_tp_params(w, n, 1), JT.stack_tp_params(bias, n, 0)
    inputs.update({"col/x": x, "col/ws": np.asarray(ws),
                   "col/bs": np.asarray(bs)})

    def col_step(x, wl, bl):
        def loss(x, wl, bl):
            y = JT.column_parallel_dense(x, wl, bl, axis_name=AX,
                                         gather_output=True)
            return jnp.sum(y ** 2), y

        (_, y), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(x, wl[0], bl[0])
        return y[None], g[0][None], g[1][None], g[2][None]

    y, gx, gw, gb = _smap(mesh, col_step, (P(), P(AX), P(AX)),
                          (P(AX),) * 4)(x, ws, bs)
    want.update({"col/y": np.asarray(y), "col/g/x": np.asarray(gx),
                 "col/g/w": np.asarray(gw), "col/g/b": np.asarray(gb)})

    # tp_slice + row layer over replicated full weights
    d_in, d_out, b = 16, 5, 3
    x, w = _rand(rs, b, d_in), _rand(rs, d_in, d_out)
    inputs.update({"slice/x": x, "slice/w": w})

    def slice_step(x, w):
        def loss(x, w):
            y = JT.row_parallel_dense(JT.tp_slice(x, AX, 1),
                                      JT.tp_slice(w, AX, 0), axis_name=AX)
            return jnp.sum(y ** 2), y

        (_, y), g = jax.value_and_grad(loss, argnums=(0, 1),
                                       has_aux=True)(x, w)
        return y[None], g[0][None], g[1][None]

    y, gx, gw = _smap(mesh, slice_step, (P(), P()), (P(AX),) * 3)(x, w)
    want.update({"slice/y": np.asarray(y), "slice/g/x": np.asarray(gx),
                 "slice/g/w": np.asarray(gw)})

    # tp_attention, causal and not
    b, t, d_model, n_heads = 2, 6, 16, 8
    x = _rand(rs, b, t, d_model)
    wq, wk, wv, wo = (_rand(rs, d_model, d_model) for _ in range(4))
    stacks = [JT.stack_tp_params(v, n, 1) for v in (wq, wk, wv)]
    stacks.append(JT.stack_tp_params(wo, n, 0))
    inputs.update({"attn/x": x, "attn/n_heads": np.array(n_heads)})
    for key, s in zip(("wq", "wk", "wv", "wo"), stacks):
        inputs[f"attn/{key}s"] = np.asarray(s)
    for causal in (True, False):
        def attn_step(x, *wl, causal=causal):
            def loss(x, *ws):
                y = JT.tp_attention(x, *ws, axis_name=AX, n_heads=n_heads,
                                    causal=causal)
                return jnp.sum(y ** 2), y

            (_, y), g = jax.value_and_grad(
                loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
                    x, *(w[0] for w in wl))
            return (y[None],) + tuple(v[None] for v in g)

        res = _smap(mesh, attn_step, (P(),) + (P(AX),) * 4,
                    (P(AX),) * 6)(x, *stacks)
        tag = f"attn{int(causal)}"
        want[f"{tag}/y"] = np.asarray(res[0])
        for key, v in zip(("x", "wq", "wk", "wv", "wo"), res[1:]):
            want[f"{tag}/g/{key}"] = np.asarray(v)

    # the f/g pairs alone, per rank: v [n, 2, 3] (gather along dim 0)
    v = _rand(rs, n, 2, 3)
    c = _rand(rs, n, 2, 3)
    cg = _rand(rs, n, 2 * n, 3)
    inputs.update({"fg/v": v, "fg/c": c, "fg/cg": cg})
    for name, fn, cc in (
            ("copy", lambda t: JT.copy_to_tp(t, AX), c),
            ("reduce", lambda t: JT.reduce_from_tp(t, AX), c),
            ("gather", lambda t: JT.gather_from_tp(t, AX, 0), cg)):
        def fg_step(vl, cl, fn=fn):
            y, vjp = jax.vjp(fn, vl[0])
            return y[None], vjp(cl[0])[0][None]

        y, g = _smap(mesh, fg_step, (P(AX), P(AX)), (P(AX), P(AX)))(v, cc)
        want[f"fg/{name}/y"], want[f"fg/{name}/g"] = (np.asarray(y),
                                                      np.asarray(g))

    if n == 4:  # dp(2) x tp(2), the JAX test's pattern on a 2 x 2 mesh
        mesh2 = Mesh(np.array(jax.devices("cpu")[:4]).reshape(2, 2),
                     ("data", AX))
        d, d_ff, batch = 6, 16, 8
        x, w1, w2 = _rand(rs, batch, d), _rand(rs, d, d_ff), _rand(rs, d_ff,
                                                                   d)
        w1s, w2s = JT.stack_tp_params(w1, 2, 1), JT.stack_tp_params(w2, 2, 0)
        inputs.update({"dp/x": x, "dp/w1s": np.asarray(w1s),
                       "dp/w2s": np.asarray(w2s)})

        def dp_step(w1l, w2l, xl):
            def loss(w1l, w2l):
                y = JT.tp_mlp(xl, w1l, None, w2l, None, axis_name=AX)
                return jnp.mean(y ** 2)

            l, g = jax.value_and_grad(loss, argnums=(0, 1))(w1l[0], w2l[0])
            l = jax.lax.pmean(l, "data")
            g = jax.lax.pmean(g, "data")
            return l, g[0][None], g[1][None]

        l, g1, g2 = _smap(mesh2, dp_step, (P(AX), P(AX), P("data")),
                          (P(), P(AX), P(AX)))(w1s, w2s, x)
        want.update({"dp/loss": np.asarray(l), "dp/g1": np.asarray(g1),
                     "dp/g2": np.asarray(g2)})
    return inputs, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    res = {}
    for n in SIZES:
        inputs, want = _jax_side(n, np.random.RandomState(20 + n))
        res[n] = (shared_launch(f"tp_worker{n}", tmp_path_factory, tp_worker,
                                n, inputs, timeout=120), want)
    return res


def _stack(outs, key):
    return np.stack([o[key] for o in outs])


CASES = {
    # key, whether each rank holds its own value (a shard or a partial
    # gradient) or the replicated one, and the tolerance
    "mlp/g/w1": ("shard", TOL), "mlp/g/b1": ("shard", TOL),
    "mlp/g/w2": ("shard", TOL), "mlp/g/b2": ("shard", TOL),
    "mlp/g/x": ("shard", TOL),
    "col/y": ("shard", TOL), "col/g/x": ("shard", TOL),
    "col/g/w": ("shard", TOL), "col/g/b": ("shard", TOL),
    "slice/y": ("shard", TOL), "slice/g/x": ("shard", TOL),
    "slice/g/w": ("shard", TOL),
    **{f"attn{c}/{k}": ("shard", ATTN_TOL) for c in (0, 1)
       for k in ("y", "g/x", "g/wq", "g/wk", "g/wv", "g/wo")},
    **{f"fg/{f}/{k}": ("shard", TOL) for f in ("copy", "reduce", "gather")
       for k in ("y", "g")},
}


@pytest.mark.parametrize("key", sorted(CASES))
@pytest.mark.parametrize("n", SIZES)
def test_values_and_gradients_match_jax(runs, n, key):
    outs, want = runs[n]
    _, tol = CASES[key]
    np.testing.assert_allclose(_stack(outs, key), want[key], **tol)


@pytest.mark.parametrize("n", SIZES)
def test_tp_mlp_loss_matches_jax(runs, n):
    outs, want = runs[n]
    for o in outs:
        np.testing.assert_allclose(o["mlp/loss"], want["mlp/loss"], **TOL)


@pytest.mark.parametrize("n", SIZES)
def test_tp_mlp_one_all_reduce_each_way(runs, n):
    """One column -> row MLP: exactly one all-reduce forward and one
    backward, and no other ``torch.distributed`` call (more would mean
    the activation was gathered)."""
    outs, _ = runs[n]
    for o in outs:
        for way in ("forward", "backward"):
            calls = {k: int(o[f"calls/{way}/{k}"]) for k in DIST_CALLS}
            assert calls == {**dict.fromkeys(DIST_CALLS, 0),
                             "all_reduce": 1}, (way, calls)


@pytest.mark.parametrize("n", SIZES)
def test_tp_attention_head_divisibility(runs, n):
    outs, _ = runs[n]
    assert all(bool(o["attn/heads_refused"]) for o in outs)


def test_tp_composes_with_data_parallelism(runs):
    """dp(2) x tp(2) at 4 ranks: the model groups {0, 1} and {2, 3}, the
    data groups {0, 2} and {1, 3}; the loss and the shards' gradients,
    averaged over the data groups, equal the JAX 2 x 2 mesh's."""
    outs, want = runs[4]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["dp/loss"][0], want["dp/loss"], **TOL)
        np.testing.assert_allclose(o["dp/g1"], want["dp/g1"][r % 2], **TOL)
        np.testing.assert_allclose(o["dp/g2"], want["dp/g2"][r % 2], **TOL)


@pytest.mark.parametrize("n", (1, 2, 4))
def test_sharding_helpers_match_jax(n):
    rs = np.random.RandomState(n)
    w = rs.randn(6, 8).astype(np.float32)
    np.testing.assert_array_equal(
        T.stack_tp_params(torch.tensor(w), n, 1).numpy(),
        np.asarray(JT.stack_tp_params(w, n, 1)))
    hq, hkv, dh = 8, 4, 3
    qkv = rs.randn(5, (hq + 2 * hkv) * dh).astype(np.float32)
    np.testing.assert_array_equal(
        T.shard_qkv_columns(torch.tensor(qkv), hq, hkv, dh, n).numpy(),
        np.asarray(JT.shard_qkv_columns(qkv, hq, hkv, dh, n)))


def test_sharding_helpers_refuse_uneven_splits():
    with pytest.raises(ValueError, match="divisible"):
        T.stack_tp_params(torch.zeros(6, 5), 2, 1)
    with pytest.raises(ValueError, match="divisible"):
        T.shard_qkv_columns(torch.zeros(4, 18), 3, 3, 2, 2)
