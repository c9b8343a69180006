"""The port's expert parallelism (``chainermn_tpu_torch.parallel.moe``,
the plan's ``expert`` axis and ``moe_layer``) against the JAX package's,
case for case with tests/test_moe.py.

In this process, on the same numpy-seeded inputs: the routers and
``route_slots`` (k 1 and 2), the bf16 slot bookkeeping, underflow and
the caller's ``-inf`` padding, ``load_balancing_loss``, both dispatch
impls in values, dtypes and gradients, the capacity rule, the ``'auto'``
refusals and ``make_expert_params`` against ``jax.random``'s draws.

At 8 gloo ranks (``tests/torch_moe_workers.py::moe_worker``, one launch):
``moe_layer_local`` at one and two experts a rank, top-1 and top-2,
capacity 0.5 and no-drop, both impls, with its stats, against JAX's
``moe_layer_local`` under ``shard_map`` on the 8-device CPU mesh and
against a one-device evaluation of the same routing through JAX's own
functions (whose gradient is the global loss's); capacity 0 with its
overflow residual; the aux loss over sharded logits; bf16 parity of the
impls; and the plans ``{'expert': 8}``, ``{'expert': 4, 'data': 2}`` and
``{'expert': 4, 'model': 2}`` through the real train step against the
one-device JAX reference (tests/test_moe.py's), with ``describe``, the
decision record and the refusals. The JAX HLO pins become counts of
``torch.distributed`` calls against their rule: two all-to-alls a MoE
layer forward and two backward, nothing permuted.

Tolerances: values rtol 1e-4 (atol 1e-6), as JAX's own tests hold
them; gradients rtol 1e-4, atol 2e-6 (tighter than the SGD delta's 2e-3
/ 2e-5); the plans' parameters after SGD rtol 2e-4 / atol 1e-5 and the
losses rtol 1e-4, tests/test_moe.py's own; bf16 impl parity 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from chainermn_tpu.parallel import moe as jmoe
from chainermn_tpu.parallel.plan_specs import CANONICAL_AXES as J_AXES
from chainermn_tpu_torch.parallel import moe as tmoe
from chainermn_tpu_torch.parallel.plan_specs import CANONICAL_AXES
from torch_comm_workers import shared_launch
from torch_moe_workers import (
    AUX,
    CALLS,
    LAYER_CASES,
    LR,
    case_key,
    moe_worker,
)
from torch_rank_workers import few_threads  # noqa: F401

N = 8
D = 16
VALUE_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-5)
A2A = CALLS.index("all_to_all_single")
PERMUTE = CALLS.index("batch_isend_irecv")


def _jexpert(params, x):
    return jnp.tanh(x @ params["w1"]) @ params["w2"]


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(f)

    inp = {"x": n(8 * N, D), "x0": n(6 * N, D), "lg": n(16 * N, N),
           "px": n(32, D), "py": n(32, D), "tp/w1": n(D, 32, scale=0.25),
           "tp/w2": n(32, D, scale=0.25), "tp/b2": np.zeros(D, f)}
    for e in (4, 8, 16):
        inp[f"router{e}"] = n(D, e, scale=0.25)
        inp[f"e{e}/w1"] = n(e, D, 32, scale=0.25)
        inp[f"e{e}/w2"] = n(e, 32, D, scale=0.25)
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return shared_launch("moe_worker", tmp_path_factory, moe_worker, N,
                         inputs, timeout=240)


def _stack(inputs, e):
    return {"w1": jnp.asarray(inputs[f"e{e}/w1"]),
            "w2": jnp.asarray(inputs[f"e{e}/w2"])}


def _emulate(x, rw, stacked, k, cf, n):
    """The sharded layer on one device through JAX's functions: shard
    ``r``'s tokens routed at the local capacity, every queue through its
    expert (the all-to-alls only move queues), each shard's combine; and
    the aux loss of the global logits and the summed routing stats."""
    t_local = x.shape[0] // n
    e = rw.shape[1]
    cap = jmoe.moe_capacity(t_local, e, k, cf)
    xs = x.reshape(n, t_local, -1)
    logits = xs @ rw

    def shard(xr, lg):
        queues, comb = jmoe.dispatch_sort(xr, lg, cap, k)
        return comb(jax.vmap(_jexpert)(stacked, queues))

    out = jax.vmap(shard)(xs, logits).reshape(x.shape[0], -1)
    stats = jax.vmap(lambda lg: jmoe.routing_stats(lg, cap, k))(logits)
    lb = jmoe.load_balancing_loss(logits.reshape(x.shape[0], e))
    total = {name: stats[name].sum(0)
             for name in ("expert_load", "dropped", "padded")}
    total["capacity"] = stats["capacity"][0]
    return out, lb, total


@pytest.fixture(scope="module")
def references(inputs):
    """Per (k, cf, eps): JAX's moe_layer_local under shard_map (out, aux)
    and the one-device emulation's out, aux loss, stats and gradients of
    mean(out^2) + AUX * lb."""
    mesh = Mesh(np.array(jax.devices("cpu")[:N]), ("expert",))
    x = jnp.asarray(inputs["x"])
    configs = sorted({(k, cf, eps) for _, k, cf, eps in LAYER_CASES},
                     key=str)

    def one(k, cf, eps):
        e = N * eps

        def local(xs, rw, st):
            p = jax.tree.map(lambda l: l[0], st) if eps == 1 else st
            return jmoe.moe_layer_local(
                xs, rw, _jexpert, p, "expert", capacity_factor=cf, k=k,
                dispatch_impl="sort", experts_per_shard=eps,
                return_stats=True)

        return shard_map(local, mesh=mesh,
                         in_specs=(JP("expert"), JP(), JP("expert")),
                         out_specs=(JP("expert"), JP()), check_vma=False)(
            x, jnp.asarray(inputs[f"router{e}"]), _stack(inputs, e))

    def emulated(k, cf, eps):
        e = N * eps
        rw, st = jnp.asarray(inputs[f"router{e}"]), _stack(inputs, e)

        def loss(x, rw, st):
            out, lb, _ = _emulate(x, rw, st, k, cf, N)
            return jnp.mean(out ** 2) + AUX * lb

        return (_emulate(x, rw, st, k, cf, N),
                jax.grad(loss, argnums=(0, 1, 2))(x, rw, st))

    # every reference in one compiled program
    programs = jax.jit(lambda: [(one(*c), emulated(*c)) for c in configs])()
    refs = {}
    for c, ((out, aux), ((em_out, em_lb, em_stats), grads)) in zip(
            configs, programs):
        refs[c] = {"jax_out": out, "jax_aux": aux, "out": em_out,
                   "lb": em_lb, "stats": em_stats, "grads": grads}
    return refs


# ---------------------------------------------------------------------------
# routing, in this process
# ---------------------------------------------------------------------------

def _both(fn_name, logits, *args):
    fn = jax.jit(getattr(jmoe, fn_name), static_argnums=range(1, 1 + len(args)))
    jd = fn(jnp.asarray(logits), *args)
    td = getattr(tmoe, fn_name)(torch.from_numpy(np.asarray(logits)), *args)
    return jd, td


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [4, 16])
def test_route_slots_and_routers_match_jax(k, capacity):
    logits = np.random.default_rng(k * 10 + capacity).standard_normal(
        (64, 4)).astype(np.float32)
    js, ts = _both("route_slots", logits, capacity, k)
    assert len(js) == len(ts) == k
    for (jslot, jgate), (tslot, tgate) in zip(js, ts):
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate),
                                   **VALUE_TOL)
    name, args = ("top1_route", (capacity,)) if k == 1 else (
        "topk_route", (capacity, k))
    (jdisp, jcomb), (tdisp, tcomb) = _both(name, logits, *args)
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    np.testing.assert_allclose(tcomb.numpy(), np.asarray(jcomb), **VALUE_TOL)
    # every expert takes at most `capacity` tokens, and no slot is shared
    d = tdisp.numpy()
    assert (d.sum(axis=(0, 2)) <= capacity).all()
    assert (d.sum(axis=0) <= 1.0).all()
    assert (d.sum(axis=(1, 2)) <= k).all()


def test_combine_carries_gate_and_topk_gates_normalise():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 4)).astype(np.float32))
    probs = torch.softmax(logits, -1)
    dispatch, combine = tmoe.top1_route(logits, capacity=16)
    kept = dispatch.sum(dim=(1, 2)) > 0
    np.testing.assert_allclose(combine.sum(dim=(1, 2))[kept].numpy(),
                               probs.max(-1).values[kept].numpy(), rtol=1e-6)
    _, combine = tmoe.topk_route(logits, capacity=32, k=2)  # no drops
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(),
                               np.ones(16), rtol=1e-5)


def test_topk_bf16_logits_no_slot_collisions():
    tokens = 1024
    logits = torch.zeros(tokens, 4, dtype=torch.bfloat16)
    logits[:, 0] = 5.0
    dispatch, _ = tmoe.topk_route(logits, capacity=tokens, k=2)
    d = dispatch.float().numpy()
    assert (d.sum(axis=0) <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(d.sum(axis=(1, 2)), np.full(tokens, 2.0),
                               rtol=0, atol=1e-6)
    jd, _ = jax.jit(jmoe.topk_route, static_argnums=(1, 2))(
        jnp.asarray(logits.float().numpy(), jnp.bfloat16), tokens, 2)
    np.testing.assert_array_equal(d, np.asarray(jd, np.float32))


def test_topk_no_duplicate_expert_on_underflow_and_k_rejected():
    logits = np.zeros((16, 4), np.float32)
    logits[:, 2] = 200.0
    (jd, _), (td, _) = _both("topk_route", logits, 16, 2)
    d = td.numpy()
    assert (d.sum(axis=2) <= 1.0 + 1e-6).all(), "expert chosen twice"
    assert (d.sum(axis=(1, 2)) == 2.0).all()
    np.testing.assert_array_equal(d, np.asarray(jd))
    with pytest.raises(ValueError, match="exceeds"):
        tmoe.topk_route(torch.from_numpy(logits), capacity=4, k=5)
    with pytest.raises(ValueError, match="exceeds"):
        tmoe.route_slots(torch.zeros(8, 4), capacity=4, k=5)


def test_topk_respects_caller_neg_inf_padding():
    neg = float("-inf")
    logits = np.array([[5.0, 1.0, neg, 0.5]] * 8, np.float32)
    (jd, jc), (td, tc) = _both("topk_route", logits, 8, 4)
    assert (td.numpy().sum(axis=2) <= 1.0 + 1e-6).all(), "double-booked"
    assert np.isfinite(tc.numpy()).all()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **VALUE_TOL)


def test_load_balancing_loss_signal_and_jax():
    uniform = torch.zeros(128, 8)
    assert abs(float(tmoe.load_balancing_loss(uniform)) - 1.0) < 1e-5
    collapsed = torch.zeros(128, 8)
    collapsed[:, 0] = 20.0
    assert float(tmoe.load_balancing_loss(collapsed)) > 8 - 0.1
    lg = np.random.default_rng(5).standard_normal((64, 8)).astype(np.float32)
    np.testing.assert_allclose(
        float(tmoe.load_balancing_loss(torch.from_numpy(lg))),
        float(jmoe.load_balancing_loss(jnp.asarray(lg))), **VALUE_TOL)


def test_capacity_rule_and_negative_factor_rejected():
    with pytest.raises(ValueError, match="capacity_factor"):
        tmoe.moe_capacity(16, 4, 1, -1.0)
    for args in ((16, 4, 1, None), (16, 4, 1, 0.0), (37, 8, 2, 1.25),
                 (5, 4, 1, 0.5)):
        assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args)


@pytest.mark.parametrize("k,capacity", [(1, 8), (2, 8), (2, 64)])
def test_dispatch_impls_match_in_values_dtypes_and_grads(k, capacity):
    """One process: the queues and the combine of both impls equal each
    other and JAX's dispatch_sort, in fp32 and with bf16 tokens; the
    gradients to the tokens and the logits agree."""
    rng = np.random.default_rng(k + capacity)
    x_np = rng.standard_normal((64, D)).astype(np.float32)
    lg_np = rng.standard_normal((64, 4)).astype(np.float32)
    back_np = rng.standard_normal((4, capacity, D)).astype(np.float32)
    jq, jcomb = jmoe.dispatch_sort(jnp.asarray(x_np), jnp.asarray(lg_np),
                                   capacity, k)
    jout = jcomb(jnp.asarray(back_np))
    grads = {}
    for impl in ("einsum", "sort"):
        x = torch.from_numpy(x_np).requires_grad_()
        lg = torch.from_numpy(lg_np).requires_grad_()
        q, comb = tmoe._DISPATCH[impl](x, lg, capacity, k)
        out = comb(torch.from_numpy(back_np) + q)
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq),
                                   **VALUE_TOL)
        np.testing.assert_allclose(comb(torch.from_numpy(back_np)).detach()
                                   .numpy(), np.asarray(jout), **VALUE_TOL)
        grads[impl] = torch.autograd.grad((out ** 2).sum(), (x, lg))
        xb = torch.from_numpy(x_np).to(torch.bfloat16)
        qb, combb = tmoe._DISPATCH[impl](xb, lg.detach(), capacity, k)
        assert qb.dtype == torch.float32  # bf16 tokens, fp32 logits
        assert combb(qb.to(torch.bfloat16)).dtype == torch.float32
    for ge, gs in zip(grads["einsum"], grads["sort"]):
        np.testing.assert_allclose(gs.numpy(), ge.numpy(), **GRAD_TOL)


def test_auto_choices_and_the_recorder_wait_for_item_8():
    for fn in (lambda: tmoe.resolve_dispatch_impl(8, 4, 16, torch.float32),
               lambda: tmoe.resolve_expert_parallel(8, 4, 16, torch.float32),
               lambda: tmoe.record_moe_dispatch({})):
        with pytest.raises(NotImplementedError, match="queue 8"):
            fn()
    assert tmoe.resolve_dispatch_impl(8, 4, 16, None, "einsum") == "einsum"
    assert tmoe.resolve_expert_parallel(8, 4, 16, None, "on") == "on"


def test_make_expert_params_matches_jax_draws():
    def jinit(key):
        k1, k2 = jax.random.split(key)
        return {"w1": jax.random.normal(k1, (D, 32)) / 4.0,
                "w2": jax.random.normal(k2, (32, D)) / 4.0}

    def tinit(key):
        from chainermn_tpu_torch.utils import prng

        k1, k2 = prng.split(key)
        return {"w1": prng.normal(k1, (D, 32)) / 4.0,
                "w2": prng.normal(k2, (32, D)) / 4.0}

    got = tmoe.make_expert_params(tinit, np.asarray(jax.random.PRNGKey(2)),
                                  4)
    want = jmoe.make_expert_params(jinit, jax.random.PRNGKey(2), 4)
    for name in ("w1", "w2"):
        assert got[name].shape == (4,) + want[name].shape[1:]
        # jax.random.normal's erfinv, to a few ulps
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# moe_layer_local at 8 ranks
# ---------------------------------------------------------------------------

def _gather(ranks, key):
    return np.concatenate([o[key] for o in ranks])


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: case_key(*c))
def test_layer_matches_jax_values_and_stats(ranks, references, case):
    impl, k, cf, eps = case
    key = case_key(*case)
    ref = references[k, cf, eps]
    out = _gather(ranks, f"layer/{key}/out")
    np.testing.assert_allclose(out, np.asarray(ref["jax_out"]), **VALUE_TOL)
    np.testing.assert_allclose(out, np.asarray(ref["out"]), **VALUE_TOL)
    for o in ranks:
        aux = {name: o[f"layer/{key}/aux/{name}"] for name in (
            "load_balance", "expert_load", "dropped", "padded", "capacity")}
        for name, v in aux.items():
            np.testing.assert_allclose(v, np.asarray(ref["jax_aux"][name]),
                                       **VALUE_TOL)
        np.testing.assert_allclose(aux["load_balance"], float(ref["lb"]),
                                   **VALUE_TOL)
        for name in ("expert_load", "dropped", "padded", "capacity"):
            np.testing.assert_allclose(aux[name],
                                       np.asarray(ref["stats"][name]))
        assert aux["expert_load"].dtype == np.float32
    if cf is None:
        assert float(ranks[0][f"layer/{key}/aux/dropped"]) == 0.0
    # both impls give the same numbers
    other = case_key("sort" if impl == "einsum" else "einsum", k, cf, eps)
    np.testing.assert_allclose(out, _gather(ranks, f"layer/{other}/out"),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: case_key(*c))
def test_layer_gradients_match_the_global_loss(ranks, references, case):
    """Each rank backs its share of mean(out^2) + AUX * lb: its token
    rows' gradient, its router gradient (summed over the ranks: the
    replicated router's) and its own experts' gradients (the all-to-all's
    backward brought every rank's cotangents) equal the one-device
    gradient of the global loss."""
    _, k, cf, eps = case
    key = case_key(*case)
    gx, grw, gst = references[k, cf, eps]["grads"]
    np.testing.assert_allclose(_gather(ranks, f"layer/{key}/dx"),
                               np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(
        sum(o[f"layer/{key}/drouter"] for o in ranks), np.asarray(grw),
        **GRAD_TOL)
    for name in ("w1", "w2"):
        got = (np.stack([o[f"layer/{key}/d{name}"] for o in ranks])
               if eps == 1 else _gather(ranks, f"layer/{key}/d{name}"))
        np.testing.assert_allclose(got, np.asarray(gst[name]), **GRAD_TOL)


def test_no_drop_layer_equals_the_dense_single_device_evaluation(
        ranks, inputs):
    """capacity_factor=None: the sharded layer == every token through its
    top-k experts on one device (JAX's dispatch_einsum at the whole batch's
    capacity), whatever the layout."""
    x = jnp.asarray(inputs["x"])
    for eps in (1, 2):
        e = N * eps
        rw, st = jnp.asarray(inputs[f"router{e}"]), _stack(inputs, e)
        for k in (1, 2):
            dense = jax.jit(_ref_moe_dense, static_argnums=3)(x, rw, st, k)
            for impl in ("einsum", "sort"):
                got = _gather(ranks,
                              f"layer/{case_key(impl, k, None, eps)}/out")
                np.testing.assert_allclose(got, np.asarray(dense),
                                           rtol=2e-5, atol=2e-5)


def test_layer_makes_two_all_to_alls_each_way(ranks):
    for o in ranks:
        for key in ["bare"] + [case_key(*c) for c in LAYER_CASES]:
            fwd, bwd = o[f"layer/{key}/calls/fwd"], o[f"layer/{key}/calls/bwd"]
            assert fwd[A2A] == 2 and bwd[A2A] == 2, (key, fwd, bwd)
            assert fwd[PERMUTE] == 0 and bwd[PERMUTE] == 0
        # without stats nothing but the two all-to-alls
        assert o["layer/bare/calls/fwd"].sum() == 2
        assert o["layer/bare/calls/bwd"].sum() == 2


def test_capacity_zero_overflow_residual_counted(ranks, inputs):
    x0 = inputs["x0"]
    out = _gather(ranks, "edge/cap0/out")
    assert np.isfinite(out).all()
    tokens = x0.shape[0]
    for o in ranks:
        assert float(o["edge/cap0/capacity"]) == 1.0
        assert float(o["edge/cap0/dropped"]) == tokens - N
        np.testing.assert_allclose(float(o["edge/cap0/expert_load"].sum()), N)
    dropped_rows = np.abs(out - x0).sum(-1) == 0.0
    assert dropped_rows.sum() == tokens - N
    # JAX's layer on the same inputs
    mesh = Mesh(np.array(jax.devices("cpu")[:N]), ("expert",))

    def local(x, st):
        p = jax.tree.map(lambda l: l[0], st)
        return x + jmoe.moe_layer_local(x, jnp.zeros((D, N)), _jexpert, p,
                                        "expert", capacity_factor=0.0)

    want = jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(JP("expert"), JP("expert")),
                             out_specs=JP("expert"), check_vma=False))(
        jnp.asarray(x0), _stack(inputs, N))
    np.testing.assert_allclose(out, np.asarray(want), **VALUE_TOL)


def test_load_balancing_loss_layout_invariant(ranks, inputs):
    want = float(jmoe.load_balancing_loss(jnp.asarray(inputs["lg"])))
    for o in ranks:
        np.testing.assert_allclose(float(o["edge/lb_sharded"]), want,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(o["edge/lb_sharded_tuple"]), want,
                                   rtol=1e-6)


def test_router_of_another_expert_count_rejected(ranks):
    for o in ranks:
        assert o["edge/router_mismatch"]


def test_mixed_precision_dtype_parity(ranks):
    e = _gather(ranks, "edge/bf16/einsum")
    s = _gather(ranks, "edge/bf16/sort")
    np.testing.assert_allclose(s, e, rtol=2e-2, atol=2e-2)
    for o in ranks:
        assert str(o["edge/bf16/einsum/dtype"]) == str(o["edge/bf16/sort/dtype"])


# ---------------------------------------------------------------------------
# the plan's expert axis at 8 ranks
# ---------------------------------------------------------------------------

def test_moe_plan_axis_provider(ranks):
    for o in ranks:
        assert o["plan/provider"].all()
    assert CANONICAL_AXES == J_AXES
    assert CANONICAL_AXES.index("expert") == CANONICAL_AXES.index("model") - 1


def _ref_moe_dense(x, router_w, stacked, k=1):
    queues, combine_fn = jmoe.dispatch_einsum(x, x @ router_w, x.shape[0], k)
    return combine_fn(jax.vmap(_jexpert)(stacked, queues))


def _ref_step(inputs, e, tp, steps):
    """tests/test_moe.py's one-device reference: ``steps`` SGD steps of
    the loss with the no-drop dense MoE (after the dense TP MLP for the
    expert x model plan); returns (losses before each step, params)."""
    p = {"experts": _stack(inputs, e),
         "router": jnp.asarray(inputs[f"router{e}"])}
    if tp:
        p.update(w1=jnp.asarray(inputs["tp/w1"]),
                 w2=jnp.asarray(inputs["tp/w2"]),
                 b2=jnp.asarray(inputs["tp/b2"]))
    x, y = jnp.asarray(inputs["px"]), jnp.asarray(inputs["py"])

    def loss(p):
        h = jax.nn.gelu(x @ p["w1"]) @ p["w2"] + p["b2"] if tp else x
        out = h + _ref_moe_dense(h, p["router"], p["experts"])
        return (jnp.mean((out - y) ** 2)
                + AUX * jmoe.load_balancing_loss(h @ p["router"]))

    losses = []
    step = jax.jit(jax.value_and_grad(loss))
    for _ in range(steps):
        val, g = step(p)
        losses.append(float(val))
        p = jax.tree.map(lambda a, b: a - LR * b, p, g)
    return losses, p


PLANS = {"e8": (8, False, 2), "e4d2": (4, False, 1), "e4m2": (4, True, 1)}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_expert_plans_values_and_grads(ranks, inputs, name):
    e, tp, steps = PLANS[name]
    losses, want = _ref_step(inputs, e, tp, steps)
    for o in ranks:
        for i, l in enumerate(losses):
            np.testing.assert_allclose(float(o[f"plan/{name}/loss{i}"]), l,
                                       rtol=1e-4)
        for leaf in ("w1", "w2"):
            np.testing.assert_allclose(o[f"plan/{name}/p/experts/{leaf}"],
                                       np.asarray(want["experts"][leaf]),
                                       **PARAM_TOL)
        np.testing.assert_allclose(o[f"plan/{name}/p/router"],
                                   np.asarray(want["router"]), **PARAM_TOL)
        if tp:
            # the TP leaves see the expert axis as data parallelism
            w1 = np.concatenate(list(o[f"plan/{name}/p/w1"]), axis=1)
            np.testing.assert_allclose(w1, np.asarray(want["w1"]),
                                       **PARAM_TOL)
            w2 = np.concatenate(list(o[f"plan/{name}/p/w2"]), axis=0)
            np.testing.assert_allclose(w2, np.asarray(want["w2"]),
                                       **PARAM_TOL)
        # the stats rode the metric mean: no drops, loads sum to tokens
        assert float(o[f"plan/{name}/dropped"]) == 0.0
        np.testing.assert_allclose(o[f"plan/{name}/expert_load"].sum(),
                                   inputs["px"].shape[0], rtol=1e-6)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_expert_plans_describe_record_and_refusals(ranks, name):
    for o in ranks:
        for key in ("record", "describe", "auto", "k_exceeds", "bad_impl"):
            assert np.all(o[f"plan/{name}/{key}"]), key


@pytest.mark.parametrize("name", sorted(PLANS))
def test_expert_plan_step_makes_two_all_to_alls_each_way(ranks, name):
    """tests/test_moe.py's HLO pins as calls: dispatch and combine
    forward, their transposes backward (2 to 4 all-to-alls: the
    dispatch's transpose only carries the tokens' cotangent, so it runs
    when they need one, after the TP MLP, and not on the raw batch),
    nothing permuted."""
    tokens_need_grad = PLANS[name][1]
    for o in ranks:
        calls = o[f"plan/{name}/calls"]
        assert 2 <= calls[A2A] <= 4
        assert calls[A2A] == (4 if tokens_need_grad else 3), calls
        assert calls[PERMUTE] == 0, calls


def test_forward_makes_two_all_to_alls_per_moe_layer(ranks):
    for o in ranks:
        assert int(o["plan/fwd1/a2a"]) == 2
        assert int(o["plan/fwd2/a2a"]) == 4
