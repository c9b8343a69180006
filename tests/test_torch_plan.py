"""The port's ParallelPlan (``chainermn_tpu_torch.parallel.plan``) against
the JAX package's, case for case with tests/test_plan.py, at 8 gloo ranks
(``tests/torch_plan_workers.py::plan_worker``, one launch) against the
JAX plan on the 8-device CPU mesh, on the same numpy-seeded inputs:

- the spec providers, ``describe``, the axis factorisation and the spec
  validation;
- dp x zero, dp x tp x zero, ``zero_stacked_groups``, dp x pipe and
  pipe x model: the losses of 3 AdamW steps (values) and the parameters
  after one SGD step (the gradients, through ``(p0 - p1) / lr``), the
  stacked leaves through the port's global view;
- the pipe-plan rejections, ``make_train_step(plan=)`` and its refusals,
  ``inner_transform``;
- the zero state 1/n a rank and through a checkpoint round trip, and the
  plan step against the communicator path.

The JAX HLO collective-count pins become counts of ``torch.distributed``
calls a step against the rule: the zero chain makes one reduce-scatter
and one all-gather a group, and nothing is permuted or resharded.

Tolerances: tests/test_plan.py's own: the losses 1e-5 relative and 1e-6
absolute, the parameters after AdamW 1e-4 / 1e-5, the SGD deltas 1e-4 /
1e-6 (optax and torch round AdamW differently; the gradients are fp32 on
both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as JP

from chainermn_tpu.parallel.plan import (
    ParallelPlan as JaxPlan,
    PipelinePlanSpec as JaxPipe,
)
from chainermn_tpu.parallel.tensor import (
    copy_to_tp as jax_copy_to_tp,
    gather_from_tp as jax_gather_from_tp,
    stack_tp_params as jax_stack_tp_params,
    tp_mlp as jax_tp_mlp,
)
from torch_comm_workers import shared_launch
from torch_plan_workers import CALLS, plan_worker
from torch_rank_workers import few_threads  # noqa: F401

N = 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 0.1


def _devices():
    return jax.devices("cpu")[:N]


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return {
        "mlp/w1": (rng.standard_normal((8, 8)) * 0.3).astype(f),
        "mlp/w2": (rng.standard_normal((8, 8)) * 0.3).astype(f),
        "mlp/b2": np.zeros(8, f),
        "x": rng.standard_normal((16, 8)).astype(f),
        "y": rng.standard_normal((16, 8)).astype(f),
        "pipe/w": (rng.standard_normal((4, 8, 8)) * 0.4).astype(f),
        "pipe/x": rng.standard_normal((16, 8)).astype(f),
        "pipe/y": rng.standard_normal((16, 8)).astype(f),
        "pm/stage_w": (rng.standard_normal((2, 8, 8)) * 0.4).astype(f),
        "pm/x": rng.standard_normal((8, 8)).astype(f),
        "pm/y": rng.standard_normal((8, 8)).astype(f),
    }


@pytest.fixture(scope="module")
def inputs():
    inp = _inputs()
    # pipe x model: each stage's kernel cut into 2 column shards
    inp["pm/w"] = np.stack([np.asarray(jax_stack_tp_params(
        jnp.asarray(w), 2, 1)) for w in inp["pm/stage_w"]])
    return inp


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    send = {k: v for k, v in inputs.items() if k != "pm/stage_w"}
    return shared_launch("plan_worker", tmp_path_factory, plan_worker, N,
                         send, timeout=240)


def _mlp(inputs):
    return {k: jnp.asarray(inputs[f"mlp/{k}"]) for k in ("w1", "w2", "b2")}


def _mlp_loss(p, batch):
    xb, yb = batch
    return jnp.mean((jax.nn.gelu(xb @ p["w1"]) @ p["w2"] + p["b2"] - yb) ** 2)


def _jax_drive(plan, inner, params, specs, loss_fn, batch, steps, **kw):
    state = plan.create_train_state(params, inner, param_specs=specs)
    step = plan.compile_train_step(loss_fn, inner, params,
                                   param_specs=specs, **kw)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return jax.device_get(state.params), np.array(losses)


def _each_rank(ranks, prefix, want, tol):
    for out in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(out[f"{prefix}/{k}"], np.asarray(v),
                                       **tol)


def _jax_tp_case(inputs, zsg):
    plan = JaxPlan(("data", "model", "zero"), devices=_devices(),
                   zero_stacked_groups=zsg)
    p = _mlp(inputs)
    params = {"w1": jax_stack_tp_params(p["w1"], 2, 1),
              "w2": jax_stack_tp_params(p["w2"], 2, 0), "b2": p["b2"]}
    specs = {"w1": JP("model"), "w2": JP("model"), "b2": JP()}

    def loss_fn(q, batch):
        xb, yb = batch
        out = jax_tp_mlp(xb, q["w1"], None, q["w2"], q["b2"],
                         axis_name="model")
        return jnp.mean((out - yb) ** 2)

    batch = (jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"]))
    adam, losses = _jax_drive(plan, optax.adamw(1e-2), params, specs,
                              loss_fn, batch, 3)
    sgd, _ = _jax_drive(plan, optax.sgd(LR), params, specs, loss_fn, batch,
                        1)
    return adam, losses, sgd


# ---------------------------------------------------------------------------
# spec providers
# ---------------------------------------------------------------------------

def test_modules_publish_their_axis(ranks):
    for out in ranks:
        assert out["prov/tp"].all() and out["prov/zero"].all()
        assert out["prov/pipe"]


def test_describe_aggregates_owed_collectives(ranks):
    jd = JaxPlan(("data", "model", "zero"), devices=_devices()).describe()
    for out in ranks:
        assert list(out["describe/mesh"]) == [jd["mesh"][a] for a in
                                              ("data", "zero", "model")]
        assert out["describe/order"] and out["describe/collectives"]


def test_auto_factorisation_uses_canonical_order(ranks):
    jp = JaxPlan(("model", "data"), devices=_devices())
    for out in ranks:
        assert list(out["auto"]) == [jp.axis_size("data"),
                                     jp.axis_size("model"), 1]
        assert int(out["infer"]) == JaxPlan(
            {"data": 2, "zero": -1}, devices=_devices()).axis_size("zero")


def test_explicit_sizes_rejections_and_left_outs(ranks):
    for out in ranks:
        for key in ("cover", "dup", "unknown", "expert", "grad_reduction"):
            assert out[f"reject/{key}"], key


def test_param_spec_validation(ranks):
    for out in ranks:
        for key in ("full", "stacked_axes", "leading_dim", "leading_stack"):
            assert out[f"spec/{key}"], key


# ---------------------------------------------------------------------------
# dist == single, values and gradients
# ---------------------------------------------------------------------------

def test_dp_zero_values_and_grads(ranks, inputs):
    plan = JaxPlan({"data": 2, "zero": 4}, devices=_devices())
    params = _mlp(inputs)
    batch = (jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"]))
    adam, losses = _jax_drive(plan, optax.adamw(1e-2), params, None,
                              _mlp_loss, batch, 3)
    sgd, _ = _jax_drive(plan, optax.sgd(LR), params, None, _mlp_loss, batch,
                        1)
    for out in ranks:
        np.testing.assert_allclose(out["dz/losses"], losses, **LOSS_TOL)
    _each_rank(ranks, "dz/adamw", adam, PARAM_TOL)
    for out in ranks:
        for k in params:
            np.testing.assert_allclose(
                (inputs[f"mlp/{k}"] - out[f"dz/sgd/{k}"]) / LR,
                (inputs[f"mlp/{k}"] - np.asarray(sgd[k])) / LR, **GRAD_TOL)


def rank_slice(leaf, coords, axes):
    """A rank's slice of a JAX global-view stacked leaf: index its leading
    dims by the rank's coordinates on ``axes`` (``[n, ...]`` over
    ``'zero'``: the rank's row)."""
    for ax in axes:
        leaf = leaf[coords[ax]]
    return np.asarray(leaf)


def stack_rank_slices(ranks, key, axis, coord_of):
    """The global view back from the ranks' slices: rank slices stacked
    in the order of their coordinate on ``axis`` (one rank a coordinate)."""
    by = {}
    for rk in ranks:
        by.setdefault(coord_of(rk)[axis], rk[key])
    return np.stack([by[i] for i in sorted(by)])


def test_dp_zero_state_equals_jax_stacked_state(ranks, inputs):
    """The plan's zero state, leaf by leaf: each rank's AdamW chunk is its
    row of JAX's ``[n, ...]`` state leaf (the per-leaf ``_chunk_rows``
    layout), and the rows gathered back from the ranks are the leaf."""
    plan = JaxPlan({"data": 2, "zero": 4}, devices=_devices())
    params = _mlp(inputs)
    inner = optax.adamw(1e-2)
    state = plan.create_train_state(params, inner)
    step = plan.compile_train_step(_mlp_loss, inner, params)
    batch = (jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"]))
    for _ in range(3):
        state, _ = step(state, batch)
    adam = jax.device_get(state.opt_state["zero"])[0]
    names = sorted(params)  # JAX flattens a dict by its sorted keys

    def coords(rk):
        return {"data": int(rk["dz/coords"][0]),
                "zero": int(rk["dz/coords"][1])}

    for i, k in enumerate(names):
        for ours, theirs in (("exp_avg", adam.mu[i]),
                             ("exp_avg_sq", adam.nu[i])):
            # the moments' own scale: an entry near 0 carries the fp32
            # noise of the two frameworks' gradients, not a layout error
            tol = dict(rtol=1e-4, atol=1e-4 * float(np.abs(theirs).max()))
            for rk in ranks:
                np.testing.assert_allclose(
                    rk[f"dz/state/{ours}/{k}"],
                    rank_slice(theirs, coords(rk), ("zero",)), **tol)
            np.testing.assert_allclose(
                stack_rank_slices(ranks, f"dz/state/{ours}/{k}", "zero",
                                  coords), np.asarray(theirs), **tol)
        for rk in ranks:
            assert float(rk[f"dz/state/step/{k}"]) == int(
                rank_slice(adam.count, coords(rk), ("zero",)))


def test_dp_zero_step_collectives_and_in_place_update(ranks):
    """One zero step: one reduce-scatter and one all-gather (the zero
    chain's, every leaf in one buffer), one all-reduce of the chunk over
    the other dp axis and one of the metrics; nothing permuted. The step
    returns the state's own tensors."""
    want = dict.fromkeys(CALLS, 0)
    want.update(all_reduce=2, reduce_scatter_tensor=1,
                all_gather_into_tensor=1)
    for out in ranks:
        assert dict(zip(CALLS, out["dz/calls"].tolist())) == want
        assert out["dz/same_tensors"]


def test_dp_tp_zero_values_and_grads(ranks, inputs):
    adam, losses, sgd = _jax_tp_case(inputs, zsg=False)
    for out in ranks:
        np.testing.assert_allclose(out["dtz/losses"], losses, **LOSS_TOL)
    _each_rank(ranks, "dtz/adamw", adam, PARAM_TOL)
    for out in ranks:
        for k in ("w1", "w2", "b2"):
            np.testing.assert_allclose(
                out[f"dtz/sgd/{k}"], np.asarray(sgd[k]), **GRAD_TOL)
        w1 = np.concatenate(list(out["dtz/sgd/w1"]), axis=-1)
        np.testing.assert_allclose((inputs["mlp/w1"] - w1) / LR,
                                   (inputs["mlp/w1"] - np.concatenate(
                                       list(np.asarray(sgd["w1"])), -1)) / LR,
                                   **GRAD_TOL)


def test_zero_stacked_groups_values_and_grads(ranks, inputs):
    _, losses, sgd = _jax_tp_case(inputs, zsg=True)
    for out in ranks:
        assert out["zsg/describe"]
        np.testing.assert_allclose(out["zsg/losses"], losses, **LOSS_TOL)
        w1 = np.concatenate(list(out["zsg/sgd/w1"]), axis=-1)
        want = np.concatenate(list(np.asarray(sgd["w1"])), -1)
        np.testing.assert_allclose((inputs["mlp/w1"] - w1) / LR,
                                   (inputs["mlp/w1"] - want) / LR, **GRAD_TOL)


def test_zero_stacked_groups_state_layout_and_calls(ranks):
    """Model-group state leaves stack [m, z, ...] in the global view, each
    rank holding 1/(m z) of the leaf (w1/w2 [8, 8] over m 2 and z 2: a
    4 x 8 slice, chunks of 16); the step makes one reduce-scatter and one
    all-gather for each zero-chained group (model and zero), one
    all-reduce of each chunk over 'data', the TP pair's forward all-reduce
    (its backward one would reach only the batch, which takes no
    gradient) and the metrics' one."""
    want = dict.fromkeys(CALLS, 0)
    want.update(all_reduce=2 + 1 + 1, reduce_scatter_tensor=2,
                all_gather_into_tensor=2)
    for out in ranks:
        # state_specs: the model group's state over model and zero (JAX's
        # P('model', 'zero')), the zero group's over zero
        assert out["zsg/state_specs"]
        assert out["zsg/model_state_numel"].tolist() == [16, 16]
        assert out["zsg/state_global_shape"].tolist() == [2, 2, 16]
        assert out["zsg/state_local_shape"].tolist() == [1, 1, 16]
        assert dict(zip(CALLS, out["zsg/calls"].tolist())) == want


def test_zero_stacked_groups_validation(ranks):
    for out in ranks:
        for key in ("no_zero", "no_stack", "grad_reduction"):
            assert out[f"zsg/reject_{key}"], key


def test_dp_pipe_values_and_grads(ranks, inputs):
    plan = JaxPlan({"data": 2, "pipe": 4}, devices=_devices())
    params = {"w": jnp.asarray(inputs["pipe/w"])}
    pipe = JaxPipe(stage_fn=lambda p, mb: jnp.tanh(mb @ p["w"]),
                   loss_fn=lambda yh, b: jnp.mean((yh - b[1]) ** 2),
                   n_microbatches=4)
    batch = (jnp.asarray(inputs["pipe/x"]), jnp.asarray(inputs["pipe/y"]))
    sgd, losses = _jax_drive(plan, optax.sgd(LR), params,
                             {"w": JP("pipe")}, None, batch, 1,
                             pipeline=pipe)
    for out in ranks:
        np.testing.assert_allclose(out["pipe/loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(
            (inputs["pipe/w"] - out["pipe/sgd/w"]) / LR,
            (inputs["pipe/w"] - np.asarray(sgd["w"])) / LR, **GRAD_TOL)


def test_pipe_plan_rejections(ranks):
    for out in ranks:
        for key in ("replicated", "no_spec", "no_axis"):
            assert out[f"pipe/reject_{key}"], key


def test_pipe_model_composed_values_and_grads(ranks, inputs):
    plan = JaxPlan({"data": 2, "pipe": 2, "model": 2}, devices=_devices())
    params = {"w": jnp.asarray(inputs["pm/w"])}

    def stage_fn(p, mb):
        h = jax_copy_to_tp(mb, "model") @ p["w"]
        return jnp.tanh(jax_gather_from_tp(h, "model", 1))

    pipe = JaxPipe(stage_fn=stage_fn,
                   loss_fn=lambda yh, b: jnp.mean((yh - b[1]) ** 2),
                   n_microbatches=2)
    batch = (jnp.asarray(inputs["pm/x"]), jnp.asarray(inputs["pm/y"]))
    sgd, losses = _jax_drive(plan, optax.sgd(LR), params,
                             {"w": JP("pipe", "model")}, None, batch, 1,
                             pipeline=pipe)
    for out in ranks:
        np.testing.assert_allclose(out["pm/loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(
            (inputs["pm/w"] - out["pm/sgd/w"]) / LR,
            (inputs["pm/w"] - np.asarray(sgd["w"])) / LR, **GRAD_TOL)
        assert out["pm/group"]
        # AdamW state mirrors the double stack [pipe, model, ...]
        assert out["pm/state_shape"].tolist()[:2] == [2, 2]
        assert out["pm/reject_order"] and out["pm/reject_lead"]


# ---------------------------------------------------------------------------
# the zero state, checkpoints
# ---------------------------------------------------------------------------

def test_zero_state_is_sharded_and_one_nth(ranks):
    jplan = JaxPlan({"zero": 8}, devices=_devices())
    jstate = jplan.create_train_state({"w": jnp.ones((64, 8)) * 0.1},
                                      optax.adamw(1e-2))
    mu = jax.tree.leaves(jstate.opt_state["zero"])[1]  # the Adam mu leaf
    assert mu.shape[0] == 8
    for out in ranks:
        assert int(out["zero8/local_numel"]) * 8 == 64 * 8
        assert out["zero8/global_shape"].tolist() == list(mu.shape)


def test_checkpoint_roundtrip_plan_zero_state(ranks):
    for out in ranks:
        assert int(out["ckpt/iteration"]) == 1
        assert int(out["ckpt/files"]) == N  # a file a rank
        live, rest = out["ckpt/loss"]
        assert live == rest
        for k in ("w1", "w2", "b2"):
            np.testing.assert_array_equal(out[f"ckpt/live/{k}"],
                                          out[f"ckpt/rest/{k}"])
        assert out["ckpt/none"].all()


# ---------------------------------------------------------------------------
# make_train_step integration, the optimizer unwrap
# ---------------------------------------------------------------------------

def test_make_train_step_plan_path(ranks, inputs):
    from chainermn_tpu.training.train_step import make_train_step

    plan = JaxPlan({"data": 2, "zero": 4}, devices=_devices())
    params = {"w": jnp.ones((8, 8)) * 0.1}
    x = jnp.asarray(inputs["x"])

    def loss_fn(p, batch):
        return jnp.mean((batch @ p["w"]) ** 2)

    inner = optax.adamw(1e-2)
    step = make_train_step(loss_fn, inner, plan=plan)
    state = plan.create_train_state(params, inner)
    for _ in range(2):
        state, m = step(state, x)
    for out in ranks:
        np.testing.assert_allclose(out["mts/loss"], float(m["loss"]),
                                   **LOSS_TOL)


def test_make_train_step_plan_rejects_comm_only_knobs(ranks):
    for out in ranks:
        for key in ("accum", "no_comm", "specs"):
            assert out[f"mts/reject_{key}"], key


def test_make_train_step_pipe_plan_path(ranks):
    for out in ranks:
        assert np.isfinite(out["mts/pipe_loss"])


def test_inner_transform_unwraps_and_refuses(ranks):
    for out in ranks:
        assert out["inner/pass"] and out["inner/unwrap"].all()
        assert out["inner/reject_db"] and out["inner/reject_wire"]


def test_plan_unwraps_wrapper_consistently(ranks):
    for out in ranks:
        assert np.isfinite(out["unwrap/loss"])
        # chunked by the plan's zero axis (4): 64 / 4, not 64 / 8
        assert int(out["unwrap/chunk"]) == 16


def test_make_train_step_plan_matches_comm_path(ranks):
    for out in ranks:
        c, p = out["comm/loss"]
        assert abs(c - p) < 1e-6
        assert float(out["comm/max_diff"]) < 1e-6
