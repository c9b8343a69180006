"""Rank workers of the port's ParallelPlan tests
(``tests/test_torch_plan.py``).

``chainermn_tpu_torch.testing.run_distributed`` runs :func:`plan_worker`
in 8 spawned gloo processes; it runs every case of tests/test_plan.py on
this rank in one launch and returns flat ``{name: ndarray}`` results (the
global view of the parameters, gathered, and flags for the refusals). A
child imports this module before it runs anything, so it imports no JAX.
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from torch_cross_rank_workers import counted_dist_calls

#: optax.adamw's defaults at the JAX tests' learning rate
ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
#: the torch.distributed calls a plan step is counted by
CALLS = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
         "all_gather", "batch_isend_irecv", "all_to_all_single", "broadcast")


def _adamw(params):
    return torch.optim.AdamW(params, **ADAMW)


def _sgd(lr):
    return functools.partial(torch.optim.SGD, lr=lr)


def _raises(fn, exc, match: str) -> np.ndarray:
    """1 when ``fn()`` raises ``exc`` whose message holds ``match``."""
    try:
        fn()
    except exc as e:
        return np.array(int(match in str(e)))
    return np.array(0)


def _mlp_loss(p, batch):
    xb, yb = batch
    h = F.gelu(xb @ p["w1"], approximate="tanh")
    return ((h @ p["w2"] + p["b2"] - yb) ** 2).mean()


def tensor_tree(inputs: dict, prefix: str) -> dict:
    """The ``prefix`` entries of the inputs as a dict of tensors."""
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in inputs.items() if k.startswith(prefix)}


def _drive(plan, make, params, specs, loss_fn, batch, steps, **kw):
    state = plan.create_train_state(params, make, param_specs=specs)
    step = plan.compile_train_step(loss_fn, make, params, param_specs=specs,
                                   **kw)
    losses = []
    for _ in range(steps):
        state, m = step(state, plan.local_batch(batch))
        losses.append(float(m["loss"]))
    return state, np.array(losses), step


def _put(out, prefix, tree):
    for k, v in tree.items():
        out[f"{prefix}/{k}"] = v.detach().numpy().copy()


def plan_worker(inputs: dict) -> dict:
    """Every case of tests/test_plan.py on this rank of 8."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.extensions import (
        create_multi_node_checkpointer,
    )
    from chainermn_tpu_torch.optimizers import (
        create_multi_node_optimizer,
        inner_transform,
    )
    from chainermn_tpu_torch.parallel import (
        copy_to_tp,
        gather_from_tp,
        pipe_plan_axis,
        stack_tp_params,
        tp_mlp,
        tp_plan_axis,
        zero_plan_axis,
    )
    from chainermn_tpu_torch.parallel.plan import (
        ParallelPlan,
        PipelinePlanSpec,
    )
    from chainermn_tpu_torch.parallel.plan_specs import P
    from chainermn_tpu_torch.training import (
        create_train_state,
        make_train_step,
    )

    out = {}
    mlp = tensor_tree(inputs, "mlp/")
    batch = (torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"]))

    # -- spec providers and describe ----------------------------------
    out["prov/tp"] = np.array([tp_plan_axis()["collectives"]
                               == ("all-reduce",),
                               tp_plan_axis()["stacked"] is True])
    out["prov/zero"] = np.array([
        zero_plan_axis()["collectives"] == ("reduce-scatter", "all-gather"),
        zero_plan_axis()["state_stacked"] is True])
    out["prov/pipe"] = np.array(pipe_plan_axis()["collectives"]
                                == ("collective-permute",))
    plan = ParallelPlan(("data", "model", "zero"), device="cpu")
    d = plan.describe()
    out["describe/mesh"] = np.array([d["mesh"][a] for a in
                                     ("data", "zero", "model")])
    out["describe/order"] = np.array(list(d["mesh"]) == ["data", "zero",
                                                          "model"])
    out["describe/collectives"] = np.array(
        d["collectives"]["zero"] == ("reduce-scatter", "all-gather")
        and d["collectives"]["model"] == ("all-reduce",))
    auto = ParallelPlan(("model", "data"), device="cpu")
    out["auto"] = np.array([auto.axis_size("data"), auto.axis_size("model"),
                            tuple(auto.mesh.mesh_dim_names)
                            == ("data", "model")])
    out["infer"] = np.array(ParallelPlan({"data": 2, "zero": -1},
                                         device="cpu").axis_size("zero"))
    out["reject/cover"] = _raises(
        lambda: ParallelPlan({"data": 3}, device="cpu"), ValueError, "cover")
    out["reject/dup"] = _raises(
        lambda: ParallelPlan(("data", "data"), device="cpu"), ValueError,
        "data")
    out["reject/unknown"] = _raises(
        lambda: ParallelPlan({"tower": 8}, device="cpu"), ValueError,
        "subset")
    # the expert axis is ported; its 'auto' dispatch waits for item 8
    out["reject/expert"] = _raises(
        lambda: ParallelPlan({"expert": 8}, device="cpu").moe_layer(
            tokens_local=4, d_model=8), NotImplementedError, "item 8")
    out["reject/grad_reduction"] = _raises(
        lambda: ParallelPlan({"data": 8}, device="cpu",
                             grad_reduction="zero"),
        ValueError, "sharded_update")
    tp_plan = ParallelPlan({"data": 4, "model": 2}, device="cpu")
    sp = {"w": torch.zeros(2, 4, 4), "b": torch.zeros(4)}
    full = tp_plan.param_specs(sp, {"w": P("model"), "b": P()})
    out["spec/full"] = np.array(full["w"] == P("model") and full["b"] == P())
    out["spec/stacked_axes"] = _raises(
        lambda: tp_plan.param_specs(sp, {"w": P("data"), "b": P()}),
        ValueError, "stacked axes")
    out["spec/leading_dim"] = _raises(
        lambda: tp_plan.param_specs({"w": torch.zeros(3, 4), "b": sp["b"]},
                                    {"w": P("model"), "b": P()}),
        ValueError, "leading dim")
    out["spec/leading_stack"] = _raises(
        lambda: tp_plan.param_specs(sp, {"w": P(None, "model"), "b": P()}),
        ValueError, "leading-stack")

    # -- dp x zero: adamw values, sgd gradients; the step's calls ------
    plan = ParallelPlan({"data": 2, "zero": 4}, device="cpu")
    state, out["dz/losses"], _ = _drive(plan, _adamw, mlp, None, _mlp_loss,
                                        batch, 3)
    _put(out, "dz/adamw", plan.global_params(state))
    # this rank's chunk of the zero group's AdamW state, leaf by leaf
    st = state.opt_state["zero"].state_dict()["state"]
    for i, k in enumerate(mlp):  # the group's leaves in flatten order
        for name in ("exp_avg", "exp_avg_sq", "step"):
            out[f"dz/state/{name}/{k}"] = st[i][name].numpy().copy()
    out["dz/coords"] = np.array([plan.axis_index("data"),
                                 plan.axis_index("zero")])
    state, _, step = _drive(plan, _sgd(0.1), mlp, None, _mlp_loss, batch, 1)
    _put(out, "dz/sgd", plan.global_params(state))
    before = [id(t) for t in state.params.values()]
    with counted_dist_calls(CALLS) as calls:
        state, _ = step(state, plan.local_batch(batch))
    out["dz/calls"] = np.array([calls[c] for c in CALLS])
    out["dz/same_tensors"] = np.array(
        before == [id(t) for t in state.params.values()])

    # -- dp x tp x zero -------------------------------------------------
    plan = ParallelPlan(("data", "model", "zero"), device="cpu")
    m = plan.axis_size("model")
    tp_params = {"w1": stack_tp_params(mlp["w1"], m, 1),
                 "w2": stack_tp_params(mlp["w2"], m, 0), "b2": mlp["b2"]}
    tp_specs = {"w1": P("model"), "w2": P("model"), "b2": P()}
    g_model = plan.group("model")

    def tp_loss(p, b):
        xb, yb = b
        o = tp_mlp(xb, p["w1"], None, p["w2"], p["b2"], group=g_model)
        return ((o - yb) ** 2).mean()

    state, out["dtz/losses"], _ = _drive(plan, _adamw, tp_params, tp_specs,
                                         tp_loss, batch, 3)
    _put(out, "dtz/adamw", plan.global_params(state, tp_specs))
    state, _, _ = _drive(plan, _sgd(0.1), tp_params, tp_specs, tp_loss,
                         batch, 1)
    _put(out, "dtz/sgd", plan.global_params(state, tp_specs))

    # -- zero_stacked_groups -------------------------------------------
    zplan = ParallelPlan(("data", "model", "zero"), device="cpu",
                         zero_stacked_groups=True)
    zg_model = zplan.group("model")

    def ztp_loss(p, b):
        xb, yb = b
        o = tp_mlp(xb, p["w1"], None, p["w2"], p["b2"], group=zg_model)
        return ((o - yb) ** 2).mean()

    out["zsg/describe"] = np.array(zplan.describe()["zero_stacked_groups"])
    sspec = zplan.state_specs(tp_params, tp_specs)["opt_state"]
    out["zsg/state_specs"] = np.array(
        sspec == {"model": P("model", "zero"), "zero": P("zero")})
    state, out["zsg/losses"], zstep = _drive(zplan, _adamw, tp_params,
                                             tp_specs, ztp_loss, batch, 3)
    z = zplan.axis_size("zero")
    mu = state.opt_state["model"].state_dict()["state"]
    out["zsg/model_state_numel"] = np.array([mu[i]["exp_avg"].numel()
                                             for i in (0, 1)])
    with counted_dist_calls(CALLS) as calls:
        zstep(state, zplan.local_batch(batch))
    out["zsg/calls"] = np.array([calls[c] for c in CALLS])
    tree = zplan.state_tree(state, tp_specs)
    leaf = tree["opt_state"]["model"]["state"][0]["exp_avg"]
    out["zsg/state_global_shape"] = np.array(tuple(leaf.shape))
    out["zsg/state_local_shape"] = np.array(tuple(leaf.to_local().shape))
    state, _, _ = _drive(zplan, _sgd(0.1), tp_params, tp_specs, ztp_loss,
                         batch, 1)
    _put(out, "zsg/sgd", zplan.global_params(state, tp_specs))
    out["zsg/reject_no_zero"] = _raises(
        lambda: ParallelPlan({"data": 4, "model": 2}, device="cpu",
                             zero_stacked_groups=True), ValueError, "zero")
    out["zsg/reject_no_stack"] = _raises(
        lambda: ParallelPlan({"data": 2, "zero": 4}, device="cpu",
                             zero_stacked_groups=True), ValueError,
        "stacked axis")
    out["zsg/reject_grad_reduction"] = _raises(
        lambda: ParallelPlan({"data": 2, "zero": 2, "model": 2},
                             device="cpu", zero_stacked_groups=True,
                             grad_reduction="flat"), ValueError,
        "mutually exclusive")

    # -- dp x pipe ------------------------------------------------------
    plan = ParallelPlan({"data": 2, "pipe": 4}, device="cpu")
    stages = {"w": torch.from_numpy(inputs["pipe/w"])}
    pipe = PipelinePlanSpec(
        stage_fn=lambda p, mb: torch.tanh(mb @ p["w"]),
        loss_fn=lambda yh, b: ((yh - b[1]) ** 2).mean(), n_microbatches=4)
    pbatch = (torch.from_numpy(inputs["pipe/x"]),
              torch.from_numpy(inputs["pipe/y"]))
    state, losses, _ = _drive(plan, _sgd(0.1), stages, {"w": P("pipe")},
                              None, pbatch, 1, pipeline=pipe)
    out["pipe/loss"] = losses
    _put(out, "pipe/sgd", plan.global_params(state, {"w": P("pipe")}))
    bad = {"w": torch.zeros(4, 4, 4), "b": torch.zeros(4)}
    bad_pipe = PipelinePlanSpec(
        stage_fn=lambda p, mb: torch.tanh(mb @ p["w"] + p["b"]),
        loss_fn=lambda yh, b: (yh ** 2).mean(), n_microbatches=4)
    out["pipe/reject_replicated"] = _raises(
        lambda: plan.compile_train_step(None, _sgd(0.1), bad,
                                        param_specs={"w": P("pipe"),
                                                     "b": P()},
                                        pipeline=bad_pipe),
        ValueError, "pipe-stacked")
    pipe_only = ParallelPlan({"pipe": 8}, device="cpu")
    out["pipe/reject_no_spec"] = _raises(
        lambda: pipe_only.compile_train_step(
            lambda p, b: 0.0, _sgd(0.1), {"w": torch.zeros(8, 2, 2)}),
        ValueError, "PipelinePlanSpec")
    data_only = ParallelPlan({"data": 8}, device="cpu")
    out["pipe/reject_no_axis"] = _raises(
        lambda: data_only.compile_train_step(
            None, _sgd(0.1), {"w": torch.zeros(2, 2)},
            pipeline=PipelinePlanSpec(stage_fn=lambda p, x: x,
                                      loss_fn=lambda y, b: 0.0)),
        ValueError, "no 'pipe' axis")

    # -- pipe x model ----------------------------------------------------
    plan = ParallelPlan({"data": 2, "pipe": 2, "model": 2}, device="cpu")
    pm_model = plan.group("model")

    def pm_stage(p, mb):
        h = copy_to_tp(mb, pm_model) @ p["w"]  # column-parallel
        return torch.tanh(gather_from_tp(h, pm_model, 1))

    pm = PipelinePlanSpec(stage_fn=pm_stage,
                          loss_fn=lambda yh, b: ((yh - b[1]) ** 2).mean(),
                          n_microbatches=2)
    pm_params = {"w": torch.from_numpy(inputs["pm/w"])}
    pm_batch = (torch.from_numpy(inputs["pm/x"]),
                torch.from_numpy(inputs["pm/y"]))
    pm_specs = {"w": P("pipe", "model")}
    state, out["pm/loss"], _ = _drive(plan, _sgd(0.1), pm_params, pm_specs,
                                      None, pm_batch, 1, pipeline=pm)
    _put(out, "pm/sgd", plan.global_params(state, pm_specs))
    out["pm/group"] = np.array("pipe+model" in state.opt_state)
    astate = plan.create_train_state(pm_params, _adamw, param_specs=pm_specs)
    astep = plan.compile_train_step(None, _adamw, pm_params,
                                    param_specs=pm_specs, pipeline=pm)
    astate, _ = astep(astate, plan.local_batch(pm_batch))
    leaf = plan.state_tree(astate, pm_specs)["opt_state"]["pipe+model"][
        "state"][0]["exp_avg"]
    out["pm/state_shape"] = np.array(tuple(leaf.shape))
    out["pm/reject_order"] = _raises(
        lambda: plan.param_specs({"w": torch.zeros(2, 2, 4, 4)},
                                 {"w": P("model", "pipe")}),
        ValueError, "canonical order")
    out["pm/reject_lead"] = _raises(
        lambda: plan.param_specs({"w": torch.zeros(2, 3, 4)}, pm_specs),
        ValueError, "leading dim")

    # -- the zero state: 1/n a rank, and a checkpoint round trip --------
    plan = ParallelPlan({"zero": 8}, device="cpu")
    w = {"w": torch.ones(64, 8) * 0.1}
    state = plan.create_train_state(w, _adamw)
    step = plan.compile_train_step(lambda p, b: ((b @ p["w"]) ** 2).mean(),
                                   _adamw, w)
    state, _ = step(state, plan.local_batch(torch.ones(16, 64)))
    st = state.opt_state["zero"].state_dict()["state"][0]
    out["zero8/local_numel"] = np.array(st["exp_avg"].numel())
    out["zero8/global_shape"] = np.array(tuple(
        plan.state_tree(state)["opt_state"]["zero"]["state"][0][
            "exp_avg"].shape))

    comm = create_communicator("naive")
    plan = ParallelPlan({"data": 2, "zero": 4}, device="cpu")
    state = plan.create_train_state(mlp, _adamw)
    step = plan.compile_train_step(_mlp_loss, _adamw, mlp)
    state, _ = step(state, plan.local_batch(batch))
    with tempfile.TemporaryDirectory() as tmp:
        path = comm.bcast_obj(tmp if comm.rank == 0 else None)
        ckpt = create_multi_node_checkpointer("plan", comm, path=path)
        ckpt.save(plan.state_tree(state), 1)
        template = plan.create_train_state(mlp, _adamw)
        restored, it = plan.load_checkpoint(ckpt, template)
        out["ckpt/iteration"] = np.array(it)
        out["ckpt/files"] = np.array(len(os.listdir(path)))
        s_live, m_live = step(state, plan.local_batch(batch))
        s_rest, m_rest = step(restored, plan.local_batch(batch))
        comm.barrier()
    out["ckpt/loss"] = np.array([float(m_live["loss"]),
                                 float(m_rest["loss"])])
    _put(out, "ckpt/live", plan.global_params(s_live))
    _put(out, "ckpt/rest", plan.global_params(s_rest))
    # a state restored from nothing keeps its (empty) optimizer state
    fresh = plan.create_train_state(mlp, _adamw)
    with tempfile.TemporaryDirectory() as tmp:
        path = comm.bcast_obj(tmp if comm.rank == 0 else None)
        empty = create_multi_node_checkpointer("none", comm, path=path)
        _, none_it = plan.load_checkpoint(empty, fresh)
        comm.barrier()
    out["ckpt/none"] = np.array([none_it is None,
                                 not fresh.opt_state["zero"].state])

    # -- make_train_step(plan=) and the optimizer unwrap --------------
    plan = ParallelPlan({"data": 2, "zero": 4}, device="cpu")
    wp = {"w": torch.ones(8, 8) * 0.1}

    def w_loss(p, b):
        return ((b @ p["w"]) ** 2).mean()

    xs = torch.from_numpy(inputs["x"])
    step = make_train_step(w_loss, _adamw, plan=plan)
    state = plan.create_train_state(wp, _adamw)
    for _ in range(2):
        state, m = step(state, plan.local_batch(xs))
    out["mts/loss"] = np.array(float(m["loss"]))
    out["mts/reject_accum"] = _raises(
        lambda: make_train_step(w_loss, _sgd(0.1), plan=plan, accum_steps=2),
        ValueError, "accum_steps")
    out["mts/reject_no_comm"] = _raises(
        lambda: make_train_step(w_loss, _sgd(0.1)), ValueError,
        "communicator")
    out["mts/reject_specs"] = _raises(
        lambda: make_train_step(w_loss, _sgd(0.1), comm,
                                param_specs={"w": P()}), ValueError, "plan")
    pplan = ParallelPlan({"data": 2, "pipe": 4}, device="cpu")
    eye = {"w": torch.stack([torch.eye(8) * 0.5 for _ in range(4)])}
    pstep = make_train_step(None, _sgd(0.1), plan=pplan,
                            param_specs={"w": P("pipe")},
                            pipeline=PipelinePlanSpec(
                                stage_fn=lambda p, mb: torch.tanh(mb @ p["w"]),
                                loss_fn=lambda yh, b: (yh ** 2).mean(),
                                n_microbatches=4))
    pstate = pplan.create_train_state(eye, _sgd(0.1),
                                      param_specs={"w": P("pipe")})
    pstate, m = pstep(pstate, pplan.local_batch(xs))
    out["mts/pipe_loss"] = np.array(float(m["loss"]))

    sgd = _sgd(0.1)
    out["inner/pass"] = np.array(inner_transform(sgd) is sgd)
    holder = torch.nn.Linear(2, 2)
    wrapped = create_multi_node_optimizer(
        torch.optim.SGD(holder.parameters(), lr=0.1), comm)
    made = inner_transform(wrapped)([torch.zeros(2, requires_grad=True)])
    out["inner/unwrap"] = np.array([type(made) is torch.optim.SGD,
                                    made.defaults["lr"] == 0.1])
    out["inner/reject_db"] = _raises(
        lambda: inner_transform(create_multi_node_optimizer(
            torch.optim.SGD(holder.parameters(), lr=0.1), comm,
            double_buffering=True)), ValueError, "double_buffering")
    out["inner/reject_wire"] = _raises(
        lambda: inner_transform(create_multi_node_optimizer(
            torch.optim.SGD(holder.parameters(), lr=0.1), comm,
            allreduce_grad_dtype="bfloat16")), ValueError, "compress")

    # the wrapper given to both entry points: chunked by the PLAN's zero
    # axis (4), not the communicator's size (8)
    wparams = torch.nn.Linear(8, 8)
    wrapped = create_multi_node_optimizer(
        torch.optim.AdamW(wparams.parameters(), **ADAMW), comm)
    state = plan.create_train_state(wp, wrapped)
    step = plan.compile_train_step(w_loss, wrapped, wp)
    state, m = step(state, plan.local_batch(xs))
    out["unwrap/loss"] = np.array(float(m["loss"]))
    out["unwrap/chunk"] = np.array(
        state.opt_state["zero"].state_dict()["state"][0]["exp_avg"].numel())

    # the plan step against the communicator path, {'data': 8}
    plan = ParallelPlan({"data": 8}, device="cpu")
    p_state = plan.create_train_state(mlp, _adamw)
    p_step = make_train_step(_mlp_loss, _adamw, plan=plan)
    cparams = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(v.clone()) for k, v in mlp.items()})
    copt = create_multi_node_optimizer(
        torch.optim.AdamW(cparams.parameters(), **ADAMW), comm)
    c_state = create_train_state(cparams, copt, comm)
    c_step = make_train_step(lambda mod, b: _mlp_loss(dict(mod.items()), b),
                             copt, comm)
    for _ in range(2):
        c_state, cm = c_step(c_state, plan.local_batch(batch))
        p_state, pm_ = p_step(p_state, plan.local_batch(batch))
    out["comm/loss"] = np.array([float(cm["loss"]), float(pm_["loss"])])
    out["comm/max_diff"] = np.array(max(
        float((p_state.params[k] - cparams[k]).abs().max()) for k in mlp))
    return out
