"""Rank workers of the port's MoE tests (``tests/test_torch_moe.py``,
``tests/test_torch_moe_lm.py`` and ``tests/test_torch_moe_example.py``).

``chainermn_tpu_torch.testing.run_distributed`` runs each worker in
``size`` spawned gloo processes; a child imports this module before it
runs anything, so it imports no JAX. Each worker runs every case of its
test file in one launch and returns flat ``{name: ndarray}`` results;
the test files compute the JAX package's side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from torch_cross_rank_workers import counted_dist_calls
from torch_tp_workers import (
    ENGINE,
    SAMPLED,
    _flat,
    _refused,
    requests_of,
    serve,
)

#: the torch.distributed calls the MoE tests count
CALLS = ("all_reduce", "all_to_all_single", "all_gather", "broadcast",
         "batch_isend_irecv", "reduce_scatter_tensor",
         "all_gather_into_tensor")
#: the layer cases: (dispatch impl, k, capacity factor, experts a rank)
LAYER_CASES = [(impl, k, cf, eps) for impl in ("einsum", "sort")
               for k in (1, 2) for cf in (0.5, None) for eps in (1, 2)]
#: the plan cases' SGD learning rate and aux-loss weight
LR = 0.1
AUX = 0.01


def case_key(impl, k, cf, eps) -> str:
    return f"{impl}/k{k}/cf{cf}/eps{eps}"


def expert_fn(params, x):
    """The JAX tests' expert: ``tanh(x @ w1) @ w2``."""
    return torch.tanh(x @ params["w1"]) @ params["w2"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _raises(fn, exc, match: str) -> np.ndarray:
    try:
        fn()
    except exc as e:
        return np.array(int(match in str(e)))
    return np.array(0)


def _experts(inputs, e: int) -> dict:
    return {"w1": _t(inputs[f"e{e}/w1"]), "w2": _t(inputs[f"e{e}/w2"])}


def _mine(stacked: dict, rank: int, eps: int) -> dict:
    """This rank's experts: the leaf slice (eps 1) or its [eps, ...]
    stack."""
    if eps == 1:
        return {k: v[rank].clone().requires_grad_() for k, v in
                stacked.items()}
    return {k: v[rank * eps:(rank + 1) * eps].clone().requires_grad_()
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# tests/test_torch_moe.py
# ---------------------------------------------------------------------------

def _layer_cases(inputs, out, n, r):
    from chainermn_tpu_torch.parallel.moe import moe_layer_local

    x_all = _t(inputs["x"])
    t_local = x_all.shape[0] // n
    for impl, k, cf, eps in LAYER_CASES:
        key = case_key(impl, k, cf, eps)
        e = n * eps
        x = x_all[r * t_local:(r + 1) * t_local].clone().requires_grad_()
        rw = _t(inputs[f"router{e}"]).requires_grad_()
        mine = _mine(_experts(inputs, e), r, eps)
        with counted_dist_calls(CALLS) as fwd:
            y, aux = moe_layer_local(x, rw, expert_fn, mine, None,
                                     capacity_factor=cf, k=k,
                                     dispatch_impl=impl,
                                     experts_per_shard=eps,
                                     return_stats=True)
        # this rank's share of the global loss mean(out^2) + AUX * lb:
        # the backward gives the gradient of the sum over the ranks
        loss = (y ** 2).sum() / (n * t_local * y.shape[1]) \
            + AUX * aux["load_balance"] / n
        leaves = [x, rw, *mine.values()]
        with counted_dist_calls(CALLS) as bwd:
            grads = torch.autograd.grad(loss, leaves)
        out[f"layer/{key}/out"] = _np(y)
        for name in ("load_balance", "expert_load", "dropped", "padded",
                     "capacity"):
            out[f"layer/{key}/aux/{name}"] = _np(aux[name])
        out[f"layer/{key}/dx"] = _np(grads[0])
        out[f"layer/{key}/drouter"] = _np(grads[1])
        for name, g in zip(mine, grads[2:]):
            out[f"layer/{key}/d{name}"] = _np(g)
        out[f"layer/{key}/calls/fwd"] = _counts_of(fwd)
        out[f"layer/{key}/calls/bwd"] = _counts_of(bwd)
    # without stats: exactly two all-to-alls forward and two backward
    x = x_all[r * t_local:(r + 1) * t_local].clone().requires_grad_()
    mine = _mine(_experts(inputs, n), r, 1)
    with counted_dist_calls(CALLS) as fwd:
        y = moe_layer_local(x, _t(inputs[f"router{n}"]), expert_fn, mine,
                            None, capacity_factor=None, dispatch_impl="sort")
    with counted_dist_calls(CALLS) as bwd:
        y.sum().backward()
    out["layer/bare/calls/fwd"] = _counts_of(fwd)
    out["layer/bare/calls/bwd"] = _counts_of(bwd)


def _counts_of(c: dict) -> np.ndarray:
    return np.array([c[k] for k in CALLS])


def _edge_cases(inputs, out, n, r):
    from chainermn_tpu_torch.parallel.moe import (
        load_balancing_loss,
        moe_layer_local,
    )

    # capacity 0 with every token choosing expert 0 (zero router)
    x0 = _t(inputs["x0"])
    t0 = x0.shape[0] // n
    xr = x0[r * t0:(r + 1) * t0]
    y, aux = moe_layer_local(xr, torch.zeros(x0.shape[1], n), expert_fn,
                             _mine(_experts(inputs, n), r, 1), None,
                             capacity_factor=0.0, dispatch_impl="sort",
                             return_stats=True)
    out["edge/cap0/out"] = _np(xr + y)
    for name in ("expert_load", "dropped", "capacity"):
        out[f"edge/cap0/{name}"] = _np(aux[name])
    # the aux loss over token-sharded logits is the global one
    lg = _t(inputs["lg"])
    tl = lg.shape[0] // n
    out["edge/lb_sharded"] = _np(load_balancing_loss(
        lg[r * tl:(r + 1) * tl], dist.group.WORLD))
    out["edge/lb_sharded_tuple"] = _np(load_balancing_loss(
        lg[r * tl:(r + 1) * tl], (dist.group.WORLD,)))
    # a router that scores another number of experts than the group hosts
    out["edge/router_mismatch"] = _raises(
        lambda: moe_layer_local(xr, torch.zeros(x0.shape[1], n + 1),
                                expert_fn, _mine(_experts(inputs, n), r, 1),
                                None), ValueError, "hosts")
    # bf16 tokens, an fp32 router and fp32 experts (the JAX test's
    # mixed precision): both impls, the same dtype and values
    xb = _t(inputs["x"])[r * 8:(r + 1) * 8].to(torch.bfloat16)
    rw = _t(inputs[f"router{n}"])
    mine = _mine(_experts(inputs, n), r, 1)
    for impl in ("einsum", "sort"):
        y = moe_layer_local(xb, rw, expert_fn, mine, None,
                            capacity_factor=2.0, k=2, dispatch_impl=impl)
        out[f"edge/bf16/{impl}"] = _np(y)
        out[f"edge/bf16/{impl}/dtype"] = np.array(str(y.dtype))


def _plan_cases(inputs, out, n, r):
    from chainermn_tpu_torch.parallel import stack_tp_params, tp_mlp
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.parallel.plan_specs import P, moe_plan_axis

    d = moe_plan_axis()
    out["plan/provider"] = np.array(
        [d["name"] == "expert", d["stacked"] is True,
         d["state_stacked"] is False,
         d["collectives"] == ("all-to-all", "all-reduce")])
    x, y = _t(inputs["px"]), _t(inputs["py"])
    sgd = functools.partial(torch.optim.SGD, lr=LR)
    for name, axes in (("e8", {"expert": 8}),
                       ("e4d2", {"expert": 4, "data": 2}),
                       ("e4m2", {"expert": 4, "model": 2})):
        plan = ParallelPlan(axes, device="cpu")
        e = plan.axis_size("expert")
        params = {"experts": _experts(inputs, e),
                  "router": _t(inputs[f"router{e}"])}
        specs = {"experts": P("expert"), "router": P()}
        if "model" in axes:
            params.update(w1=stack_tp_params(_t(inputs["tp/w1"]), 2, 1),
                          w2=stack_tp_params(_t(inputs["tp/w2"]), 2, 0),
                          b2=_t(inputs["tp/b2"]))
            specs.update(w1=P("model"), w2=P("model"), b2=P())
        moe_fn, rec = plan.moe_layer(tokens_local=x.shape[0] // e
                                     // plan.dp_size, d_model=x.shape[1],
                                     capacity_factor=None, impl="sort")
        out[f"plan/{name}/record"] = np.array(
            [rec["name"] == "moe_dispatch", rec["winner"] == "sort",
             rec["source"] == "explicit", rec in plan.decisions])
        desc = plan.describe()
        out[f"plan/{name}/describe"] = np.array(
            [desc["moe_dispatch_impl"] == "sort",
             desc["collectives"]["expert"] == ("all-to-all", "all-reduce"),
             desc["batch_spec"] == str(P(plan.dp_axes + ("expert",))),
             desc["mesh"] == axes])

        def loss_fn(p, batch):
            xb, yb = batch
            h = xb
            if "w1" in p:
                h = tp_mlp(xb, p["w1"], None, p["w2"], p["b2"],
                           group=plan.group("model"))
            o, aux = moe_fn(h, p["router"], expert_fn, p["experts"])
            loss = ((h + o - yb) ** 2).mean() + AUX * aux["load_balance"]
            return loss, ({"dropped": aux["dropped"],
                           "expert_load": aux["expert_load"]}, ())

        state = plan.create_train_state(params, sgd, param_specs=specs)
        step = plan.compile_train_step(loss_fn, sgd, params,
                                       param_specs=specs)
        steps = 2 if name == "e8" else 1
        for i in range(steps):
            with counted_dist_calls(CALLS) as calls:
                state, m = step(state, plan.local_batch((x, y)))
            out[f"plan/{name}/loss{i}"] = _np(m["loss"])
        out[f"plan/{name}/calls"] = _counts_of(calls)
        out[f"plan/{name}/dropped"] = _np(m["dropped"])
        out[f"plan/{name}/expert_load"] = _np(m["expert_load"])
        for k, v in pytree_items(plan.global_params(state, specs)):
            out[f"plan/{name}/p/{k}"] = _np(v)
        out[f"plan/{name}/auto"] = _raises(
            lambda: plan.moe_layer(tokens_local=4, d_model=16),
            NotImplementedError, "item 8")
        out[f"plan/{name}/k_exceeds"] = _raises(
            lambda: plan.moe_layer(tokens_local=4, d_model=16, k=e + 1,
                                   impl="sort"), ValueError, "exceeds")
        out[f"plan/{name}/bad_impl"] = _raises(
            lambda: plan.moe_layer(tokens_local=4, d_model=16, impl="dense"),
            ValueError, "'sort', 'einsum' or 'auto'")
    # the forward over 1 and 2 MoE layers: exactly two all-to-alls each
    plan = ParallelPlan({"expert": 8}, device="cpu")
    moe_fn, _ = plan.moe_layer(tokens_local=4, d_model=16,
                               capacity_factor=None, impl="sort")
    mine = {k: v[r] for k, v in _experts(inputs, 8).items()}
    h = plan.local_batch(x)
    for layers in (1, 2):
        with counted_dist_calls(CALLS) as calls, torch.no_grad():
            for _ in range(layers):
                h = h + moe_fn(h, _t(inputs["router8"]), expert_fn,
                               mine)[0]
        out[f"plan/fwd{layers}/a2a"] = np.array(calls["all_to_all_single"])


def pytree_items(tree, prefix=""):
    """``(path, leaf)`` of a nested dict of tensors, ``a/b`` paths."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from pytree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def moe_worker(inputs: dict) -> dict:
    """Every case of tests/test_torch_moe.py on this rank of 8."""
    n, r = dist.get_world_size(), dist.get_rank()
    out = {}
    _layer_cases(inputs, out, n, r)
    _edge_cases(inputs, out, n, r)
    _plan_cases(inputs, out, n, r)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe_lm.py: MoE serving under tensor parallelism
# ---------------------------------------------------------------------------

def moe_lm_worker(inputs: dict) -> dict:
    """MoE TP serving over the world group: streams paged and dense,
    fused and xla, greedy and sampled; the ``torch.distributed`` calls of
    every decode tick of the first run; the refusals and the
    signature."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import ServingEngine
    from torch_tp_workers import LM_CFG, full_lm

    n = dist.get_world_size()
    model = full_lm(inputs, n_experts=int(inputs["n_experts"]),
                    moe_dispatch_impl="sort")
    reqs = requests_of(inputs)
    out = {}
    for layout in ("paged", "dense"):
        for impl in ("fused", "xla"):
            for mode, sampling in (("greedy", {}), ("sampled", SAMPLED)):
                engine = ServingEngine(
                    model, device="cpu", mesh=dist.group.WORLD,
                    decode_impl=layout, decode_attend_impl=impl,
                    **ENGINE, **sampling)
                ticks = []
                if not out:  # count every tick of the first run
                    step = engine.decode_step

                    def counted(step=step):
                        with counted_dist_calls(CALLS) as c:
                            res = step()
                        ticks.append(_counts_of(c))
                        return res

                    engine.decode_step = counted
                streams, _ = serve(engine, reqs)
                for k, v in _flat(streams).items():
                    out[f"{layout}/{impl}/{mode}/{k}"] = v
                if ticks:
                    out["tick_calls"] = np.stack(ticks)
                    blk = engine._decode_model.blocks[0]
                    out["local"] = np.array(
                        [engine._decode_model.num_heads,
                         engine._decode_model.d_ff, blk.moe_w_up.shape[0]])
                    out["signature"] = np.array(engine.expert_signature())
    # the default 'auto' dispatch is refused where a dispatch runs
    auto = full_lm(inputs, n_experts=int(inputs["n_experts"]))
    out["refused/auto"] = np.array(_refused(lambda: ServingEngine(
        auto, device="cpu", mesh=dist.group.WORLD, num_slots=1),
        NotImplementedError))
    odd = TransformerLM(**{**LM_CFG, "n_experts": 3},
                        compute_dtype=torch.float32, device="cpu")
    out["refused/divide"] = np.array(_refused(lambda: ServingEngine(
        odd, device="cpu", mesh=dist.group.WORLD, num_slots=1)))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_moe_example.py
# ---------------------------------------------------------------------------

#: the twin's flags in the comparison runs (the JAX test's batch and
#: width)
TWIN_FLAGS = ["--batchsize", "64", "--width", "32"]


def twin_worker(inputs: dict) -> dict:
    """The twin from the JAX example's exact initial weights (top-1 and
    top-2), and a convergence run from the port's own draws."""
    from chainermn_tpu_torch.examples.moe import train_moe_mlp

    n = dist.get_world_size()
    dense = {k[6:]: _t(v) for k, v in inputs.items()
             if k.startswith("dense/")}
    experts = {k[8:]: _t(v) for k, v in inputs.items()
               if k.startswith("experts/")}
    out = {}
    for topk in (1, 2):
        res = train_moe_mlp.run(
            ["--device", "cpu", "--iterations", str(int(inputs["iterations"])),
             "--topk", str(topk), *TWIN_FLAGS], params=(dense, experts))
        out[f"k{topk}/losses"] = np.array(res["losses"])
        out[f"k{topk}/accs"] = np.array(res["accs"])
    if n == 2:
        res = train_moe_mlp.run(
            ["--device", "cpu", "--iterations", "150", "--batchsize", "128",
             "--width", "32"])
        out["converge/accs"] = np.array(res["accs"])
        out["converge/losses"] = np.array(res["losses"])
    return out
