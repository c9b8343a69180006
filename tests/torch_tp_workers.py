"""Rank workers of the port's tensor-parallel LM, TP serving, TP example,
ZeRO/FSDP and sharded-checkpoint tests.

``chainermn_tpu_torch.testing.run_distributed`` runs each worker in
``size`` spawned gloo processes; a child imports this module before it
runs anything, so it imports no JAX. Each worker runs every case of its
test file in one launch and returns flat ``{name: ndarray}`` results; the
test files compute the JAX package's side on an n-device CPU mesh.
"""

from __future__ import annotations

import copy
import numpy as np
import torch
import torch.distributed as dist

from torch_cross_rank_workers import DIST_CALLS, counted_dist_calls

#: the ``torch.distributed`` calls counted here: the cross-rank tests'
#: and the flat all-gather that ZeRO and FSDP use
CALLS = DIST_CALLS + ("all_gather_into_tensor",)

#: the tiny LM of the TP tests (the JAX serving tests' ``tiny_lm`` widths)
LM_CFG = dict(vocab_size=32, num_layers=2, num_heads=4, d_model=16, d_ff=32,
              max_len=32)
#: the serving engines' shape (tests/test_serving.py's TP engines)
ENGINE = dict(num_slots=3, max_len=32, kv_block_size=8,
              prefill_buckets=(4, 8))
SAMPLED = dict(temperature=0.8, top_k=8, base_seed=42)


def _state(inputs: dict, prefix: str = "state/") -> dict:
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in inputs.items() if k.startswith(prefix)}


def full_lm(inputs: dict, prefix: str = "state/", **kw):
    """The full fp32 LM on the CPU with the weights the test sent."""
    from chainermn_tpu_torch.models import TransformerLM

    cfg = {**LM_CFG, **kw}
    model = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(_state(inputs, prefix))
    return model


def _counts(c: dict) -> np.ndarray:
    return np.array([c[k] for k in CALLS])


# ---------------------------------------------------------------------------
# the tensor-parallel LM: logits and gradients
# ---------------------------------------------------------------------------

def tp_lm_worker(inputs: dict) -> dict:
    """This rank's shard of the LM (flash attention over packed segments):
    logits, the gradient of ``sum(logits * cot)`` of every local leaf,
    and the ``torch.distributed`` calls of the forward and the
    backward."""
    from chainermn_tpu_torch.ops.flash_attention import flash_attention
    from chainermn_tpu_torch.serving import tp_local_model

    model = full_lm(inputs, attention_fn=flash_attention)
    local = tp_local_model(model, dist.group.WORLD)
    tokens = torch.from_numpy(inputs["tokens"]).long()
    seg = torch.from_numpy(inputs["seg"])
    cot = torch.from_numpy(inputs["cot"])
    with counted_dist_calls(CALLS) as fwd:
        logits = local(tokens, segment_ids=seg)
    with counted_dist_calls(CALLS) as bwd:
        (logits * cot).sum().backward()
    out = {"logits": logits.detach().numpy(),
           "calls/forward": _counts(fwd), "calls/backward": _counts(bwd)}
    for name, p in local.named_parameters():
        out[f"grad/{name}"] = p.grad.numpy()
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------

def requests_of(inputs: dict) -> list:
    news = inputs["reqs/new"]
    return [(inputs[f"reqs/prompt{i}"].tolist(), int(g))
            for i, g in enumerate(news)]


def serve(engine, reqs, policy: str = "prefill_priority"):
    """``(streams, request ids)`` of ``reqs`` through a Scheduler."""
    from chainermn_tpu_torch.serving import Request, Scheduler

    sched = Scheduler(engine, policy=policy)
    ids = [sched.submit(Request(prompt=p, max_new_tokens=g))
           for p, g in reqs]
    results = sched.run()
    return [results[rid]["tokens"] for rid in ids], ids


def _flat(streams) -> dict:
    return {"tokens": np.concatenate([np.asarray(s, np.int64)
                                      for s in streams]),
            "lens": np.array([len(s) for s in streams])}


def _refused(fn, exc=ValueError) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def tp_serving_worker(inputs: dict) -> dict:
    """Streams of the TP engine over the world group, paged and dense,
    fused and xla, greedy and sampled; the ``torch.distributed`` calls
    of every decode tick of the first run; the refusals."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import Scheduler, ServingEngine

    n = dist.get_world_size()
    model = full_lm(inputs)
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
                        ticks.append(_counts(c))
                        return res

                    engine.decode_step = counted
                streams, _ = serve(engine, reqs)
                for k, v in _flat(streams).items():
                    out[f"{layout}/{impl}/{mode}/{k}"] = v
                if ticks:
                    out["tick_calls"] = np.stack(ticks)
                    out["local_heads"] = np.array(
                        [engine._decode_model.num_heads,
                         engine._decode_model.kv_heads,
                         engine._decode_model.d_ff])
                    out["cache_shape"] = np.array(
                        engine._cache[0]["pool_key"].shape)
    # heads, kv heads or d_ff that the group size does not divide
    bad = (dict(num_heads=3, d_model=18) if n == 2
           else dict(num_kv_heads=2))
    odd = TransformerLM(**{**LM_CFG, **bad}, compute_dtype=torch.float32,
                        device="cpu")
    out["refused/divide"] = np.array(_refused(lambda: ServingEngine(
        odd, device="cpu", mesh=dist.group.WORLD, num_slots=1)))
    engine = ServingEngine(model, device="cpu", mesh=dist.group.WORLD,
                           **ENGINE)
    out["refused/max_seconds"] = np.array(_refused(
        lambda: Scheduler(engine).run(max_seconds=1.0)))
    return out


# ---------------------------------------------------------------------------
# ZeRO and FSDP
# ---------------------------------------------------------------------------

ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
ZERO_PARAMS = ("w1", "b1", "w2")


def _share(x: torch.Tensor, n: int, r: int) -> torch.Tensor:
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _zero_loss(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return ((h @ p["w2"] - y) ** 2).mean()


def zero_fsdp_worker(inputs: dict) -> dict:
    """tests/test_zero.py's and tests/test_fsdp.py's cases on this rank:
    ZeRO over the world group (3 AdamW steps on each rank's share of the
    batch; the state's chunk lengths and placements), FSDP of the MLP (3
    steps; the local shards' shapes), a module buffer riding along, and
    the ``torch.distributed`` calls of one ZeRO step."""
    import functools

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.parallel.fsdp import (
        create_fsdp_train_state,
        make_fsdp_train_step,
    )
    from chainermn_tpu_torch.parallel.zero import (
        zero_shard_optimizer,
        zero_state_specs,
    )

    comm = create_communicator("naive")
    n, r = comm.size, comm.rank
    out = {}
    make = functools.partial(torch.optim.AdamW, **ADAMW)

    # ZeRO: the JAX test's odd-shaped leaves
    start = {k: torch.from_numpy(inputs[f"zero/{k}"]) for k in ZERO_PARAMS}
    params = {k: v.clone().requires_grad_() for k, v in start.items()}
    x = _share(torch.from_numpy(inputs["zero/x"]), n, r)
    y = _share(torch.from_numpy(inputs["zero/y"]), n, r)
    opt = zero_shard_optimizer(make, params.values(), comm)
    for i in range(3):
        opt.zero_grad()
        _zero_loss(params, x, y).backward()
        if i == 2:
            with counted_dist_calls(CALLS) as calls:
                opt.step()
            out["zero/calls"] = _counts(calls)
        else:
            opt.step()
    for k in ZERO_PARAMS:
        out[f"zero/{k}"] = params[k].detach().numpy().copy()
    # a load between steps: the step takes the parameters' new values, as
    # an optimizer built over them with the same state does
    state = copy.deepcopy(opt.state_dict())
    with torch.no_grad():
        for k in ZERO_PARAMS:
            params[k].copy_(start[k])
    twin_params = {k: v.clone().requires_grad_() for k, v in start.items()}
    twin = zero_shard_optimizer(make, twin_params.values(), comm)
    twin.load_state_dict(state)
    for o, ps in ((opt, params), (twin, twin_params)):
        o.zero_grad()
        _zero_loss(ps, x, y).backward()
        o.step()
    out["zero/reload_equal"] = np.array(all(
        torch.equal(params[k], twin_params[k]) for k in ZERO_PARAMS))
    state = state["state"]
    specs = zero_state_specs(opt)
    for i, k in enumerate(ZERO_PARAMS):
        out[f"zero/mu/{k}"] = np.array(state[i]["exp_avg"].shape)
        out[f"zero/spec/{k}"] = np.array(
            [repr(specs[i]["exp_avg"][0]), repr(specs[i]["step"][0])])

    # FSDP: the MLP at n_units 64, 3 AdamW steps
    def loss_fn(model, batch):
        return torch.nn.functional.cross_entropy(model(batch[0]), batch[1])

    model = MLP(n_units=64, n_out=4, in_features=10, device="cpu")
    model.load_state_dict(_state(inputs, "fsdp/sd/"))
    state, placements = create_fsdp_train_state(model, make, comm,
                                                min_size=2**8)
    step = make_fsdp_train_step(loss_fn, state.optimizer, comm, placements)
    xb = _share(torch.from_numpy(inputs["fsdp/x"]), n, r)
    yb = _share(torch.from_numpy(inputs["fsdp/y"]), n, r).long()
    losses = []
    for _ in range(3):
        state, metrics = step(state, (xb, yb))
        losses.append(float(metrics["loss"]))
    out["fsdp/losses"] = np.array(losses)
    for name, p in state.model.named_parameters():
        out[f"fsdp/p/{name}"] = p.full_tensor().detach().numpy()
        out[f"fsdp/local/{name}"] = np.array(p.to_local().shape)
        out[f"fsdp/placement/{name}"] = np.array(repr(p.placements[0]))
    mom = state.optimizer.state[state.model.dense1.weight]["exp_avg"]
    out["fsdp/exp_avg_local"] = np.array(mom.to_local().shape)

    # a buffer the forward updates rides along replicated (the JAX
    # model_state): each rank counts its own rows, the step averages
    small = MLP(n_units=32, n_out=4, in_features=10, device="cpu")
    small.register_buffer("seen", torch.zeros(()))

    def counting_loss(m, batch):
        m.seen += batch[0].shape[0] * (r + 1)
        return loss_fn(m, batch)

    st, pl = create_fsdp_train_state(
        small, functools.partial(torch.optim.SGD, lr=1e-2), comm,
        min_size=2**8)
    st, metrics = make_fsdp_train_step(counting_loss, st.optimizer, comm,
                                       pl)(st, (xb[:16 // n], yb[:16 // n]))
    out["fsdp/seen"] = small.seen.numpy()
    out["fsdp/seen_loss"] = metrics["loss"].numpy()
    return out


# ---------------------------------------------------------------------------
# the checkpointer's sharded leaves
# ---------------------------------------------------------------------------

def _sharded_tree(inputs, mesh):
    from torch.distributed.tensor import Shard, distribute_tensor

    return {"params": {
        "w": distribute_tensor(torch.from_numpy(inputs["ckpt/w"]), mesh,
                               [Shard(0)]),
        "b": torch.from_numpy(inputs["ckpt/b"])}}


def _fsdp_run(inputs, comm, steps, *, ckpt_dir=None, save_at=None,
              resume=False, resize=False):
    """FSDP of the MLP over ``comm``: ``steps`` AdamW steps, saving the
    state at ``save_at`` (or, with ``resume``, loading it first)."""
    import functools

    from chainermn_tpu_torch import create_multi_node_checkpointer
    from chainermn_tpu_torch.models import MLP
    from chainermn_tpu_torch.parallel.fsdp import (
        create_fsdp_train_state,
        make_fsdp_train_step,
    )

    def loss_fn(model, batch):
        return torch.nn.functional.cross_entropy(model(batch[0]), batch[1])

    model = MLP(n_units=64, n_out=4, in_features=10, device="cpu")
    model.load_state_dict(_state(inputs, "fsdp/sd/"))
    state, pl = create_fsdp_train_state(
        model, functools.partial(torch.optim.AdamW, **ADAMW), comm,
        min_size=2**8)
    step = make_fsdp_train_step(loss_fn, state.optimizer, comm, pl)
    ckpt = (create_multi_node_checkpointer("fsdp", comm, path=ckpt_dir)
            if ckpt_dir else None)
    start = 0
    if resume:
        state, start = ckpt.maybe_load(state, allow_world_resize=resize)
    n, r = comm.size, comm.rank
    xs = torch.from_numpy(inputs["fsdp/x"])
    ys = torch.from_numpy(inputs["fsdp/y"]).long()
    losses = []
    for i in range(start, steps):
        rows = torch.roll(torch.arange(xs.shape[0]), 3 * i)
        batch = (_share(xs[rows], n, r), _share(ys[rows], n, r))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if ckpt is not None and save_at == i + 1:
            ckpt.save(state, i + 1)
    return state, losses, start


def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).detach().numpy()


def sharded_ckpt_worker(inputs: dict) -> dict:
    """The keys this rank writes for a sharded tree; reading the JAX
    package's sharded snapshot (same world size and resized); an FSDP
    resume at this world size; and, given ``resize_from``, the FSDP state
    another world size saved, restored here."""
    from chainermn_tpu_torch import create_multi_node_checkpointer
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.parallel.fsdp import device_mesh

    comm = create_communicator("naive")
    n = comm.size
    mesh = device_mesh(comm, "cpu")
    out = {}
    root = str(inputs["dir"])

    ck = create_multi_node_checkpointer("keys", comm, path=root + "/keys")
    ck.save(_sharded_tree(inputs, mesh), 5)
    with np.load(ck._fname(5)) as f:
        out["keys"] = np.array(sorted(k for k in f.files
                                      if k != "__leaves__"))
    back, it = ck.maybe_load(_sharded_tree(
        {"ckpt/w": np.zeros_like(inputs["ckpt/w"]),
         "ckpt/b": np.zeros_like(inputs["ckpt/b"])}, mesh))
    out["keys/it"] = np.array(it)
    out["keys/w"] = back["params"]["w"].to_local().numpy()

    # the JAX package's files, at this world size and at another
    for tag in ("jax_same", "jax_other"):
        ck = create_multi_node_checkpointer("jaxsharded", comm,
                                            path=str(inputs[f"{tag}_dir"]))
        zeros = _sharded_tree(
            {"ckpt/w": np.zeros_like(inputs["ckpt/w"]),
             "ckpt/b": np.zeros_like(inputs["ckpt/b"])}, mesh)
        got, it = ck.maybe_load(zeros, allow_world_resize=tag == "jax_other")
        out[f"{tag}/it"] = np.array(it)
        out[f"{tag}/w_local"] = got["params"]["w"].to_local().numpy()
        out[f"{tag}/w"] = _full(got["params"]["w"])
        out[f"{tag}/b"] = got["params"]["b"].numpy()

    # an FSDP resume: 4 steps without a stop, against 2 + save + 2
    _, ref, _ = _fsdp_run(inputs, comm, 4)
    _, first, _ = _fsdp_run(inputs, comm, 2, ckpt_dir=root + "/fsdp",
                            save_at=2)
    state, rest, start = _fsdp_run(inputs, comm, 4, ckpt_dir=root + "/fsdp",
                                   resume=True)
    out["resume/ref"] = np.array(ref)
    out["resume/got"] = np.array(first + rest)
    out["resume/start"] = np.array(start)

    # the resize: this world saves, or restores what another world saved
    rdir = str(inputs["resize_dir"])
    if int(inputs["resize_save"]) == n:
        state, _, _ = _fsdp_run(inputs, comm, 2, ckpt_dir=rdir, save_at=2)
    else:
        state, _, start = _fsdp_run(inputs, comm, 2, ckpt_dir=rdir,
                                    resume=True, resize=True)
        out["resize/start"] = np.array(start)
    for name, p in state.model.named_parameters():
        out[f"resize/p/{name}"] = _full(p)
        out[f"resize/placement/{name}"] = np.array(repr(p.placements[0]))
    mom = state.optimizer.state[state.model.dense1.weight]
    out["resize/exp_avg"] = _full(mom["exp_avg"])
    out["resize/step"] = np.array(float(mom["step"]))
    return out


# ---------------------------------------------------------------------------
# the tensor-parallel example twin
# ---------------------------------------------------------------------------

#: the twin's runs per world size: (name, flags)
EXAMPLE_RUNS = {2: (("dp1_tp2", ["--dp", "1"]), ("dp2_tp1", [])),
                4: (("dp2_tp2", []), ("dp1_tp4", ["--dp", "1"]))}


def tp_example_worker(inputs: dict) -> dict:
    """The twin's losses for this world size's runs (gloo, on the CPU)."""
    from chainermn_tpu_torch.examples.tensor_parallel import (
        train_tp_transformer as twin,
    )

    iters = str(int(inputs["iterations"]))
    out = {}
    for name, flags in EXAMPLE_RUNS[dist.get_world_size()]:
        res = twin.main(["--device", "cpu", "--iterations", iters, *flags])
        out[name] = np.array(res["losses"])
    return out
