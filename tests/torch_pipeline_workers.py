"""Rank workers of the port's pipeline tests: the GPipe engines (plain,
interleaved, rematerialised, heterogeneous), 1F1B, their compositions
with data and tensor parallelism, the pipelined Transformer blocks, the
example twin and the mesh.

``chainermn_tpu_torch.testing.run_distributed`` runs each worker in
``size`` spawned gloo processes; a child imports this module before it
runs anything, so it imports no JAX. Each worker runs every case of its
test file in one launch and returns flat ``{name: ndarray}`` results.
The inputs of every case are drawn here with numpy (:func:`case`), so the
test files feed the same arrays to the JAX package's engines on an
n-device CPU mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch.convert import stage_params_from_stack
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel import pipeline as pl
from torch_cross_rank_workers import counted_dist_calls

#: the width of the MLP stages (tests/test_pipeline.py's DIM)
D = 8
#: the transfers and broadcasts the engines make
CALLS = ("batch_isend_irecv", "broadcast", "all_reduce")

#: the GPipe cases: name -> (microbatches (None: the stage count),
#: virtual stages, remat, seed); "plain" and "remat" share their inputs
GPIPE = {"m8": (8, 1, False, 1), "m16": (16, 1, False, 2),
         "v2m8": (8, 2, False, 3), "v2m16": (16, 2, False, 4),
         "v3m8": (8, 3, False, 5), "remat": (None, 1, True, 6),
         "plain": (None, 1, False, 6)}
#: the seed of the pipeline_local case
LOCAL_SEED = 7
# the 1F1B cases: name -> (microbatches, batch)
ONE_F_ONE_B = {"m8": (8, 32), "m16": (16, 32), "m1": (1, 4)}
#: the hetero LM stages' widths (tests/test_pipeline.py::TestHeteroPipeline)
HT, HD, HV = 4, 8, 16


def case(n_stages: int, seed: int, batch: int = 32) -> dict:
    """Numpy inputs of one case: ``n_stages`` stage params (``w``
    ``[D, D]``, ``b`` ``[D]``), the batch ``x`` and targets ``y``
    ``[batch, D]``, and an embed ``w_in`` and a head ``w_out`` ``[D, D]``
    outside the pipeline."""
    rs = np.random.RandomState(seed)
    f = np.float32
    return {
        "stages": [{"w": (rs.randn(D, D) / np.sqrt(D)).astype(f),
                    "b": (0.1 * rs.randn(D)).astype(f)}
                   for _ in range(n_stages)],
        "x": rs.randn(batch, D).astype(f),
        "y": rs.randn(batch, D).astype(f),
        "w_in": (0.5 * rs.randn(D, D)).astype(f),
        "w_out": (0.5 * rs.randn(D, D)).astype(f),
    }


def hetero_case(n_stages: int, seed: int, batch: int = 16) -> dict:
    """The hetero LM of tests/test_pipeline.py: embed ``[V, D]``, blocks
    ``w`` ``[D, D]`` and ``b``, a head ``[D, V]``; tokens and labels
    ``[batch, T]``."""
    rs = np.random.RandomState(seed)
    f = np.float32
    params = [{"emb": (0.5 * rs.randn(HV, HD)).astype(f)}]
    for _ in range(n_stages - 2):
        params.append({"w": (rs.randn(HD, HD) / np.sqrt(HD)).astype(f),
                       "b": (0.1 * rs.randn(HD)).astype(f)})
    params.append({"out": (0.1 * rs.randn(HD, HV)).astype(f)})
    return {"params": params,
            "tok": rs.randint(0, HV, size=(batch, HT)).astype(np.int64),
            "lab": rs.randint(0, HV, size=(batch, HT)).astype(np.int64)}


def stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def embed_fn(p, tok):
    return p["emb"][tok]


def block_fn(p, h):
    return h + torch.tanh(h @ p["w"] + p["b"])


def head_fn(p, h):
    return h @ p["out"]


def hetero_fns(n: int) -> list:
    return [embed_fn] + [block_fn] * (n - 2) + [head_fn]


def _t(a, grad: bool = True) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _tree(d: dict, grad: bool = True) -> dict:
    return {k: _t(v, grad) for k, v in d.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def _counts(c: dict) -> np.ndarray:
    return np.array([c[k] for k in CALLS])


def _refused(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# GPipe, interleaved, remat, hetero (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

def gpipe_run(c: dict, group, rank: int, n: int, *, n_micro, v, remat,
              out: dict, tag: str) -> None:
    """The case's loss ``mean((pipe(tanh(x @ w_in)) @ w_out - y)^2)`` and
    a backward on this rank: its output, its stage's gradients and the
    embed's and head's, the stats and the calls of each direction."""
    stages = c["stages"]
    if v == 1:
        own = _tree(stages[rank])
    else:
        st = pl.stack_interleaved_stage_params(
            [_tree(s, False) for s in stages], n, v)
        own = {k: t.requires_grad_() for k, t in stage_params_from_stack(
            {k: _np(t) for k, t in st.items()}, rank, v).items()}
    w_in, w_out = _t(c["w_in"]), _t(c["w_out"])
    fn = pl.make_pipeline(stage_fn, group, n_microbatches=n_micro,
                          virtual_stages=v, remat_stages=remat)
    x, y = _t(c["x"], False), _t(c["y"], False)
    with counted_dist_calls(CALLS) as fwd:
        h = fn(own, torch.tanh(x @ w_in))
    loss = ((h @ w_out - y) ** 2).mean()
    with counted_dist_calls(CALLS) as bwd:
        loss.backward()
    out[f"{tag}/y"] = _np(h)
    out[f"{tag}/loss"] = _np(loss)
    for k, t in own.items():
        out[f"{tag}/g/{k}"] = _np(t.grad)
    out[f"{tag}/g/w_in"] = _np(w_in.grad)
    out[f"{tag}/g/w_out"] = _np(w_out.grad)
    out[f"{tag}/stats"] = np.array([fn.stats[k] for k in (
        "ticks", "stage_calls", "saved_inputs")])
    out[f"{tag}/calls/forward"] = _counts(fwd)
    out[f"{tag}/calls/backward"] = _counts(bwd)


def gpipe_worker(inputs: dict) -> dict:
    """Every GPipe and hetero case at this world size."""
    group = dist.group.WORLD
    n, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for tag, (m, v, remat, seed) in GPIPE.items():
        c = case(n * v, seed)
        gpipe_run(c, group, rank, n, n_micro=m or n, v=v, remat=remat,
                  out=out, tag=f"gpipe/{tag}")
    # the inside meaning: pipeline_local's backward sums the ranks'
    # cotangents; unscale_replicated_grads counts the replicated loss once
    c = case(n, LOCAL_SEED)
    x, t = _t(c["x"], False), _t(c["y"], False)
    for how in ("local", "unscaled", "make"):
        own = _tree(c["stages"][rank])
        if how == "make":
            y = pl.make_pipeline(stage_fn, group)(own, x)
        else:
            y = pl.pipeline_local(stage_fn, own, x.reshape(n, -1, D), group)
            if how == "unscaled":
                y = pl.unscale_replicated_grads(y, group)
        ((y.reshape(-1, D) - t) ** 2).mean().backward()
        out[f"local/{how}/g/w"] = _np(own["w"].grad)
    # batch divisibility, refused on every rank before any transfer
    fn = pl.make_pipeline(stage_fn, group, n_microbatches=7)
    out["refused/divisibility"] = np.array(_refused(
        lambda: fn(_tree(c["stages"][rank]), torch.zeros(16, D))))
    out["refused/virtual"] = np.array(_refused(lambda: pl.make_pipeline(
        stage_fn, group, virtual_stages=2)(_tree(c["stages"][rank]),
                                           torch.zeros(2 * n, D))))
    # no grad: no graph is kept, the same output
    with torch.no_grad():
        y0 = pl.make_pipeline(stage_fn, group, n_microbatches=n)(
            _tree(c["stages"][rank], False), _t(c["x"], False))
    out["nograd/y"] = _np(y0)
    hetero_cases(group, rank, n, out)
    # the gloo transport through a host copy (CUDA tensors on a gloo
    # group) gives the same values and gradients as the direct one
    xs = _t(c["x"][rank * 2:rank * 2 + 2])
    for staged in (False, True):
        keep = C._stage_through_host
        C._stage_through_host = (lambda t, g: True) if staged else keep
        try:
            xx = xs.detach().clone().requires_grad_()
            y = C.ppermute(xx, group, [(i, (i + 1) % n) for i in range(n)])
            (y * y).sum().backward()
        finally:
            C._stage_through_host = keep
        out[f"staged{int(staged)}/y"] = _np(y)
        out[f"staged{int(staged)}/g"] = _np(xx.grad)
    return out


def hetero_cases(group, rank: int, n: int, out: dict) -> None:
    fns = hetero_fns(n)
    c = hetero_case(n, seed=11)
    fn = pl.make_pipeline_hetero(fns, group, n_microbatches=8)
    with torch.no_grad():
        out["hetero/values"] = _np(fn([_tree(p, False)
                                       for p in c["params"]],
                                      _t(c["tok"], False)))
    c = hetero_case(n, seed=12)
    params = [_tree(p) for p in c["params"]]
    fn = pl.make_pipeline_hetero(fns, group, n_microbatches=8,
                                 remat_stages=True)
    logits = fn(params, _t(c["tok"], False))
    F.cross_entropy(logits.reshape(-1, HV),
                    _t(c["lab"], False).reshape(-1)).backward()
    out["hetero/logits"] = _np(logits)
    for s, p in enumerate(params):
        for k, t in p.items():
            out[f"hetero/g/{s}/{k}"] = _np(t.grad)
    out["hetero/stats"] = np.array([fn.stats[k] for k in (
        "ticks", "stage_calls", "saved_inputs")])

    def widen(p, h):  # breaks activation homogeneity
        return torch.cat([h, h], dim=-1)

    if n > 2:
        bad = list(fns)
        bad[1] = widen
        c = hetero_case(n, seed=11)
        with counted_dist_calls(CALLS) as calls:
            out["refused/conveyor"] = np.array(_refused(
                lambda: pl.make_pipeline_hetero(bad, group)(
                    [_tree(p, False) for p in c["params"]],
                    torch.zeros(16, HT, dtype=torch.int64))))
        out["refused/conveyor/calls"] = _counts(calls)
    # a scalar per microbatch cannot be reassembled into the batch
    scalar = list(fns)
    scalar[-1] = lambda p, h: (h @ p["out"]).sum()
    c = hetero_case(n, seed=11)
    out["refused/bank"] = np.array(_refused(
        lambda: pl.make_pipeline_hetero(scalar, group)(
            [_tree(p, False) for p in c["params"]],
            torch.zeros(16, HT, dtype=torch.int64))))


def mesh_worker(inputs: dict) -> dict:
    """``make_mesh`` at this world size: the shapes, names and groups of
    the default and given layouts, the refusal, and MeshTopology."""
    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.parallel.mesh import MeshTopology, make_mesh

    out = {}
    for axes, shape in ((("data",), None), (("data", "stage"), None),
                        (("data", "stage", "model"), None),
                        (("data", "stage"), (1, dist.get_world_size()))):
        m = make_mesh(axes, shape, device="cpu")
        key = "x".join(axes) + ("" if shape is None else "/given")
        out[f"{key}/shape"] = np.array(m.shape)
        out[f"{key}/names"] = np.array(m.mesh_dim_names)
        for a in axes:
            out[f"{key}/group/{a}"] = np.array(
                dist.get_process_group_ranks(m.get_group(a)))
    out["refused"] = np.array(_refused(
        lambda: make_mesh(("data",), (3,), device="cpu")))
    comm = create_communicator("naive", device="cpu")
    topo = MeshTopology(make_mesh(("data", "stage"), device="cpu"), comm)
    out["topology"] = np.array([topo.size, topo.rank, topo.inter_size,
                                topo.inter_rank, topo.intra_size,
                                topo.intra_rank, topo.axis_size("data"),
                                topo.axis_size("stage")])
    bare = MeshTopology(make_mesh(("data",), device="cpu"))
    out["topology/bare"] = np.array([bare.intra_size, bare.intra_rank])
    return out


# ---------------------------------------------------------------------------
# 1F1B, dp x pp, dp x pp x tp (tests/test_torch_pipeline_1f1b.py)
# ---------------------------------------------------------------------------

#: the 1F1B memory case (tests/test_pipeline.py: M 32 microbatches)
MEM_MICRO, MEM_BATCH = 32, 64
#: the 3-D case's widths (tests/test_pipeline.py::test_3d_composition)
TD, TFF, T_BATCH, T_MICRO = 8, 16, 16, 4


def loss_grad(loss_fn):
    """``loss_grad_fn(y_mb, t_mb) -> (loss, dy)`` of a per-microbatch
    loss (``jax.value_and_grad``'s role)."""
    def lg(y, t):
        with torch.enable_grad():
            y = y.detach().requires_grad_()
            loss = loss_fn(y, t)
            (dy,) = torch.autograd.grad(loss, y)
        return loss.detach(), dy
    return lg


def mse(y, t):
    return ((y - t) ** 2).mean()


def pos_stage(p, x):
    return torch.sigmoid(x @ p["w"] + p["b"]) + 0.5  # outputs in [0.5, 1.5]


def pole_loss(y, t):
    return -(t * torch.log(y)).mean()  # pole at y == 0


def head_loss_grad(w, y, t):
    with torch.enable_grad():
        w = w.detach().requires_grad_()
        y = y.detach().requires_grad_()
        loss = (((y @ w) - t) ** 2).mean()
        dw, dy = torch.autograd.grad(loss, (w, y))
    return loss.detach(), (dw, dy)


def pole_targets(seed: int, batch: int) -> np.ndarray:
    z = np.random.RandomState(seed).randn(batch, D)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _traced(fn, trace: list):
    def call(p, x):
        trace.append("op")
        return fn(p, x)
    return call


def onef1b_worker(inputs: dict) -> dict:
    """Every 1F1B case at this world size over the world group."""
    group = dist.group.WORLD
    n, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for tag, (m, batch) in ONE_F_ONE_B.items():
        c = case(n, seed=20 + m, batch=batch)
        trace = []
        fn = pl.make_pipeline_1f1b(_traced(stage_fn, trace), loss_grad(mse),
                                   group, n_microbatches=m)
        keep = dist.batch_isend_irecv

        def send(ops):
            trace.append("transfer")
            return keep(ops)

        dist.batch_isend_irecv = send
        try:
            with counted_dist_calls(CALLS) as calls:
                loss, grads = fn(_tree(c["stages"][rank], False),
                                 _t(c["x"], False), _t(c["y"], False))
        finally:
            dist.batch_isend_irecv = keep
        out[f"1f1b/{tag}/loss"] = _np(loss)
        for k, g in grads.items():
            out[f"1f1b/{tag}/g/{k}"] = _np(g)
        out[f"1f1b/{tag}/stats"] = np.array([fn.stats[k] for k in (
            "ticks", "stage_calls", "recomputes", "saved_inputs")])
        out[f"1f1b/{tag}/calls"] = _counts(calls)
        out[f"1f1b/{tag}/trace"] = np.array(trace)
    # a loss with a pole at zero: never evaluated on a zero buffer
    c = case(n, seed=13, batch=16)
    fn = pl.make_pipeline_1f1b(pos_stage, loss_grad(pole_loss), group,
                               n_microbatches=8)
    loss, grads = fn(_tree(c["stages"][rank], False), _t(c["x"], False),
                     _t(pole_targets(15, 16), False))
    out["pole/loss"] = _np(loss)
    for k, g in grads.items():
        out[f"pole/g/{k}"] = _np(g)
    # a trainable head and the input's gradients
    c = case(n, seed=21, batch=16)
    fn = pl.make_pipeline_1f1b(stage_fn, head_loss_grad, group,
                               n_microbatches=8)
    loss, grads, hg, xg = fn(_tree(c["stages"][rank], False),
                             _t(c["x"], False), _t(c["y"], False),
                             _t(0.6 * c["w_out"], False),
                             collect_input_grads=True)
    out["head/loss"] = _np(loss)
    for k, g in grads.items():
        out[f"head/g/{k}"] = _np(g)
    out["head/head"] = _np(hg)
    out["head/x"] = _np(xg)
    # saved inputs per stage: 1F1B's ring against GPipe + remat's one
    # input an execution
    c = case(n, seed=30, batch=MEM_BATCH)
    own, x = _tree(c["stages"][rank]), _t(c["x"], False)
    gp = pl.make_pipeline(stage_fn, group, n_microbatches=MEM_MICRO,
                          remat_stages=True)
    (gp(own, x) ** 2).mean().backward()
    fb = pl.make_pipeline_1f1b(stage_fn, loss_grad(mse), group,
                               n_microbatches=MEM_MICRO)
    fb(_tree(c["stages"][rank], False), x, torch.zeros_like(x))
    out["memory/gpipe"] = np.array(gp.stats["saved_inputs"])
    out["memory/1f1b"] = np.array(fb.stats["saved_inputs"])
    return out


def composed_worker(inputs: dict) -> dict:
    """dp x pp over a (data, stage) mesh of the world (2 x n/2), and at
    8 ranks dp x pp x tp over (data 2, stage 2, model 2)."""
    from chainermn_tpu_torch.parallel.mesh import make_mesh
    from chainermn_tpu_torch.parallel.tensor import stack_tp_params, tp_mlp

    size = dist.get_world_size()
    n = size // 2
    mesh = make_mesh(("data", "stage"), (2, n), device="cpu")
    d = mesh.get_local_rank("data")
    s = mesh.get_local_rank("stage")
    out = {}
    # GPipe values, this data slice's rows
    c = case(n, seed=40, batch=32)
    rows = slice(d * 16, (d + 1) * 16)
    fn = pl.make_pipeline(stage_fn, mesh, axis_name="stage",
                          n_microbatches=4, batch_axis="data")
    out["dp/gpipe/y"] = _np(fn(_tree(c["stages"][s], False),
                               _t(c["x"][rows], False)))
    # 1F1B: loss and stage grads already averaged over the data axis
    c = case(n, seed=42, batch=32)
    fn = pl.make_pipeline_1f1b(stage_fn, loss_grad(mse), mesh,
                               axis_name="stage", n_microbatches=8,
                               batch_axis="data")
    loss, grads = fn(_tree(c["stages"][s], False), _t(c["x"][rows], False),
                     _t(c["y"][rows], False))
    out["dp/1f1b/loss"] = _np(loss)
    for k, g in grads.items():
        out[f"dp/1f1b/g/{k}"] = _np(g)
    # with a trainable head and the input's gradients (this slice's)
    fn = pl.make_pipeline_1f1b(stage_fn, head_loss_grad, mesh,
                               axis_name="stage", n_microbatches=8,
                               batch_axis="data")
    loss, grads, hg, xg = fn(_tree(c["stages"][s], False),
                             _t(c["x"][rows], False), _t(c["y"][rows], False),
                             _t(0.6 * c["w_out"], False),
                             collect_input_grads=True)
    out["dp/head/loss"] = _np(loss)
    out["dp/head/g/w"] = _np(grads["w"])
    out["dp/head/head"] = _np(hg)
    out["dp/head/x"] = _np(xg)
    # hetero with a batch axis: values of this slice's rows
    hc = hetero_case(n, seed=50)
    fn = pl.make_pipeline_hetero(hetero_fns(n), mesh, axis_name="stage",
                                 n_microbatches=4, batch_axis="data")
    with torch.no_grad():
        out["dp/hetero/y"] = _np(fn([_tree(p, False) for p in hc["params"]],
                                    _t(hc["tok"][d * 8:(d + 1) * 8], False)))
    if size == 8:
        mesh3 = make_mesh(("data", "stage", "model"), (2, 2, 2), device="cpu")
        d3, s3, m3 = (mesh3.get_local_rank(a)
                      for a in ("data", "stage", "model"))
        model = mesh3.get_group("model")
        full = tp_case()
        own = {"w1": stack_tp_params(_t(full[s3]["w1"], False), 2, 1)[m3],
               "w2": stack_tp_params(_t(full[s3]["w2"], False), 2, 0)[m3]}

        def tp_stage(p, x):
            return x + tp_mlp(x, p["w1"], None, p["w2"], None, group=model)

        xt, tt = tp_data()
        per = T_BATCH // 2
        fn = pl.make_pipeline_1f1b(tp_stage, loss_grad(mse), mesh3,
                                   axis_name="stage", n_microbatches=T_MICRO,
                                   batch_axis="data")
        loss, grads = fn(own, _t(xt[d3 * per:(d3 + 1) * per], False),
                         _t(tt[d3 * per:(d3 + 1) * per], False))
        out["3d/loss"] = _np(loss)
        out["3d/g/w1"] = _np(grads["w1"])
        out["3d/g/w2"] = _np(grads["w2"])
        out["3d/coords"] = np.array([d3, s3, m3])
    return out


def tp_case() -> list:
    """The 3-D case's two full stages ``w1`` ``[D, FF]``, ``w2`` ``[FF,
    D]``."""
    rs = np.random.RandomState(60)
    return [{"w1": (0.3 * rs.randn(TD, TFF)).astype(np.float32),
             "w2": (0.3 * rs.randn(TFF, TD)).astype(np.float32)}
            for _ in range(2)]


def tp_data():
    rs = np.random.RandomState(64)
    return (rs.randn(T_BATCH, TD).astype(np.float32),
            rs.randn(T_BATCH, TD).astype(np.float32))


# ---------------------------------------------------------------------------
# the pipelined Transformer blocks (tests/test_torch_pipeline_lm.py)
# ---------------------------------------------------------------------------

#: the LM of the pipelined-blocks test: 2 blocks a stage
LM = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=64, d_ff=128,
          max_len=32)
LM_BATCH, LM_MICRO = 4, 2


def _prefixed(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(np.array(v))
            for k, v in inputs.items() if k.startswith(prefix)}


def lm_pieces(model, blocks, *, stage_dtype=None):
    """The pipelined LM's pieces over a port ``TransformerLM``: the
    embedding (tokens and learned positions, in the compute dtype), the
    stage function (this rank's blocks through ``functional_call``) and
    the head (the final norm and the tied embedding)."""
    from torch.func import functional_call

    dt = model.compute_dtype

    def embed(tokens):
        T = tokens.shape[1]
        return model.tok_emb.weight[tokens].to(dt) + model.pos_emb[:T].to(dt)

    def stage(p, x):
        return functional_call(blocks, p, (x,))

    def head(x, params=None):
        """``params``: (final norm weight, its bias, the embedding),
        by default the model's own."""
        w, b, emb = params or (model.ln_f.weight, model.ln_f.bias,
                               model.tok_emb.weight)
        h = functional_call(model.ln_f, {"weight": w, "bias": b}, (x,))
        return F.linear(h.to(dt), emb.to(dt))

    return embed, stage, head


def lm_worker(inputs: dict) -> dict:
    """The LM with its blocks pipelined, 2 a stage: GPipe's loss and every
    gradient (the stage's blocks, and on every rank the embedding, the
    positions and the final norm), then the same step through 1F1B with
    the head as ``head_params`` and the embedding trained through the
    input gradients."""
    from torch import nn

    from chainermn_tpu_torch.models import TransformerLM, lm_loss

    group = dist.group.WORLD
    n, rank = dist.get_world_size(), dist.get_rank()
    per = LM["num_layers"] // n
    model = TransformerLM(**LM, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(_prefixed(inputs, "state/"))
    blocks = nn.Sequential(*model.blocks[rank * per:(rank + 1) * per])
    own = {k: t.requires_grad_() for k, t in
           _prefixed(inputs, f"stage{rank}/").items()}
    tokens = torch.from_numpy(inputs["tokens"]).long()
    embed, stage, head = lm_pieces(model, blocks)
    pipe = pl.make_pipeline(stage, group, n_microbatches=LM_MICRO)
    logits = head(pipe(own, embed(tokens)))
    loss = lm_loss(logits, tokens)
    loss.backward()
    out = {"gpipe/loss": _np(loss), "gpipe/logits": _np(logits)}
    for k, t in own.items():
        out[f"gpipe/g/stage/{k}"] = _np(t.grad)
    for k, t in model.named_parameters():
        if not k.startswith("blocks."):
            out[f"gpipe/g/{k}"] = _np(t.grad)
    # 1F1B: the head (final norm + tied embedding) as head_params
    names = ("ln_f.weight", "ln_f.bias", "tok_emb.weight")
    params = dict(model.named_parameters())

    def head_loss_grad(hp, y, tok):
        with torch.enable_grad():
            hp = [t.detach().requires_grad_() for t in hp]
            y = y.detach().requires_grad_()
            loss = lm_loss(head(y, hp), tok)
            *dh, dy = torch.autograd.grad(loss, [*hp, y])
        return loss.detach(), (tuple(dh), dy)

    engine = pl.make_pipeline_1f1b(stage, head_loss_grad, group,
                                   n_microbatches=LM_MICRO)
    model.zero_grad()
    x = embed(tokens)
    loss, g_stage, g_head, dx = engine(
        own, x.detach(), tokens, tuple(params[k].detach() for k in names),
        collect_input_grads=True)
    g_emb, g_pos = torch.autograd.grad(
        x, [params["tok_emb.weight"], params["pos_emb"]], dx)
    out["1f1b/loss"] = _np(loss)
    for k, g in g_stage.items():
        out[f"1f1b/g/stage/{k}"] = _np(g)
    out["1f1b/g/ln_f.weight"] = _np(g_head[0])
    out["1f1b/g/ln_f.bias"] = _np(g_head[1])
    out["1f1b/g/tok_emb.weight"] = _np(g_head[2] + g_emb)
    out["1f1b/g/pos_emb"] = _np(g_pos)
    return out


# ---------------------------------------------------------------------------
# the example twin (tests/test_torch_pipeline_example.py)
# ---------------------------------------------------------------------------

SCHEDULES = ("gpipe", "1f1b", "hetero")
#: the twin's flags in the example tests (the JAX test's batch and width)
TWIN_FLAGS = ["--batchsize", "64", "--width", "64"]


def twin_worker(inputs: dict) -> dict:
    """The twin's run under each schedule on the CPU: every iteration's
    loss and accuracy."""
    from chainermn_tpu_torch.examples.pipeline import train_pipeline_mlp

    out = {}
    for s in SCHEDULES:
        res = train_pipeline_mlp.run([
            "--device", "cpu", "--iterations", str(int(inputs["iterations"])),
            "--schedule", s, *TWIN_FLAGS])
        out[f"{s}/losses"] = np.array(res["losses"])
        out[f"{s}/accs"] = np.array(res["accs"])
    return out
