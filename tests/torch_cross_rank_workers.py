"""Rank workers of the port's cross-rank tests: the differentiable
functions and collectives, ``MultiNodeChainList``, ``create_mnbn_model``,
the model-parallel MNIST twin and the tensor-parallel layers.

``chainermn_tpu_torch.testing.run_distributed`` runs each worker in
``size`` spawned gloo processes; a child imports this module before it
runs anything, so it imports no JAX. Each worker runs every case of its
test file in one launch and returns flat ``{name: ndarray}`` results.
The cases are named here and in the test files, which compute the JAX
package's side of each on an n-device CPU mesh.
"""

from __future__ import annotations

import contextlib
import re

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch import functions as Fn
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel import tensor as T

#: the ``torch.distributed`` calls the port's cross-rank code makes
DIST_CALLS = ("all_reduce", "all_gather", "broadcast", "reduce",
              "reduce_scatter_tensor", "gather", "scatter", "send", "recv",
              "batch_isend_irecv", "all_to_all_single")


@contextlib.contextmanager
def counted_dist_calls(names=DIST_CALLS):
    """Count the ``torch.distributed`` calls ``names`` made inside the
    block (``counts[name]``); the functions are wrapped in the module,
    which is where the port looks them up."""
    counts = dict.fromkeys(names, 0)
    saved = {name: getattr(dist, name) for name in names}

    def wrap(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(dist, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def pairs(n: int) -> dict:
    """The ranks the function cases use at world size ``n``: a transfer
    ``src -> dst`` and a root."""
    return {"src": n - 1, "dst": n // 2 - 1, "root": n // 2}


# ---------------------------------------------------------------------------
# functions and collectives
# ---------------------------------------------------------------------------

def function_cases(n: int) -> dict:
    """``name -> f(v)``, each rank's part of one differentiable case;
    every rank of the group calls it with its own ``v``."""
    r = pairs(n)
    S, D, R = r["src"], r["dst"], r["root"]

    def send_delegate(v):
        received, delegate = Fn.send(v, D, None, src=S)
        return Fn.recv(received, delegate=delegate)

    def stream(v):
        out = Fn.stream_blocks({"k": v, "v": 2.0 * v}, S, D)
        return out["k"] + 3.0 * out["v"]

    return {
        "send_recv": lambda v: Fn.send_recv(v, S, D),
        "send_recv_self": lambda v: Fn.send_recv(v, 0, 0),
        "send_delegate": send_delegate,
        "pseudo_connect": lambda v: Fn.pseudo_connect(
            Fn.send_recv(v * 2.0, 0, 1).sum() * 0.0, v),
        "stream_blocks": stream,
        "allgather": lambda v: Fn.allgather(v),
        "allgather_tiled_axis1": lambda v: Fn.allgather(v, axis=1,
                                                        tiled=True),
        "alltoall": lambda v: Fn.alltoall(v[:, None]).squeeze(-1),
        "alltoall_untiled": lambda v: Fn.alltoall(
            v, split_axis=0, concat_axis=1, tiled=False),
        "bcast": lambda v: Fn.bcast(v, root=R),
        "gather": lambda v: Fn.gather(v, root=R),
        "scatter": lambda v: Fn.scatter(v, root=R),
        "allreduce": lambda v: Fn.allreduce(v),
        "allreduce_mean": lambda v: C.allreduce(v, None, op="mean"),
        "gather_scatter": lambda v: Fn.scatter(Fn.gather(v, root=0),
                                               root=0),
        "reduce_scatter": lambda v: C.reduce_scatter(v),
        "reduce_scatter_untiled": lambda v: C.reduce_scatter(
            v, scatter_dimension=1, tiled=False),
        "shift": lambda v: C.shift(v, None, 1),
        "ppermute_pairs": lambda v: C.ppermute(
            v, None, [(i, (i + 2) % n) for i in range(0, n, 2)]),
    }


#: cases whose forward is checked but whose gradient raises, as JAX's
NO_GRAD_CASES = {"allreduce_max": "max", "allreduce_min": "min"}


def _numerical_grad(f, v, c, rank, n, eps):
    """Central differences of ``sum over ranks of sum(f(v) * c)`` with
    respect to this rank's ``v``: every rank perturbs in turn, all ranks
    run every forward, and the loss is summed over the ranks."""
    g = torch.zeros_like(v)
    for owner in range(n):
        for e in range(v.numel()):
            vals = []
            for sign in (1.0, -1.0):
                vp = v.clone()
                if rank == owner:
                    vp.view(-1)[e] += sign * eps
                with torch.no_grad():
                    loss = (f(vp) * c).sum().reshape(1)
                dist.all_reduce(loss)
                vals.append(loss)
            if rank == owner:
                g.view(-1)[e] = (vals[0] - vals[1]) / (2 * eps)
    return g


def functions_worker(inputs: dict) -> dict:
    """Every function case: the forward, the gradient of ``sum(f(v) *
    c)`` in fp32 (against JAX), and in fp64 autograd's gradient beside
    central differences (eps ``inputs['eps']``)."""
    comm = create_communicator("naive")
    rank, n = comm.rank, comm.size
    eps = float(inputs["eps"])
    out = {}
    for name, f in function_cases(n).items():
        x, c = inputs[f"x/{name}"][rank], inputs[f"c/{name}"][rank]
        v = torch.tensor(x, requires_grad=True)
        y = f(v)
        (y * torch.tensor(c)).sum().backward()
        out[f"{name}/out"] = y.detach().numpy()
        out[f"{name}/grad"] = v.grad.numpy()
        v64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        c64 = torch.tensor(c, dtype=torch.float64)
        (f(v64) * c64).sum().backward()
        out[f"{name}/grad64"] = v64.grad.numpy()
        out[f"{name}/num64"] = _numerical_grad(
            f, v64.detach(), c64, rank, n, eps).numpy()
    for name, op in NO_GRAD_CASES.items():
        v = torch.tensor(inputs[f"x/{name}"][rank], requires_grad=True)
        y = C.allreduce(v, None, op=op)
        out[f"{name}/out"] = y.detach().numpy()
        try:
            y.sum().backward()
            out[f"{name}/raised"] = np.array(False)
        except NotImplementedError:
            out[f"{name}/raised"] = np.array(True)
    # the dict forms: one call over a pytree, leaf by leaf
    tree = {"a": torch.tensor(inputs["x/allreduce"][rank]),
            "b": [torch.tensor(inputs["x/bcast"][rank])]}
    summed = Fn.allreduce(tree)
    out["tree/a"] = summed["a"].detach().numpy()
    out["tree/b"] = summed["b"][0].detach().numpy()
    # the transfers a call makes: a send_recv touches its two ranks only
    with counted_dist_calls() as counts:
        Fn.send_recv(torch.ones(2), pairs(n)["src"], pairs(n)["dst"])
    out["calls/send_recv"] = np.array(counts["batch_isend_irecv"])
    try:
        Fn.send(torch.ones(2), 0)
        out["send_without_src_raised"] = np.array(False)
    except ValueError as e:
        out["send_without_src_raised"] = np.array("static source" in str(e))
    return out


# ---------------------------------------------------------------------------
# MultiNodeChainList and create_mnbn_model
# ---------------------------------------------------------------------------

def dense_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def merge_fn(params, xs):
    a, b = xs
    return a + b @ params["w"]


def chain_specs(n: int) -> dict:
    """``name -> [(fn, rank, rank_in, rank_out)]`` of each chain case
    that fits in ``n`` ranks (the JAX tests' graphs)."""
    specs = {
        "two_stage": [(dense_fn, 0, None, 1), (dense_fn, 1, 0, None)],
        # a bidirectional graph: 0 -> 1 -> 0
        "round_trip": [(dense_fn, 0, None, 1), (dense_fn, 1, 0, 0),
                       (dense_fn, 0, 1, None)],
    }
    if n >= 3:
        specs["three_stage"] = [(dense_fn, 0, None, 1), (dense_fn, 1, 0, 2),
                                (dense_fn, 2, 1, None)]
    if n >= 4:
        specs["branch_merge"] = [(dense_fn, 0, None, [1, 2]),
                                 (dense_fn, 1, 0, 3), (dense_fn, 2, 0, 3),
                                 (merge_fn, 3, [1, 2], None)]
    return specs


def _chain(comm, spec, calls=None, meta_calls=None):
    """The chain list of ``spec``; ``calls[k]`` counts chain ``k``'s calls
    on data and ``meta_calls[k]`` its calls on meta tensors (shape
    inference)."""
    from chainermn_tpu_torch.links import MultiNodeChainList

    model = MultiNodeChainList(comm)
    for ci, (fn, rank, rank_in, rank_out) in enumerate(spec):
        if calls is not None:
            def fn(params, x, _fn=fn, _ci=ci):
                first = x[0] if isinstance(x, tuple) else x
                (meta_calls if first.is_meta else calls)[_ci] += 1
                return _fn(params, x)
        model.add_link(fn, rank=rank, rank_in=rank_in, rank_out=rank_out)
    return model


def _chain_params(inputs, name, k):
    pre = f"{name}/p{k}/"
    return {key[len(pre):]: torch.tensor(v, requires_grad=True)
            for key, v in inputs.items() if key.startswith(pre)}


def _rejected(fn, pattern):
    try:
        fn()
    except ValueError as e:
        return np.array(bool(re.search(pattern, str(e))))
    return np.array(False)


def mnbn_net(inputs, prefix):
    """The JAX tests' net (Dense 8, BN, relu, Dense 4 [, BN]) as plain
    torch layers with BatchNorm1d (torch momentum 0.1 = flax 0.9), the
    flax weights carried over."""
    from torch import nn

    def linear(k):
        w = inputs[f"{prefix}{k}/kernel"]
        lin = nn.Linear(*w.shape)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor(w.T))
            lin.bias.copy_(torch.tensor(inputs[f"{prefix}{k}/bias"]))
        return lin

    layers = [linear("Dense_0"), nn.BatchNorm1d(8, momentum=0.1), nn.ReLU(),
              linear("Dense_1")]
    if f"{prefix}BatchNorm_1/scale" in inputs:
        layers.append(nn.BatchNorm1d(4, momentum=0.1))
    for i, m in enumerate(m for m in layers if isinstance(m, nn.BatchNorm1d)):
        with torch.no_grad():
            m.weight.copy_(torch.tensor(inputs[f"{prefix}BatchNorm_{i}/scale"]))
            m.bias.copy_(torch.tensor(inputs[f"{prefix}BatchNorm_{i}/bias"]))
    return nn.Sequential(*layers)


def links_worker(inputs: dict) -> dict:
    """The chain cases (replicated forward; the terminal output and every
    parameter's gradient of ``sum(out ** 2)`` through ``apply``; each
    chain's calls per rank; the ``torch.distributed`` calls of a 2-stage
    forward and backward), the three rejections, and
    ``create_mnbn_model`` at the group's size (forward, gradients, and 5
    SGD steps against the JAX training test)."""
    from chainermn_tpu_torch.links import create_mnbn_model

    comm = create_communicator("naive")
    rank, n = comm.rank, comm.size
    out = {}
    for name, spec in chain_specs(n).items():
        params = [_chain_params(inputs, name, k) for k in range(len(spec))]
        x = torch.tensor(inputs[f"{name}/x"])
        calls, meta_calls = [0] * len(spec), [0] * len(spec)
        model = _chain(comm, spec, calls, meta_calls)
        out[f"{name}/replicated"] = model.build()(params, x).detach().numpy()
        y = model.apply(params, x)
        if name == "two_stage":
            with counted_dist_calls() as fwd_calls:
                y = model.apply(params, x)
            with counted_dist_calls() as bwd_calls:
                (y ** 2).sum().backward()
            for key in DIST_CALLS:
                out[f"calls/forward/{key}"] = np.array(fwd_calls[key])
                out[f"calls/backward/{key}"] = np.array(bwd_calls[key])
        else:
            (y ** 2).sum().backward()
        out[f"{name}/apply"] = y.detach().numpy()
        for k, p in enumerate(params):
            for key, t in p.items():
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                out[f"{name}/g{k}/{key}"] = g.numpy()
        out[f"{name}/calls"] = np.array(calls)
        out[f"{name}/meta_calls"] = np.array(meta_calls)
    bad = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    x = torch.zeros(2, 3)
    fwd_ref = _chain(comm, [(dense_fn, 0, 1, None), (dense_fn, 1, None, 0)])
    out["rejected/forward_reference"] = _rejected(
        lambda: fwd_ref.apply([bad, bad], x), "no earlier component")
    no_term = _chain(comm, [(dense_fn, 0, None, 1)])
    out["rejected/no_terminal"] = _rejected(
        lambda: no_term.apply([bad], x), "terminal")
    too_far = _chain(comm, [(dense_fn, 0, None, n), (dense_fn, n, 0, None)])
    out["rejected/rank_outside"] = _rejected(
        lambda: too_far.apply([bad, bad], x), "group has only")

    # create_mnbn_model: this rank's slice of the global batch
    per = int(inputs["mnbn/per_rank"])
    xs = torch.tensor(inputs["mnbn/x"][rank * per:(rank + 1) * per])
    net = create_mnbn_model(mnbn_net(inputs, "mnbn/p/"), comm)
    y = net(xs)
    (y * torch.tensor(inputs["mnbn/c"][rank * per:(rank + 1) * per])
     ).sum().backward()
    out["mnbn/y"] = y.detach().numpy()
    for key, p in net.named_parameters():
        g = p.grad.clone()
        dist.all_reduce(g)
        out[f"mnbn/grad/{key}"] = g.numpy()
    for key, b in net.named_buffers():
        out[f"mnbn/buffer/{key}"] = b.numpy()
    # five SGD steps, gradients and loss averaged over the ranks
    per = int(inputs["train/per_rank"])
    ys = torch.tensor(inputs["train/y"][rank * per:(rank + 1) * per]).long()
    xs = torch.tensor(inputs["train/x"][rank * per:(rank + 1) * per])
    net = create_mnbn_model(mnbn_net(inputs, "train/p/"), comm)
    opt = torch.optim.SGD(net.parameters(), lr=0.1)
    for _ in range(5):
        loss = F.cross_entropy(net(xs), ys)
        opt.zero_grad()
        loss.backward()
        comm.allreduce_grad(net)
        opt.step()
    out["train/loss"] = comm.allreduce_mean(loss.detach().reshape(1)).numpy()
    for key, t in net.state_dict().items():
        out[f"train/state/{key}"] = t.numpy()
    return out


def twin_worker(inputs: dict) -> dict:
    """The model-parallel MNIST twin, the JAX example's weights carried
    in; its per-iteration losses."""
    from chainermn_tpu_torch.convert import chain_params_from_flax
    from chainermn_tpu_torch.examples.mnist import train_mnist_model_parallel

    params = [{k[len(f"p{i}/"):]: v for k, v in inputs.items()
               if k.startswith(f"p{i}/")} for i in range(2)]
    res = train_mnist_model_parallel.main(
        ["--device", "cpu", "--iterations", str(int(inputs["iterations"])),
         "--batchsize", str(int(inputs["batchsize"]))],
        params=chain_params_from_flax(params))
    return {"losses": np.array(res["losses"]),
            "final_acc": np.array(res["final_acc"])}


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _mine(inputs, key, rank, requires_grad=True):
    return torch.tensor(inputs[key][rank], requires_grad=requires_grad)


def _rep(inputs, key, requires_grad=True):
    return torch.tensor(inputs[key], requires_grad=requires_grad)


def tp_worker(inputs: dict) -> dict:
    """The tensor-parallel cases over the whole group, each rank with its
    shards of the stacked weights: ``tp_mlp``, the column layer gathered,
    ``tp_slice`` with the row layer, ``tp_attention`` (causal and not),
    the gradients of each, the ``torch.distributed`` calls of a
    ``tp_mlp`` forward and backward, the head-count refusal, and tp x dp
    on a 2 x 2 grid of groups at 4 ranks."""
    comm = create_communicator("naive")
    rank, n = comm.rank, comm.size
    out = {}

    # tp_mlp: loss sum(y ** 2), every rank's shards and the replicated
    w1, b1, w2 = (_mine(inputs, f"mlp/{k}s", rank) for k in ("w1", "b1",
                                                              "w2"))
    b2, x = _rep(inputs, "mlp/b2"), _rep(inputs, "mlp/x")
    y = T.tp_mlp(x, w1, b1, w2, b2)
    loss = (y ** 2).sum()
    loss.backward()
    out["mlp/loss"] = loss.detach().numpy()
    for key, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2), ("x", x)):
        out[f"mlp/g/{key}"] = t.grad.numpy()

    # one forward, one backward: one all_reduce each
    w1c, w2c = (t.detach().requires_grad_() for t in (w1, w2))
    with counted_dist_calls() as fwd_calls:
        y = T.tp_mlp(x.detach(), w1c, None, w2c, None)
    with counted_dist_calls() as bwd_calls:
        (y ** 2).sum().backward()
    for key in DIST_CALLS:
        out[f"calls/forward/{key}"] = np.array(fwd_calls[key])
        out[f"calls/backward/{key}"] = np.array(bwd_calls[key])

    # column layer with gather_output: values and gradients
    w, b = _mine(inputs, "col/ws", rank), _mine(inputs, "col/bs", rank)
    x = _rep(inputs, "col/x")
    y = T.column_parallel_dense(x, w, b, gather_output=True)
    (y ** 2).sum().backward()
    out["col/y"] = y.detach().numpy()
    out["col/g/w"], out["col/g/b"] = w.grad.numpy(), b.grad.numpy()
    out["col/g/x"] = x.grad.numpy()

    # tp_slice + row layer over replicated full weights
    x, w = _rep(inputs, "slice/x"), _rep(inputs, "slice/w")
    y = T.row_parallel_dense(T.tp_slice(x, None, 1), T.tp_slice(w, None, 0))
    (y ** 2).sum().backward()
    out["slice/y"] = y.detach().numpy()
    out["slice/g/x"], out["slice/g/w"] = x.grad.numpy(), w.grad.numpy()

    # tp_attention, causal and not
    for causal in (True, False):
        tag = f"attn{int(causal)}"
        x = _rep(inputs, "attn/x")
        ws = [_mine(inputs, f"attn/{k}s", rank) for k in ("wq", "wk", "wv",
                                                          "wo")]
        y = T.tp_attention(x, *ws, n_heads=int(inputs["attn/n_heads"]),
                           causal=causal)
        (y ** 2).sum().backward()
        out[f"{tag}/y"] = y.detach().numpy()
        out[f"{tag}/g/x"] = x.grad.numpy()
        for k, t in zip(("wq", "wk", "wv", "wo"), ws):
            out[f"{tag}/g/{k}"] = t.grad.numpy()
    out["attn/heads_refused"] = _rejected(
        lambda: T.tp_attention(torch.ones(1, 2, 8), *[torch.ones(8, 1)] * 3,
                               torch.ones(1, 8), n_heads=n - 1),
        "not divisible")

    # the f/g pairs alone: identity/all-reduce and their adjoints
    v = _mine(inputs, "fg/v", rank)
    c = torch.tensor(inputs["fg/c"][rank])
    for name, fn in (("copy", T.copy_to_tp), ("reduce", T.reduce_from_tp),
                     ("gather", lambda t: T.gather_from_tp(t, None, 0))):
        v.grad = None
        y = fn(v)
        (y * (c if name != "gather" else torch.tensor(
            inputs["fg/cg"][rank]))).sum().backward()
        out[f"fg/{name}/y"] = y.detach().numpy()
        out[f"fg/{name}/g"] = v.grad.numpy()

    if n == 4:  # data(2) x model(2): model groups {0,1},{2,3}
        groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        data = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        mg, dg = groups[rank // 2], data[rank % 2]
        mr = rank % 2
        w1 = torch.tensor(inputs["dp/w1s"][mr], requires_grad=True)
        w2 = torch.tensor(inputs["dp/w2s"][mr], requires_grad=True)
        per = inputs["dp/x"].shape[0] // 2
        xl = torch.tensor(inputs["dp/x"][(rank // 2) * per:
                                         (rank // 2 + 1) * per])
        y = T.tp_mlp(xl, w1, None, w2, None, group=mg)
        loss = (y ** 2).mean()
        loss.backward()
        loss = C._all_reduce(loss.detach().reshape(1), dg, "mean")
        out["dp/loss"] = loss.numpy()
        out["dp/g1"] = C._all_reduce(w1.grad, dg, "mean").numpy()
        out["dp/g2"] = C._all_reduce(w2.grad, dg, "mean").numpy()
    return out
