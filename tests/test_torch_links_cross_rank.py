"""The port's cross-rank links against the JAX package's, case for case
with ``tests/test_links.py``: ``MultiNodeChainList`` (chains, a round
trip 0 -> 1 -> 0, three stages, branch and merge, the rejections, the
gradients across stages) and ``create_mnbn_model`` (the converted model
over the ranks against the JAX converted model over the mesh, its
gradients, running statistics and five SGD steps; drop-in names both
ways, methods, copies and the group rules), and the model-parallel
MNIST twin against the JAX example.

The JAX side runs on an n-device CPU mesh, the port at n gloo ranks
(``tests/torch_cross_rank_workers.py``, one launch per world size, 2 and
4; the twin at 2). Inputs and weights are made from numpy seeds (the
JAX example's weights from its own ``init``) and carried across.

The JAX test that pins the compiled program's HLO conditionals has no
torch analog: a counter shows instead that a rank never runs a chain it
does not own on data (every rank runs each chain once on meta tensors,
to learn the wires' shapes, as JAX traces every branch), and the
``torch.distributed`` calls of a two-stage forward and backward are
counted (one transfer each way).

Tolerances: 1e-6 absolute and relative in fp32 (a tanh chain, summed in
another order), except where a case says why not.
"""

import copy
import pickle

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.links import MultiNodeChainList as JaxChainList
from chainermn_tpu.links import create_mnbn_model as jax_mnbn
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.links import (
    MultiNodeBatchNormalization,
    MultiNodeChainList,
    create_mnbn_model,
)
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import shared_launch
from torch_cross_rank_workers import (
    DIST_CALLS,
    chain_specs,
    links_worker,
    mnbn_net,
    twin_worker,
)
from torch_rank_workers import few_threads  # noqa: F401

SIZES = (2, 4)
TOL = dict(rtol=1e-6, atol=1e-6)
#: the BN cases divide by a variance over few rows, and the training
#: case compounds five steps of it: 1e-5 (the JAX test holds the JAX
#: conversion to 1e-4 against the plain model)
BN_TOL = dict(rtol=1e-5, atol=1e-5)
TWIN_ITERATIONS = 12
TWIN_BATCH = 64


def _jax_comm(n):
    return chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:n])


# ---------------------------------------------------------------- chains

def _jdense(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _jmerge(params, xs):
    a, b = xs
    return a + b @ params["w"]


def _chain_case(name, spec, rs):
    """Seeded params for each component and an input."""
    params = []
    for fn, _, rank_in, _ in spec:
        if fn.__name__ == "merge_fn":
            params.append({"w": np.eye(4, dtype=np.float32)
                           + 0.1 * rs.randn(4, 4).astype(np.float32)})
        else:
            d_in = 3 if rank_in is None else 4
            params.append({
                "w": (rs.randn(d_in, 4) * 0.5).astype(np.float32),
                "b": (rs.randn(4) * 0.1).astype(np.float32)})
    return params, rs.randn(5, 3).astype(np.float32)


def _jax_chain(comm, spec):
    model = JaxChainList(comm, axis_name=comm.axis_name)
    for fn, rank, rank_in, rank_out in spec:
        model.add_link(_jmerge if fn.__name__ == "merge_fn" else _jdense,
                       rank=rank, rank_in=rank_in, rank_out=rank_out)
    return model


def _jax_chain_results(comm, spec, params, x):
    model = _jax_chain(comm, spec)
    ax = comm.axis_name
    jp = jax.tree.map(jnp.asarray, params)
    replicated = np.asarray(model.build()(jp, jnp.asarray(x)))
    per_shard = np.asarray(jax.jit(shard_map(
        lambda p, v: model.apply(p, v)[None], mesh=comm.mesh,
        in_specs=(P(), P()), out_specs=P(ax), check_vma=False))(jp, x))

    def loss(p):
        return shard_map(
            lambda p, v: jax.lax.psum(jnp.sum(model.apply(p, v) ** 2), ax),
            mesh=comm.mesh, in_specs=(P(), P()), out_specs=P(),
            check_vma=False)(p, x)

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(jp))
    return replicated, per_shard, grads


# ---------------------------------------------------------------- mnbn

class _JaxBnNet(nn.Module):
    """tests/test_links.py's ``_PlainBnNet`` (two BNs) or the training
    test's net (one)."""

    two_bns: bool = True

    @nn.compact
    def __call__(self, x):
        x = nn.Dense(8)(x)
        x = nn.BatchNorm(use_running_average=False, momentum=0.9)(x)
        x = nn.relu(x)
        x = nn.Dense(4)(x)
        if self.two_bns:
            x = nn.BatchNorm(use_running_average=False, momentum=0.9)(x)
        return x


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in path)] = np.asarray(leaf)
    return out


def _jax_mnbn(comm, variables, x, c):
    model = jax_mnbn(_JaxBnNet(), comm)

    def body(xl, cl):
        def loss(p):
            y, upd = model.apply({"params": p, "batch_stats":
                                  variables["batch_stats"]}, xl,
                                 mutable=["batch_stats"])
            return jnp.sum(y * cl), (y, upd["batch_stats"])

        g, (y, stats) = jax.grad(loss, has_aux=True)(variables["params"])
        return y, jax.lax.psum(g, comm.axis_name), stats

    return jax.tree.map(np.asarray, jax.jit(shard_map(
        body, mesh=comm.mesh, in_specs=(P(comm.axis_name),) * 2,
        out_specs=(P(comm.axis_name), P(), P()), check_vma=False))(x, c))


def _jax_mnbn_training(comm, variables, X, Y):
    """tests/test_links.py's full-training equivalence, the converted
    model's side, on this mesh: five SGD(0.1) steps."""
    model = jax_mnbn(_JaxBnNet(two_bns=False), comm)
    opt = optax.sgd(0.1)
    ax = comm.axis_name

    def loss_fn(p, bs, xb, yb):
        logits, mut = model.apply({"params": p, "batch_stats": bs}, xb,
                                  mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean()
        return loss, mut["batch_stats"]

    @jax.jit
    def step(p, bs, os_, x, y):
        def local(p, bs, os_, xl, yl):
            (l, nbs), g = jax.value_and_grad(loss_fn, has_aux=True)(
                p, bs, xl, yl)
            g = jax.lax.pmean(g, ax)
            l = jax.lax.pmean(l, ax)
            u, os2 = opt.update(g, os_, p)
            return optax.apply_updates(p, u), nbs, os2, l

        return shard_map(local, mesh=comm.mesh,
                         in_specs=(P(), P(), P(), P(ax), P(ax)),
                         out_specs=(P(), P(), P(), P()),
                         check_vma=False)(p, bs, os_, x, y)

    params, stats = variables["params"], variables["batch_stats"]
    os_ = opt.init(params)
    for _ in range(5):
        params, stats, os_, loss = step(params, stats, os_, X, Y)
    return (float(loss), jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, stats))


# ---------------------------------------------------------------- runs

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    res = {}
    for n in SIZES:
        comm = _jax_comm(n)
        rs = np.random.RandomState(10 + n)
        inputs, want = {}, {}
        for name, spec in chain_specs(n).items():
            params, x = _chain_case(name, spec, rs)
            inputs[f"{name}/x"] = x
            for k, p in enumerate(params):
                for key, v in p.items():
                    inputs[f"{name}/p{k}/{key}"] = v
            want[name] = _jax_chain_results(comm, spec, params, x)
        # create_mnbn_model: 4 rows a rank, the JAX nets' weights
        per = 4
        x = (rs.randn(n * per, 6) * 2 + 0.5).astype(np.float32)
        c = rs.randn(n * per, 4).astype(np.float32)
        variables = _JaxBnNet().init(jax.random.key(1), x)
        inputs.update(_flat(variables["params"], "mnbn/p/"))
        inputs.update({"mnbn/x": x, "mnbn/c": c,
                       "mnbn/per_rank": np.array(per)})
        want["mnbn"] = (variables, _jax_mnbn(comm, variables, x, c))
        X = rs.randn(32, 6).astype(np.float32)
        Y = (rs.rand(32) * 4).astype(np.int32)
        v_train = _JaxBnNet(two_bns=False).init(jax.random.key(5), X)
        inputs.update(_flat(v_train["params"], "train/p/"))
        inputs.update({"train/x": X, "train/y": Y,
                       "train/per_rank": np.array(32 // n)})
        want["train"] = _jax_mnbn_training(comm, v_train, X, Y)
        res[n] = (shared_launch(f"links_worker{n}", tmp_path_factory,
                                links_worker, n, inputs, timeout=120),
                  want)
    return res


def _stack(outs, key):
    return np.stack([o[key] for o in outs])


def _cases(n):
    return sorted(chain_specs(n))


CHAIN_CASES = [(n, c) for n in SIZES for c in _cases(n)]


@pytest.mark.parametrize("n,name", CHAIN_CASES)
def test_chain_replicated_output_matches_jax(runs, n, name):
    outs, want = runs[n]
    for o in outs:
        np.testing.assert_allclose(o[f"{name}/replicated"], want[name][0],
                                   **TOL)


@pytest.mark.parametrize("n,name", CHAIN_CASES)
def test_chain_apply_gives_zeros_off_the_terminal_rank(runs, n, name):
    outs, want = runs[n]
    np.testing.assert_allclose(_stack(outs, f"{name}/apply"), want[name][1],
                               **TOL)


@pytest.mark.parametrize("n,name", CHAIN_CASES)
def test_chain_gradients_flow_across_stages(runs, n, name):
    """Each rank holds the gradients of the components it owns; summed
    over the ranks they are the JAX chain's (grad of the psum'd loss)."""
    outs, want = runs[n]
    spec = chain_specs(n)[name]
    for k, (_, rank, _, _) in enumerate(spec):
        for key, g in want[name][2][k].items():
            got = _stack(outs, f"{name}/g{k}/{key}")
            assert not np.delete(got, rank, axis=0).any()
            np.testing.assert_allclose(got[rank], g, **TOL)


@pytest.mark.parametrize("n,name", CHAIN_CASES)
def test_non_owner_never_calls_its_chain(runs, n, name):
    outs, _ = runs[n]
    spec = chain_specs(n)[name]
    for r, o in enumerate(outs):
        calls = o[f"{name}/calls"]
        for k, (_, rank, _, _) in enumerate(spec):
            assert (calls[k] > 0) == (rank == r), (r, k, calls)


@pytest.mark.parametrize("n,name", CHAIN_CASES)
def test_wire_shapes_are_inferred_once_on_meta_tensors(runs, n, name):
    """Every rank runs every chain once on meta tensors, over the case's
    several forwards of the same shapes (the shapes are kept), and never
    again."""
    outs, _ = runs[n]
    for o in outs:
        assert list(o[f"{name}/meta_calls"]) == [1] * len(chain_specs(n)[name])


@pytest.mark.parametrize("kind", ["forward_reference", "no_terminal",
                                  "rank_outside"])
@pytest.mark.parametrize("n", SIZES)
def test_chain_rejections(runs, n, kind):
    outs, _ = runs[n]
    assert all(bool(o[f"rejected/{kind}"]) for o in outs)


@pytest.mark.parametrize("n", SIZES)
def test_two_stage_transfers_once_each_way(runs, n):
    """The torch analog of the HLO pin: a forward sends the activation
    0 -> 1, one transfer (the shapes are known on every rank without
    communicating); the backward sends its cotangent 1 -> 0, one
    transfer, and nothing else."""
    outs, _ = runs[n]
    for r, o in enumerate(outs):
        fwd = {k: int(o[f"calls/forward/{k}"]) for k in DIST_CALLS}
        bwd = {k: int(o[f"calls/backward/{k}"]) for k in DIST_CALLS}
        want_fwd = dict.fromkeys(DIST_CALLS, 0)
        want_fwd["batch_isend_irecv"] = int(r in (0, 1))
        want_bwd = dict.fromkeys(DIST_CALLS, 0)
        want_bwd["batch_isend_irecv"] = int(r in (0, 1))
        assert fwd == want_fwd and bwd == want_bwd, (r, fwd, bwd)


@pytest.mark.parametrize("n", SIZES)
def test_create_mnbn_model_syncs_over_ranks(runs, n):
    """The converted model over n ranks == the JAX converted model over
    n shards: outputs, parameter gradients (summed over the ranks) and
    the running statistics after the step."""
    outs, want = runs[n]
    _, (y, grads, stats) = want["mnbn"]
    np.testing.assert_allclose(np.concatenate([o["mnbn/y"] for o in outs]),
                               y, **BN_TOL)
    names = {"0.weight": ("Dense_0", "kernel"), "0.bias": ("Dense_0", "bias"),
             "1.weight": ("BatchNorm_0", "scale"),
             "1.bias": ("BatchNorm_0", "bias"),
             "3.weight": ("Dense_1", "kernel"), "3.bias": ("Dense_1", "bias"),
             "4.weight": ("BatchNorm_1", "scale"),
             "4.bias": ("BatchNorm_1", "bias")}
    for o in outs:
        for key, (mod, leaf) in names.items():
            g = grads[mod][leaf]
            g = g.T if leaf == "kernel" else g
            np.testing.assert_allclose(o[f"mnbn/grad/{key}"], g, **BN_TOL)
        for i, bn in ((1, "BatchNorm_0"), (4, "BatchNorm_1")):
            np.testing.assert_allclose(o[f"mnbn/buffer/{i}.running_mean"],
                                       stats[bn]["mean"], **BN_TOL)
            np.testing.assert_allclose(o[f"mnbn/buffer/{i}.running_var"],
                                       stats[bn]["var"], **BN_TOL)
            assert int(o[f"mnbn/buffer/{i}.num_batches_tracked"]) == 1


@pytest.mark.parametrize("n", SIZES)
def test_create_mnbn_model_full_training_equivalence(runs, n):
    outs, want = runs[n]
    loss, params, stats = want["train"]
    for o in outs:
        np.testing.assert_allclose(float(o["train/loss"][0]), loss,
                                   **BN_TOL)
        for key, (mod, leaf) in {
                "0.weight": ("Dense_0", "kernel"),
                "0.bias": ("Dense_0", "bias"),
                "1.weight": ("BatchNorm_0", "scale"),
                "1.bias": ("BatchNorm_0", "bias"),
                "3.weight": ("Dense_1", "kernel"),
                "3.bias": ("Dense_1", "bias")}.items():
            w = params[mod][leaf]
            np.testing.assert_allclose(o[f"train/state/{key}"],
                                       w.T if leaf == "kernel" else w,
                                       **BN_TOL)
        np.testing.assert_allclose(o["train/state/1.running_mean"],
                                   stats["BatchNorm_0"]["mean"], **BN_TOL)
        np.testing.assert_allclose(o["train/state/1.running_var"],
                                   stats["BatchNorm_0"]["var"], **BN_TOL)


# ------------------------------------------------ mnbn in this process

@pytest.fixture(scope="module")
def comm():
    return create_communicator("naive")


def _plain():
    rs = np.random.RandomState(0)
    inputs = {}
    for k, shape in (("Dense_0/kernel", (6, 8)), ("Dense_0/bias", (8,)),
                     ("Dense_1/kernel", (8, 4)), ("Dense_1/bias", (4,)),
                     ("BatchNorm_0/scale", (8,)), ("BatchNorm_0/bias", (8,)),
                     ("BatchNorm_1/scale", (4,)),
                     ("BatchNorm_1/bias", (4,))):
        inputs["p/" + k] = rs.randn(*shape).astype(np.float32)
    return mnbn_net(inputs, "p/")


def test_create_mnbn_model_params_are_drop_in(comm):
    plain = _plain()
    converted = create_mnbn_model(plain, comm)
    sp, sc = plain.state_dict(), converted.state_dict()
    assert list(sp) == list(sc)
    for k in sp:
        assert torch.equal(sp[k], sc[k]), k
    # both ways: the converted model's trained state loads into the plain
    # model, and the plain model's into a converted one
    converted(torch.randn(8, 6))
    fresh = _plain()
    fresh.load_state_dict(converted.state_dict())
    for k, v in converted.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    again = create_mnbn_model(_plain(), comm)
    again.load_state_dict(fresh.state_dict())
    assert isinstance(again[1], MultiNodeBatchNormalization)


def test_create_mnbn_model_leaves_the_original_as_it_was(comm):
    plain = _plain()
    before = copy.deepcopy(plain.state_dict())
    converted = create_mnbn_model(plain, comm)
    converted(torch.randn(8, 6))
    assert type(plain[1]) is torch.nn.BatchNorm1d
    for k, v in plain.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_create_mnbn_model_runs_at_world_size_one(comm):
    """At one rank the converted model's train-mode output is the plain
    model's (the global batch is the local one; both normalize with the
    biased variance)."""
    plain = _plain()
    x = torch.randn(16, 6) * 2 + 0.5
    y = create_mnbn_model(plain, comm)(x)
    np.testing.assert_allclose(y.detach().numpy(),
                               plain(x).detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_create_mnbn_model_auxiliary_method(comm):
    """A method other than forward is the model's own, with synchronized
    BN inside (the JAX ``apply(..., method='encode')``)."""

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = torch.nn.BatchNorm1d(5)

        def forward(self, x):
            return self.encode(x)

        def encode(self, x):
            return self.bn(x)

    converted = create_mnbn_model(Net(), comm)
    assert isinstance(converted.bn, MultiNodeBatchNormalization)
    x = torch.randn(8, 5)
    np.testing.assert_allclose(converted.encode(x).detach().numpy(),
                               Net().encode(x).detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_create_mnbn_model_field_values_pass_through(comm):
    """The converted model is the model's own class with its own
    attributes, callable ones included (the JAX wrapper passes its
    fields through as values)."""

    class Net(torch.nn.Sequential):
        act = staticmethod(torch.relu)

        def __init__(self):
            super().__init__(torch.nn.BatchNorm1d(3))
            self.num_classes = 1000
            self.compute_dtype = torch.bfloat16

    converted = create_mnbn_model(Net(), comm)
    assert type(converted) is Net
    assert converted.num_classes == 1000
    assert converted.compute_dtype is torch.bfloat16
    assert converted.act is torch.relu


def test_create_mnbn_model_pickle_and_deepcopy(comm):
    converted = create_mnbn_model(_plain(), comm)
    x = torch.randn(8, 6)
    for clone in (pickle.loads(pickle.dumps(converted)),
                  copy.deepcopy(converted)):
        assert list(clone.state_dict()) == list(converted.state_dict())
        assert clone[1].group is converted[1].group
        np.testing.assert_allclose(clone.eval()(x).detach().numpy(),
                                   converted.eval()(x).detach().numpy(),
                                   rtol=0, atol=0)


def test_create_mnbn_model_respects_explicit_group(comm):
    import torch.distributed as dist

    with pytest.raises(ValueError, match="exactly one"):
        create_mnbn_model(_plain())
    with pytest.raises(ValueError, match="exactly one"):
        create_mnbn_model(_plain(), comm, group=comm.group)
    other = dist.new_group([0])
    synced = MultiNodeBatchNormalization(3, group=other, device="cpu")
    unsynced = MultiNodeBatchNormalization(3, device="cpu")
    net = torch.nn.Sequential(synced, unsynced, torch.nn.BatchNorm1d(3),
                              torch.nn.SyncBatchNorm(3))
    converted = create_mnbn_model(net, comm)
    assert converted[0].group is other
    assert converted[1].group is comm.group
    assert converted[2].group is comm.group
    assert type(converted[3]) is torch.nn.SyncBatchNorm
    with pytest.raises(ValueError, match="momentum=None"):
        create_mnbn_model(torch.nn.BatchNorm1d(3, momentum=None), comm)


# ---------------------------------------------------------------- twin

def _jax_twin(iterations, batchsize, n_units=256):
    """The JAX example on a 2-device 'stage' mesh
    (``examples/mnist/train_mnist_model_parallel.py``: its stages, its
    initializers and ``model.init(key(0), x0)``, its batches and step):
    the initial weights and the loss by iteration."""
    from conftest import load_example

    ex = load_example("mnist", "train_mnist.py")
    comm = chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:2], axis_name="stage")

    def stage0_fn(p, x):
        h = jnp.maximum(x @ p["w0"] + p["b0"], 0.0)
        return jnp.maximum(h @ p["w1"] + p["b1"], 0.0)

    def stage0_init(rng, x):
        k0, k1 = jax.random.split(rng)
        s0, s1 = 1.0 / np.sqrt(x.shape[-1]), 1.0 / np.sqrt(n_units)
        return {"w0": jax.random.normal(k0, (x.shape[-1], n_units)) * s0,
                "b0": jnp.zeros(n_units),
                "w1": jax.random.normal(k1, (n_units, n_units)) * s1,
                "b1": jnp.zeros(n_units)}

    def stage1_fn(p, h):
        return h @ p["w2"] + p["b2"]

    def stage1_init(rng, h):
        s = 1.0 / np.sqrt(h.shape[-1])
        return {"w2": jax.random.normal(rng, (h.shape[-1], 10)) * s,
                "b2": jnp.zeros(10)}

    model = JaxChainList(comm, axis_name="stage")
    model.add_link(stage0_fn, rank=0, rank_out=1, init_fn=stage0_init)
    model.add_link(stage1_fn, rank=1, rank_in=0, init_fn=stage1_init)
    params = model.init(jax.random.key(0), jnp.zeros((batchsize, 784)))
    init = jax.tree.map(np.asarray, params)
    opt = optax.sgd(0.05, momentum=0.9)
    opt_state = opt.init(params)

    def sharded_loss(params, x, y):
        def body(params, x, y):
            logits = jax.lax.psum(model.apply(params, x), "stage")
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        return shard_map(body, mesh=comm.mesh, in_specs=(P(), P(), P()),
                         out_specs=P(), check_vma=False)(params, x, y)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(sharded_loss)(params, x, y)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    train, _ = ex.get_mnist()
    rng = np.random.RandomState(1)
    losses = []
    for _ in range(iterations):
        idx = rng.randint(0, len(train), size=batchsize)
        x = np.stack([train[i][0] for i in idx])
        y = np.stack([train[i][1] for i in idx])
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(float(loss))
    return init, losses


def test_model_parallel_twin_matches_the_jax_example():
    """Per-iteration losses of the twin at 2 gloo ranks against the JAX
    example's on a 2-device mesh, the same weights and batches. 1e-5
    relative: 784 x 256 products summed in another order, compounded
    over the steps."""
    params, want = _jax_twin(TWIN_ITERATIONS, TWIN_BATCH)
    inputs = {"iterations": np.array(TWIN_ITERATIONS),
              "batchsize": np.array(TWIN_BATCH)}
    for i, p in enumerate(params):
        inputs.update({f"p{i}/{k}": np.asarray(v) for k, v in p.items()})
    outs = run_distributed(twin_worker, 2, inputs, timeout=120)
    for o in outs:
        np.testing.assert_allclose(o["losses"], want, rtol=1e-5, atol=1e-6)
    assert want[-1] < want[0]


def test_model_parallel_twin_runs_on_the_card_by_default(monkeypatch):
    """With no ``--device`` the twin asks for the CUDA card and raises
    without one, before any communicator exists; its other flags keep
    the JAX example's defaults."""
    from chainermn_tpu_torch.examples.mnist import train_mnist_model_parallel

    args = train_mnist_model_parallel._parser().parse_args([])
    assert (args.device, args.communicator) == (None, None)
    assert (args.batchsize, args.iterations, args.lr, args.n_units) == (
        128, 100, 0.05, 256)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mnist_model_parallel.main(["--iterations", "1"])
