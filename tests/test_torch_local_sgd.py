"""Local SGD (``LocalSGDOptimizer``/``create_local_sgd``), ``LARS`` and
``LAMB``, and the twins' new flags.

Local SGD runs at 4 gloo ranks (``tests/torch_comm_workers.py::
local_sgd_worker``, one launch) on the flat and the 2 x 2 hierarchical
layouts against the JAX ``LocalSGDOptimizer`` inside ``shard_map`` (each
rank's parameters and state carried per rank) and against the literal
per-worker simulation of ``tests/test_optimizer.py::
test_local_sgd_matches_per_worker_simulation`` (Adam, sync every 3), and
with SGD, outer momentum 0.9 and outer lr 0.7, syncing every 2 steps.
LARS and LAMB run in this process against ``optax.lars`` and
``optax.lamb`` over 5 steps. The MNIST twin's new flags run at 2 gloo
ranks (``twins_worker``); the ImageNet and Transformer twins' at one
rank, small.

Tolerances: local SGD with SGD rtol 1e-5 (atol 1e-6), with Adam rtol
1e-4 (torch's Adam divides by the bias corrections in another order
than optax's: 3e-5 relative after 3 steps); LARS and LAMB rtol 1e-5
(atol 1e-6); the twins
learn (MNIST accuracy >= 0.9 after 40 iterations) or reach a finite
loss.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import create_communicator as jax_comm
from chainermn_tpu import create_local_sgd as jax_local_sgd
from chainermn_tpu.communicators.xla_communicator import (
    HierarchicalCommunicator as JaxHier,
)
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.examples.imagenet import train_imagenet
from chainermn_tpu_torch.examples.transformer import train_transformer_lm
from chainermn_tpu_torch.optimizers import (
    LAMB,
    LARS,
    create_local_sgd,
    inner_transform,
)
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import local_sgd_worker, run_once, twins_worker
from torch_rank_workers import few_threads, restore_excepthook  # noqa: F401

N = 4
TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-4, atol=1e-6)
CASES = {  # label: (optax inner, sync_every, steps, outer_lr, outer_momentum)
    "adam3": (lambda: optax.adam(0.1), 3, 3, 1.0, 0.0),
    "sgd_outer": (lambda: optax.sgd(0.5), 2, 6, 0.7, 0.9),
}


def _inputs():
    rs = np.random.RandomState(13)
    return {"p0/adam3": np.full((4,), 0.25, np.float32),
            "p0/sgd_outer": rs.randn(4).astype(np.float32),
            "g": rs.randn(3, N, 4).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_once("local_sgd_worker", lambda: run_distributed(
        local_sgd_worker, N, inputs, timeout=240), tmp_path_factory)


def _jax_local_sgd(inputs, cname, label):
    make, every, steps, olr, om = CASES[label]
    devs = np.array(jax.devices("cpu")[:N])
    if cname == "flat":
        comm, axes = jax_comm("naive", devices=list(devs)), ("data",)
    else:
        comm = JaxHier(mesh=Mesh(devs.reshape(2, 2), ("inter", "intra")))
        axes = ("inter", "intra")
    opt = jax_local_sgd(make(), comm, sync_every=every, outer_lr=olr,
                        outer_momentum=om)
    p = jnp.asarray(inputs[f"p0/{label}"])
    stack = lambda t: jax.tree.map(  # noqa: E731
        lambda v: jnp.broadcast_to(v, (N,) + jnp.shape(v)), t)
    params, state = stack(p), stack(opt.init(p))

    @jax.jit
    def step(params, state, g):
        def body(params, state, g):
            p0, s0 = params[0], jax.tree.map(lambda v: v[0], state)
            upd, s1 = opt.update(g[0], s0, p0)
            return (optax.apply_updates(p0, upd)[None],
                    jax.tree.map(lambda v: v[None], s1))

        return shard_map(body, mesh=comm.mesh, in_specs=P(axes),
                         out_specs=P(axes), check_vma=False)(params, state, g)

    out = []
    for s in range(steps):
        params, state = step(params, state, jnp.asarray(inputs["g"][s % 3]))
        out.append(np.asarray(params))
    return out, state


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("cname", ["flat", "2x2"])
def test_local_sgd_follows_jax_step_by_step(runs, cname, label):
    inputs, outs = runs
    want, state = _jax_local_sgd(inputs, cname, label)
    _, every, steps, _, _ = CASES[label]
    tol = ADAM_TOL if label == "adam3" else TOL
    for r, o in enumerate(outs):
        for s in range(steps):
            np.testing.assert_allclose(o[f"{cname}/{label}/step{s}"],
                                       want[s][r], **tol)
        np.testing.assert_allclose(o[f"{cname}/{label}/anchor"],
                                   np.asarray(state.anchor)[r], **tol)
        np.testing.assert_allclose(o[f"{cname}/{label}/velocity"],
                                   np.asarray(state.outer_velocity)[r],
                                   **tol)
        assert int(o[f"{cname}/{label}/step"]) == steps
    # between syncs each rank is on its own; at a sync they agree
    assert not np.allclose(outs[0][f"{cname}/{label}/step0"],
                           outs[1][f"{cname}/{label}/step0"])
    last = f"{cname}/{label}/step{steps - 1}"
    assert all(np.array_equal(o[last], outs[0][last]) for o in outs)


def test_local_sgd_matches_the_per_worker_simulation(runs):
    """tests/test_optimizer.py's oracle: Adam per worker for 3 steps, then
    the average (and the anchor is that average: one sync)."""
    inputs, outs = runs
    finals = []
    for r in range(N):
        p = jnp.asarray(inputs["p0/adam3"])
        inner = optax.adam(0.1)
        s = inner.init(p)
        for k in range(3):
            u, s = inner.update(jnp.asarray(inputs["g"][k, r]), s, p)
            p = optax.apply_updates(p, u)
        finals.append(np.asarray(p))
    expect = np.stack(finals).mean(0)
    for o in outs:
        np.testing.assert_allclose(o["flat/adam3/step2"], expect, **ADAM_TOL)
        np.testing.assert_allclose(o["flat/adam3/anchor"], expect,
                                   **ADAM_TOL)


def test_local_sgd_refusals_and_state():
    comm = create_communicator("naive")
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="sync_every"):
        create_local_sgd(torch.optim.SGD([p], lr=0.1), comm, sync_every=0)
    opt = create_local_sgd(torch.optim.SGD([p], lr=0.1), comm, sync_every=2)
    with pytest.raises(ValueError, match="sync cadence"):
        inner_transform(opt)
    p.grad = torch.ones(3)
    opt.step()
    sd = opt.state_dict()
    assert sd["step"] == 1 and torch.equal(sd["anchor"][0], torch.zeros(3))
    opt2 = create_local_sgd(torch.optim.SGD([p], lr=0.1), comm, sync_every=2)
    opt2.load_state_dict(sd)
    assert opt2.state_dict()["step"] == 1


def _optax_steps(tx, params, grads):
    state = tx.init(params)
    for g in grads:
        u, state = tx.update(g, state, params)
        params = optax.apply_updates(params, u)
    return params


@pytest.mark.parametrize("name,kw", [
    ("lars", {}), ("lars", {"weight_decay": 1e-2, "nesterov": True}),
    ("lamb", {}), ("lamb", {"weight_decay": 1e-2})])
def test_lars_and_lamb_match_optax_over_five_steps(name, kw):
    rs = np.random.RandomState(17)
    shapes = {"w": (3, 4), "b": (4,), "v": (5,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    p0["b"][:] = 0  # a zero norm: the trust ratio is 1 there
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    lr = 0.1 if name == "lars" else 0.01
    tx = (optax.lars if name == "lars" else optax.lamb)(lr, **kw)
    want = _optax_steps(tx, {k: jnp.asarray(v) for k, v in p0.items()},
                        [{k: jnp.asarray(v) for k, v in g.items()}
                         for g in grads])
    ps = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = (LARS if name == "lars" else LAMB)(list(ps.values()), lr=lr, **kw)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in ps.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   **TOL)


def test_mnist_twin_new_flags_learn_at_two_ranks():
    outs = run_distributed(twins_worker, 2, {}, timeout=300)
    for o in outs:
        for label in ("local_sgd", "two_level", "zero", "int8_ef"):
            assert float(o[f"mnist/{label}/val_acc"]) >= 0.9, label
    assert outs[0]["mnist/zero/val_loss"] == outs[1]["mnist/zero/val_loss"]


IMAGENET_TINY = ["--device", "cpu", "--arch", "resnet18", "--image-size",
                 "32", "--batchsize", "2", "--iterations", "2"]


@pytest.mark.parametrize("flags", [
    ["--optimizer", "lars"], ["--optimizer", "lamb"], ["--local-sgd", "2"],
    ["--allreduce-grad-dtype", "int8", "--error-feedback"]],
    ids=["lars", "lamb", "local-sgd", "int8-ef"])
def test_imagenet_twin_new_flags(flags, capsys):
    metrics = train_imagenet.main(IMAGENET_TINY + flags)
    assert math.isfinite(float(metrics["loss"]))
    assert "done: 2 iters" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--error-feedback", "--double-buffering"])
def test_imagenet_twin_refuses_local_sgd_with_the_wire_flags(flag, capsys):
    with pytest.raises(SystemExit):
        train_imagenet.main(IMAGENET_TINY + ["--local-sgd", "2", flag])
    assert "--local-sgd replaces" in capsys.readouterr().err


TRANSFORMER_TINY = ["--device", "cpu", "--num-layers", "1", "--d-model",
                    "32", "--seq-len", "48", "--batchsize", "2",
                    "--iterations", "2"]


@pytest.mark.parametrize("flags", [
    ["--local-sgd", "2"],
    ["--communicator", "two_dimensional", "--allreduce-grad-dtype", "int8",
     "--error-feedback"]], ids=["local-sgd", "two-dimensional-int8-ef"])
def test_transformer_twin_new_flags(flags, capsys):
    metrics = train_transformer_lm.main(TRANSFORMER_TINY + flags)
    assert math.isfinite(float(metrics["loss"]))
    assert "done (data-parallel)" in capsys.readouterr().out


def test_transformer_twin_refuses_local_sgd_with_the_wire_flags(capsys):
    with pytest.raises(SystemExit):
        train_transformer_lm.main(TRANSFORMER_TINY + [
            "--local-sgd", "2", "--error-feedback"])
    assert "--local-sgd replaces" in capsys.readouterr().err
