"""The port's data-parallel steps at 2 gloo ranks against the JAX
package's ``make_train_step`` on a 2-device CPU mesh, same weights and
batches (each rank holds its contiguous half of the JAX global batch).

- MLP (16 -> 32 -> 32 -> 10): logits, loss and gradients (1e-5); then
  3 steps of SGD(0.05, momentum 0.9) behind
  ``create_multi_node_optimizer`` on the fp32 wire, the bf16 wire and
  with double buffering: each step's loss and the parameters after step
  3. Tolerance 1e-5 (relative and absolute): fp32 with sums in other
  orders. On the bf16 wire 2e-5: a gradient element that lands next to a
  bf16 rounding boundary can round the other way on one side, which
  moves its update by one bf16 ulp of the gradient times the learning
  rate (~2e-4 x |g|), carried on by the momentum.
- ResNet18 (8 filters, fp32, 32x32) with sync-BN, the port's twin of
  ``tests/test_models.py::TestResNetDistributed``: one step of SGD(0.1)
  and two of SGD(0.1, momentum 0.9), against the JAX mesh step with
  ``model_state`` and against the port's own one-rank step on the full
  batch; parameters and running statistics within JAX's own tolerance
  there, rtol 2e-4 and atol 2e-5.
- The Trainer over a scattered shard and the synchronized iterator logs
  the same rank-mean losses on every rank; ``make_eval_step`` and the
  Trainer's left-out window.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.models.mlp import MLP as JaxMLP
from chainermn_tpu.models.resnet import ResNet18 as JaxResNet18
from chainermn_tpu.training.train_step import (
    create_train_state as jax_create_state,
    make_train_step as jax_make_step,
)
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.convert import (
    mlp_state_from_flax,
    resnet_state_from_flax,
)
from chainermn_tpu_torch.models import MLP, ResNet18
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.training import (
    Trainer,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from torch_comm_workers import shared_launch
from torch_flax_params import random_variables
from torch_rank_workers import (
    dp_training_worker,
    mlp_loss,
    resnet_loss,
    few_threads,  # noqa: F401
)

N = 2
MLP_TOL = dict(rtol=1e-5, atol=1e-5)
MLP_BF16_TOL = dict(rtol=2e-5, atol=2e-5)
RESNET_TOL = dict(rtol=2e-4, atol=2e-5)
MLP_CASES = {"fp32": (None, False), "bf16": ("bfloat16", False),
             "db": (None, True)}
RESNET_CASES = {"sgd": (None, 1), "momentum": (0.9, 2)}


def _mlp_batches():
    rs = np.random.RandomState(4)
    return [(rs.randn(8, 16).astype(np.float32),
             rs.randint(0, 10, 8).astype(np.int32)) for _ in range(3)]


def _rn_batches():
    rs = np.random.RandomState(5)
    return [(rs.randn(8, 32, 32, 3).astype(np.float32),
             rs.randint(0, 10, 8).astype(np.int32)) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _mlp_params():
    return random_variables(JaxMLP(n_units=32, n_out=10), (1, 16),
                            seed=2)["params"]


@functools.lru_cache(maxsize=None)
def _rn_variables():
    return random_variables(
        JaxResNet18(num_classes=10, num_filters=8,
                    compute_dtype=jnp.float32), (1, 32, 32, 3), seed=3,
        train=False)


def _nchw(x):
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def _jax_comm(wire=None):
    return chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:N], allreduce_grad_dtype=wire)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {f"mlp/sd/{k}": v.numpy()
              for k, v in mlp_state_from_flax(_mlp_params()).items()}
    for i, (x, y) in enumerate(_mlp_batches()):
        inputs[f"mlp/x{i}"], inputs[f"mlp/y{i}"] = x, y
    v = _rn_variables()
    for k, t in resnet_state_from_flax(v["params"],
                                       v["batch_stats"]).items():
        inputs[f"rn/sd/{k}"] = t.numpy()
    for i, (x, y) in enumerate(_rn_batches()):
        inputs[f"rn/x{i}"], inputs[f"rn/y{i}"] = _nchw(x), y
    return shared_launch("dp_training_worker", tmp_path_factory,
                         dp_training_worker, N, inputs)


# ------------------------------------------------------------------ MLP


@functools.lru_cache(maxsize=None)
def _jax_mlp(case):
    wire, db = MLP_CASES[case]
    model = JaxMLP(n_units=32, n_out=10)

    def loss_fn(params, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": params}, x), y).mean()

    comm = _jax_comm(wire)
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.05, momentum=0.9), comm, double_buffering=db)
    state = jax_create_state(_mlp_params(), opt, comm)
    step = jax_make_step(loss_fn, opt, comm)
    losses = []
    for x, y in _mlp_batches():
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
    return losses, mlp_state_from_flax(jax.tree.map(np.asarray,
                                                    state.params))


def test_mlp_logits_and_gradients_match():
    x, y = _mlp_batches()[0]
    model = JaxMLP(n_units=32, n_out=10)

    def loss_fn(params):
        logits = model.apply({"params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        _mlp_params())
    port = MLP(n_units=32, n_out=10, in_features=16, device="cpu")
    port.load_state_dict(mlp_state_from_flax(_mlp_params()))
    got = port(torch.from_numpy(x))
    got_loss = mlp_loss(port, (torch.from_numpy(x), torch.from_numpy(y)))
    got_loss.backward()
    np.testing.assert_allclose(got.detach().numpy(), logits, **MLP_TOL)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               **MLP_TOL)
    want = mlp_state_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **MLP_TOL)


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_three_steps_match_the_jax_mesh(ranks, case):
    tol = MLP_BF16_TOL if case == "bf16" else MLP_TOL
    losses, params = _jax_mlp(case)
    for out in ranks:
        np.testing.assert_allclose(out[f"mlp/{case}/losses"], losses, **tol)
        for name, want in params.items():
            np.testing.assert_allclose(out[f"mlp/{case}/{name}"],
                                       want.numpy(), err_msg=name, **tol)


# --------------------------------------------------------------- ResNet


@functools.lru_cache(maxsize=None)
def _jax_resnet(case):
    momentum, steps = RESNET_CASES[case]
    comm = _jax_comm()
    model = JaxResNet18(num_classes=10, num_filters=8,
                        compute_dtype=jnp.float32,
                        bn_axis_name=comm.bn_axis_name)

    def loss_fn(params, batch, model_state):
        x, y = batch
        logits, mut = model.apply(
            {"params": params, "batch_stats": model_state}, x, train=True,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                               y).mean()
        return loss, ({}, mut["batch_stats"])

    v = _rn_variables()
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.1, momentum=momentum), comm)
    state = jax_create_state(v["params"], opt, comm,
                             model_state=v["batch_stats"])
    step = jax_make_step(loss_fn, opt, comm)
    losses = []
    for x, y in _rn_batches()[:steps]:
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
    return losses, resnet_state_from_flax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.model_state))


def _port_one_rank_resnet(case):
    """The port's step on one rank over the full batch, local BN."""
    momentum, steps = RESNET_CASES[case]
    comm = create_communicator("naive")
    model = ResNet18(num_classes=10, num_filters=8,
                     compute_dtype=torch.float32, device="cpu")
    v = _rn_variables()
    model.load_state_dict(resnet_state_from_flax(v["params"],
                                                 v["batch_stats"]))
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1,
                        momentum=momentum or 0.0), comm)
    state = create_train_state(model, opt, comm)
    step = make_train_step(resnet_loss, opt, comm)
    losses = []
    for x, y in _rn_batches()[:steps]:
        state, metrics = step(state, (torch.from_numpy(_nchw(x)),
                                      torch.from_numpy(y)))
        losses.append(float(metrics["loss"]))
    return losses, {k: t.numpy() for k, t in model.state_dict().items()}


@pytest.mark.parametrize("case", list(RESNET_CASES))
def test_resnet_sync_bn_step_matches_the_jax_mesh(ranks, case):
    losses, state = _jax_resnet(case)
    for out in ranks:
        np.testing.assert_allclose(out[f"rn/{case}/losses"], losses,
                                   **RESNET_TOL)
        for name, want in state.items():
            np.testing.assert_allclose(out[f"rn/{case}/{name}"],
                                       want.numpy(), err_msg=name,
                                       **RESNET_TOL)


@pytest.mark.parametrize("case", list(RESNET_CASES))
def test_resnet_two_ranks_equal_one_rank_on_the_full_batch(ranks, case):
    losses, state = _port_one_rank_resnet(case)
    for out in ranks:
        np.testing.assert_allclose(out[f"rn/{case}/losses"], losses,
                                   **RESNET_TOL)
        for name, want in state.items():
            np.testing.assert_allclose(out[f"rn/{case}/{name}"], want,
                                       err_msg=name, **RESNET_TOL)


# -------------------------------------------------------------- Trainer


def test_trainer_logs_the_rank_mean_on_every_rank(ranks):
    seen = [out["trainer/losses"] for out in ranks]
    assert len(seen[0]) == 3 and np.all(np.isfinite(seen[0]))
    np.testing.assert_array_equal(seen[0], seen[1])


def test_trainer_at_one_rank_logs_and_runs_extensions():
    comm = create_communicator("naive")
    model = MLP(n_units=8, n_out=10, in_features=16, device="cpu")
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.05), comm)
    x, y = _mlp_batches()[0]
    log = io.StringIO()
    trainer = Trainer(make_train_step(mlp_loss, opt, comm),
                      create_train_state(model, opt, comm),
                      [[(x[i], y[i]) for i in range(4)]], comm,
                      log_interval=2, out=log)
    calls = []
    trainer.extend(lambda tr: calls.append(tr.iteration), interval=2)
    state = trainer.run(5)
    assert state.step == 5 and trainer.iteration == 5
    assert calls == [2, 4]
    assert "iter 2/5 loss=" in log.getvalue()
    assert "iter 5/5 loss=" in log.getvalue()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        trainer.consume_phase_window()


def test_eval_step_runs_in_eval_mode_without_gradients():
    comm = create_communicator("naive")
    model = ResNet18(num_classes=10, num_filters=4,
                     compute_dtype=torch.float32, device="cpu")
    x, y = _rn_batches()[0]
    batch = (torch.from_numpy(_nchw(x)), torch.from_numpy(y))
    before = model.bn_init.running_mean.clone()

    def metric_fn(m, b):
        assert not m.training and not torch.is_grad_enabled()
        return {"val_loss": resnet_loss(m, b)[0]}

    metrics = make_eval_step(metric_fn, comm)(model, batch)
    assert model.training and set(metrics) == {"val_loss"}
    assert torch.equal(model.bn_init.running_mean, before)
    model.eval()
    with torch.no_grad():
        want = resnet_loss(model, batch)[0]
    torch.testing.assert_close(metrics["val_loss"], want)
