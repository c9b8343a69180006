"""The port's ResNet against the JAX package's flax ResNet, same weights.

Seeded flax variables (``torch_flax_params.random_variables``: random BN
scales and running statistics, so every parameter has a gradient) are
carried across with ``convert.resnet_state_from_flax``;
``ResNet18(num_classes=10, num_filters=8)`` and ``ResNet50(num_filters=4)``
see 32x32 images, so every stride-2 block sees an even input (8, 4, 2)
and pads (0, 1) under flax's 'SAME'.

- fp32 compute: logits, loss, every parameter gradient and the running
  statistics after one train-mode forward; eval mode (running averages);
- bf16 compute: ResNet18's logits within 2e-2 of their scale (max
  |logit|); ResNet-50's within twice the JAX reference's own bf16
  rounding, which is 3.2e-2 of the scale there;
- at n = 2 gloo ranks with sync-BN against the JAX 2-device mesh: fp32
  logits, loss, the rank-mean gradients and the running statistics, and
  the bf16 logits;
- the padding: XLA's SAME pads, and a symmetric (1, 1) stride-2 padding
  moves ResNet18's logits by 1.06 at a logit scale of 2.6 (it fails the
  1e-4 check);
- the port's own init and the options it leaves out.

Tolerance for fp32: 1e-4 relative and absolute, as the LM tests: fp32
convolutions and BN moments summed in other orders; a BN over the last
stage's 1x1 maps normalises over the batch alone and passes the most
rounding on to the gradients.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.models.resnet import ResNet18 as JaxResNet18
from chainermn_tpu.models.resnet import ResNet50 as JaxResNet50
from chainermn_tpu_torch.convert import resnet_state_from_flax
from chainermn_tpu_torch.models import ResNet18, ResNet50
from chainermn_tpu_torch.models import resnet
from torch_comm_workers import shared_launch
from torch_flax_params import random_variables
from torch_rank_workers import (
    resnet_worker,
    few_threads,  # noqa: F401
)

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 2e-2
B, HW = 8, 32
ARCHS = {"resnet18": (JaxResNet18, ResNet18, 8),
         "resnet50": (JaxResNet50, ResNet50, 4)}


def _batch(seed=0, batch=B):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, HW, HW, 3).astype(np.float32)
    return x, rs.randint(0, 10, batch).astype(np.int32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@functools.lru_cache(maxsize=None)
def _variables(arch):
    jcls, _, nf = ARCHS[arch]
    return random_variables(
        jcls(num_classes=10, num_filters=nf, compute_dtype=jnp.float32),
        (1, HW, HW, 3), seed=1, train=False)


def _port(arch, dtype=torch.float32, comm=None):
    _, tcls, nf = ARCHS[arch]
    model = tcls(num_classes=10, num_filters=nf, compute_dtype=dtype,
                 bn_comm=comm, device="cpu")
    v = _variables(arch)
    model.load_state_dict(resnet_state_from_flax(v["params"],
                                                 v["batch_stats"]))
    return model


def _jax_model(arch, dtype=jnp.float32, axis=None):
    jcls, _, nf = ARCHS[arch]
    return jcls(num_classes=10, num_filters=nf, compute_dtype=dtype,
                bn_axis_name=axis)


def _jax_train_loss(model):
    def loss_fn(params, stats, x, y):
        logits, mut = model.apply({"params": params, "batch_stats": stats},
                                  x, train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                               y).mean()
        return loss, (logits, mut["batch_stats"])
    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_fp32(arch):
    """Train-mode logits, loss, gradients and new stats; then eval-mode
    logits from those stats."""
    model = _jax_model(arch)
    v = _variables(arch)
    x, y = _batch()

    @jax.jit
    def run(params, stats):
        (loss, (logits, new)), g = jax.value_and_grad(
            _jax_train_loss(model), has_aux=True)(params, stats, x, y)
        evald = model.apply({"params": params, "batch_stats": new}, x,
                            train=False)
        return logits, loss, g, new, evald

    return jax.tree.map(np.asarray, run(v["params"], v["batch_stats"]))


def _assert_state(got: dict, want: dict, tol):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fp32_logits_loss_gradients_and_stats_match(arch):
    logits, loss, grads, stats, _ = _jax_fp32(arch)
    model = _port(arch)
    x, y = _batch()
    out = model(_nchw(x))
    got_loss = F.cross_entropy(out, torch.from_numpy(y).long())
    got_loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), logits, **TOL)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               **TOL)
    want = resnet_state_from_flax(grads, stats)
    _assert_state({n: p.grad.numpy() for n, p in model.named_parameters()},
                  {n: want[n] for n, _ in model.named_parameters()}, TOL)
    _assert_state({n: b.numpy() for n, b in model.named_buffers()},
                  {n: want[n] for n, _ in model.named_buffers()}, TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_eval_mode_uses_the_running_averages(arch):
    *_, stats, evald = _jax_fp32(arch)
    model = _port(arch)
    x, _ = _batch()
    model(_nchw(x))  # one train-mode forward moves the running stats
    model.eval()
    with torch.no_grad():
        out = model(_nchw(x))
    np.testing.assert_allclose(out.numpy(), evald, **TOL)


def _bf16_logits(arch):
    """JAX's and the port's train-mode logits at bf16 compute."""
    model = _jax_model(arch, jnp.bfloat16)
    v = _variables(arch)
    x, _ = _batch()
    want = np.asarray(jax.jit(lambda p, s: model.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"])[0])(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = _port(arch, torch.bfloat16)(_nchw(x))
    assert got.dtype == torch.float32
    return got.numpy(), want


def test_bf16_logits_match():
    got, want = _bf16_logits("resnet18")
    err = np.abs(got - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_bf16_resnet50_within_the_references_own_bf16_noise():
    """At 16 bottlenecks of 4-32 channels the bf16 rounding of the JAX
    reference itself moves its logits by 3.2e-2 of their scale against
    its fp32 logits (3.9e-2 for the port), above ``BF16_TOL``; the two
    bf16 runs round independently, so they are held to twice the
    reference's own bf16 drift (measured: 5.0e-2 of the scale)."""
    got, want = _bf16_logits("resnet50")
    fp32 = _jax_fp32("resnet50")[0]
    drift = np.abs(want - fp32).max()
    err = np.abs(got - want).max()
    assert drift > 0 and err <= 2 * drift, (err, drift)


@pytest.mark.parametrize("size,k,stride", [
    (56, 3, 2), (28, 3, 2), (14, 3, 2), (8, 3, 2), (7, 3, 2), (56, 1, 2),
    (56, 3, 1), (224, 7, 2), (5, 3, 3), (1, 3, 2)])
def test_same_pads_equal_xla(size, k, stride):
    want = lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0]
    assert resnet.same_pads(size, k, stride) == tuple(want)


def test_symmetric_stride2_padding_is_caught(monkeypatch):
    """With (1, 1) in place of SAME's (0, 1) at the stride-2 3x3
    convolutions, the logits move far past the 1e-4 tolerance (measured:
    1.06, at a logit scale of 2.6)."""
    logits = _jax_fp32("resnet18")[0]
    x, _ = _batch()

    def symmetric(size, k, stride):
        return (k // 2, k // 2)

    monkeypatch.setattr(resnet, "same_pads", symmetric)
    with torch.no_grad():
        wrong = _port("resnet18")(_nchw(x)).numpy()
    diff = np.abs(wrong - logits).max()
    assert diff > 100 * TOL["atol"], diff
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(wrong, logits, **TOL)


# ----------------------------------------------------------- two ranks


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    v = _variables("resnet18")
    x, y = _batch(3)
    sd = resnet_state_from_flax(v["params"], v["batch_stats"])
    inputs = {"x": _nchw(x).numpy(), "y": y,
              **{"sd/" + k: t.numpy() for k, t in sd.items()}}
    return shared_launch("resnet_worker2", tmp_path_factory, resnet_worker,
                         2, inputs)


@functools.lru_cache(maxsize=None)
def _jax_two_devices():
    comm = chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:2])
    ax = comm.bn_axis_name
    v = _variables("resnet18")
    x, y = _batch(3)
    loss32 = _jax_train_loss(_jax_model("resnet18", axis=ax))
    model16 = _jax_model("resnet18", jnp.bfloat16, axis=ax)

    def body(params, stats, xl, yl):
        (loss, (logits, new)), g = jax.value_and_grad(
            loss32, has_aux=True)(params, stats, xl, yl)
        logits16 = model16.apply({"params": params, "batch_stats": stats},
                                 xl, train=True, mutable=["batch_stats"])[0]
        return (logits, lax.pmean(loss, ax), lax.pmean(g, ax), new,
                logits16)

    out = jax.jit(shard_map(
        body, mesh=comm.mesh, in_specs=(P(), P(), P(ax), P(ax)),
        out_specs=(P(ax), P(), P(), P(), P(ax)), check_vma=False))(
            v["params"], v["batch_stats"], x, y)
    return jax.tree.map(np.asarray, out)


def test_two_ranks_fp32_match_the_jax_mesh(two_ranks):
    logits, loss, grads, stats, _ = _jax_two_devices()
    np.testing.assert_allclose(
        np.concatenate([o["float32/logits"] for o in two_ranks]), logits,
        **TOL)
    np.testing.assert_allclose(np.mean([o["loss"] for o in two_ranks]),
                               loss, **TOL)
    want = resnet_state_from_flax(grads, stats)
    for name, w in want.items():
        if "running" in name:
            for o in two_ranks:
                np.testing.assert_allclose(o["stats/" + name], w.numpy(),
                                           err_msg=name, **TOL)
        else:
            np.testing.assert_allclose(
                np.mean([o["grad/" + name] for o in two_ranks], axis=0),
                w.numpy(), err_msg=name, **TOL)


def test_two_ranks_bf16_logits_match_the_jax_mesh(two_ranks):
    want = _jax_two_devices()[4]
    got = np.concatenate([o["bfloat16/logits"] for o in two_ranks])
    err = np.abs(got - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), (err, np.abs(want).max())


# ----------------------------------------------------------- the port's own


def test_port_init_follows_flax():
    model = ResNet50(num_classes=10, num_filters=4, seed=3, device="cpu")
    v = _variables("resnet50")
    assert set(model.state_dict()) == set(
        resnet_state_from_flax(v["params"], v["batch_stats"]))
    for blk in model.blocks:
        assert torch.all(blk.norm2.weight == 0)
        assert torch.all(blk.norm0.weight == 1)
    w = model.blocks[3].conv1.weight  # 3x3, fan_in 9 x 8
    assert abs(float(w.detach().std()) * (9 * 8) ** 0.5 - 1) < 0.1
    bound = 2 / 0.8796 / (9 * 8) ** 0.5  # two truncated stds
    assert float(w.detach().abs().max()) <= bound + 1e-6
    again = ResNet50(num_classes=10, num_filters=4, seed=3, device="cpu")
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(remat=True), dict(remat_policy="conv"),
                                dict(stem="space_to_depth")])
def test_left_out_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 3.6"):
        ResNet18(num_classes=10, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown stem"):
        ResNet18(num_classes=10, device="cpu", stem="patchify")
