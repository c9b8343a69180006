"""The port's synchronized BatchNorm against the JAX package's
``MultiNodeBatchNormalization`` at n = 2 and 4 gloo ranks, each holding a
contiguous slice of the global batch (the JAX n-device CPU mesh's shards).

Compared, for an ``[N, C]`` and an ``[N, C, H, W]`` input (NHWC on the
JAX side): the output, the running statistics after one train-mode
forward (momentum 0.9), the eval-mode output, and the gradients of the
input, scale and bias of ``sum(y * dy)`` — each shard's own, as the JAX
shard_map step differentiates its local loss through ``lax.psum``. The
input gradient at n >= 2 is the check that fails when the backward does
not all_reduce. Then the same results against the port's own one-rank BN
over the concatenated batch (the port's copy of
``tests/test_links.py::test_sync_bn_equals_big_batch_bn``): outputs and
input gradients equal, scale and bias gradients summed over the ranks.

Tolerance 1e-5 (relative and absolute): fp32 moments summed in another
order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.links.batch_normalization import (
    MultiNodeBatchNormalization as JaxBN,
)
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.links import MultiNodeBatchNormalization
from torch_comm_workers import shared_launch
from torch_rank_workers import (
    sync_bn_worker,
    few_threads,  # noqa: F401
)

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {"2d": (8, 6), "4d": (8, 5, 3, 3)}


def _inputs():
    rs = np.random.RandomState(0)
    out = {}
    for case, shape in CASES.items():
        c = shape[1]
        out[f"{case}/x"] = (rs.randn(*shape) * 3 + 1).astype(np.float32)
        out[f"{case}/dy"] = rs.randn(*shape).astype(np.float32)
        out[f"{case}/w"] = rs.uniform(0.5, 1.5, c).astype(np.float32)
        out[f"{case}/b"] = rs.uniform(-1, 1, c).astype(np.float32)
    return out


INPUTS = _inputs()


def _nhwc(a):
    return np.moveaxis(a, 1, -1) if a.ndim == 4 else a


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1) if a.ndim == 4 else \
        np.asarray(a)


@functools.lru_cache(maxsize=None)
def _jax(case, n):
    """y, dx, per-shard dscale/dbias (stacked), running mean/var and the
    eval output of JAX's sync-BN over an n-device mesh."""
    x, dy = _nhwc(INPUTS[f"{case}/x"]), _nhwc(INPUTS[f"{case}/dy"])
    comm = chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:n])
    bn = JaxBN(use_running_average=False, axis_name=comm.bn_axis_name,
               momentum=0.9)
    variables = bn.init(jax.random.key(0), x[:1])
    params = {"scale": jnp.asarray(INPUTS[f"{case}/w"]),
              "bias": jnp.asarray(INPUTS[f"{case}/b"])}
    stats = variables["batch_stats"]

    def body(params, xl, dyl):
        def loss(params, xl):
            y, upd = bn.apply({"params": params, "batch_stats": stats}, xl,
                              mutable=["batch_stats"])
            return jnp.sum(y * dyl), (y, upd["batch_stats"])

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, xl)
        evald = bn.clone(use_running_average=True).apply(
            {"params": params, "batch_stats": upd}, xl)
        return (y, gx, jax.tree.map(lambda g: g[None], gp), upd["mean"],
                upd["var"], evald)

    ax = comm.bn_axis_name
    out = jax.jit(shard_map(
        body, mesh=comm.mesh, in_specs=(P(), P(ax), P(ax)),
        out_specs=(P(ax), P(ax), P(ax), P(), P(), P(ax)),
        check_vma=False))(params, x, dy)
    y, gx, gp, mean, var, evald = jax.tree.map(np.asarray, out)
    return dict(y=_nchw(y), dx=_nchw(gx), dw=gp["scale"], db=gp["bias"],
                mean=mean, var=var, y_eval=_nchw(evald))


def _single(case):
    """The port's one-rank BN over the whole batch."""
    create_communicator("naive")
    x = torch.from_numpy(INPUTS[f"{case}/x"]).requires_grad_()
    bn = MultiNodeBatchNormalization(x.shape[1], momentum=0.9, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(INPUTS[f"{case}/w"]))
        bn.bias.copy_(torch.from_numpy(INPUTS[f"{case}/b"]))
    y = bn(x)
    (y * torch.from_numpy(INPUTS[f"{case}/dy"])).sum().backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def ranks(request, tmp_path_factory):
    return request.param, shared_launch(
        f"sync_bn_worker{request.param}", tmp_path_factory, sync_bn_worker,
        request.param, INPUTS)


def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_running_stats_equal_jax(ranks, case):
    n, outs = ranks
    want = _jax(case, n)
    np.testing.assert_allclose(_cat(outs, f"{case}/y"), want["y"], **TOL)
    np.testing.assert_allclose(_cat(outs, f"{case}/y_eval"),
                               want["y_eval"], **TOL)
    for out in outs:
        np.testing.assert_allclose(out[f"{case}/mean"], want["mean"], **TOL)
        np.testing.assert_allclose(out[f"{case}/var"], want["var"], **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_equal_jax(ranks, case):
    n, outs = ranks
    want = _jax(case, n)
    np.testing.assert_allclose(_cat(outs, f"{case}/dx"), want["dx"], **TOL)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{case}/dw"], want["dw"][r], **TOL)
        np.testing.assert_allclose(out[f"{case}/db"], want["db"][r], **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_equals_one_rank_bn_over_the_whole_batch(ranks, case):
    _, outs = ranks
    want = _single(case)
    for key in ("y", "dx"):
        np.testing.assert_allclose(_cat(outs, f"{case}/{key}"), want[key],
                                   **TOL)
    for key in ("dw", "db"):
        np.testing.assert_allclose(sum(o[f"{case}/{key}"] for o in outs),
                                   want[key], **TOL)
    for out in outs:
        for key in ("mean", "var"):
            np.testing.assert_allclose(out[f"{case}/{key}"], want[key],
                                       **TOL)


def test_biased_variance_and_flax_momentum():
    """The running variance takes the biased batch variance, and the EMA
    weighs the old value by ``momentum`` (torch's BN does neither)."""
    x = torch.from_numpy(INPUTS["2d/x"])
    bn = MultiNodeBatchNormalization(6, momentum=0.9, device="cpu")
    bn(x)
    xd = INPUTS["2d/x"].astype(np.float64)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * xd.var(0), rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * xd.mean(0),
                               rtol=1e-5, atol=1e-6)


def test_bf16_input_normalises_in_fp32():
    x = torch.from_numpy(INPUTS["4d/x"]).bfloat16().requires_grad_()
    bn = MultiNodeBatchNormalization(5, device="cpu")
    y = bn(x)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert bn.weight.grad.dtype == torch.float32
    ref = MultiNodeBatchNormalization(5, device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(ref(x.detach().float()).detach().numpy(),
                               y.detach().float().numpy(), atol=2e-2)


def test_for_communicator_and_options():
    comm = create_communicator("naive")
    bn = MultiNodeBatchNormalization.for_communicator(comm, 4, device="cpu",
                                                      use_bias=False,
                                                      scale_init=0.0)
    assert bn.comm is comm and bn.bias is None
    assert torch.equal(bn.weight, torch.zeros(4))
    pinned = MultiNodeBatchNormalization(4, use_running_average=True,
                                         device="cpu")
    x = torch.randn(3, 4)
    torch.testing.assert_close(pinned(x), x / (1 + 1e-5) ** 0.5)
    assert torch.equal(pinned.running_mean, torch.zeros(4))
