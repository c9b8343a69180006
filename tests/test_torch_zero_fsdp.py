"""The port's ZeRO and FSDP (``chainermn_tpu_torch.parallel.zero`` and
``.fsdp``) against the JAX package's, case for case with
tests/test_zero.py and tests/test_fsdp.py, at 2 and 4 gloo ranks
(``tests/torch_tp_workers.py::zero_fsdp_worker``, one launch per world
size) against the JAX side on an n-device CPU mesh:

- ZeRO: 3 AdamW steps of the JAX test's odd-shaped leaves (17 x 9, 9,
  9 x 5), each rank on its share of the batch, equal to JAX's ZeRO inside
  ``shard_map`` and to full-state AdamW on the whole batch; each rank's
  Adam moments hold ``ceil(size / n)`` elements of every leaf (JAX's
  ``n * chunk`` concatenated over the mesh axis), placed ``Shard(0)``
  with the step counter ``Replicate()``; one step makes one
  reduce-scatter and one all-gather of one buffer that holds every
  leaf's rows, and nothing else; a load between steps is followed;
- FSDP: the placement rule of ``fsdp_shardings`` leaf for leaf; 3 AdamW
  steps of the MLP (64 units) with parameters and state sharded (the
  hidden kernel's local shard is strictly smaller), the losses and the
  parameters equal to JAX's FSDP step and to JAX's replicated data
  parallelism; a module buffer that the forward updates rides along,
  the same on every rank.

Tolerances: tests/test_zero.py's and tests/test_fsdp.py's own, 1e-5
relative and 1e-6 absolute (fp32; optax's AdamW and torch's round
differently), except the MLP's parameters after 3 FSDP steps, 1e-5
absolute: Adam divides each gradient element by its own root mean
square, so where a gradient element is near zero (a bias behind a ReLU
that is off for most rows) a last-bit difference between the two
frameworks' gradients moves that element's update by up to ~3e-6, a
three-hundredth of the learning rate (1e-2); the losses keep 1e-5
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.optimizers import create_multi_node_optimizer
from chainermn_tpu.parallel.fsdp import (
    create_fsdp_train_state,
    fsdp_shardings as jax_fsdp_shardings,
    make_fsdp_train_step,
)
from chainermn_tpu.parallel.zero import zero_shard_optimizer, zero_state_specs
from chainermn_tpu.training.train_step import (
    create_train_state,
    make_train_step,
)
from chainermn_tpu_torch.convert import mlp_state_from_flax
from chainermn_tpu_torch.parallel.fsdp import fsdp_shardings
from chainermn_tpu_torch.parallel.zero import zero_plan_axis
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import run_once
from torch_rank_workers import few_threads  # noqa: F401
from torch_tp_workers import CALLS, ZERO_PARAMS, zero_fsdp_worker

SIZES = (2, 4)
TOL = dict(rtol=1e-5, atol=1e-6)
MLP_PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


def _zero_params():
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    return {"w1": jax.random.normal(ks[0], (17, 9)),
            "b1": jax.random.normal(ks[1], (9,)),
            "w2": jax.random.normal(ks[2], (9, 5))}


def _zero_loss(params, x, y):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return ((h @ params["w2"] - y) ** 2).mean()


def _zero_side(n):
    """tests/test_zero.py's ``test_matches_unsharded_adam`` on an n-device
    mesh: JAX's ZeRO params after 3 steps, the full-state reference, and
    the state's moment shapes."""
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("data",))
    params = _zero_params()
    x = jax.random.normal(jax.random.PRNGKey(1), (4 * n, 17))
    y = jax.random.normal(jax.random.PRNGKey(2), (4 * n, 5))
    inner = optax.adamw(1e-2)
    ref, ref_state = params, inner.init(params)
    for _ in range(3):
        g = jax.grad(_zero_loss)(ref, x, y)
        u, ref_state = inner.update(g, ref_state, ref)
        ref = optax.apply_updates(ref, u)
    zopt = zero_shard_optimizer(inner, "data")
    spec = zero_state_specs(inner, params, n, "data")
    zstate = jax.jit(shard_map(zopt.init, mesh=mesh, in_specs=P(),
                               out_specs=spec, check_vma=False))(params)

    def local_step(p, zs, xb, yb):
        g = jax.lax.pmean(jax.grad(_zero_loss)(p, xb, yb), "data")
        u, zs = zopt.update(g, zs, p)
        return optax.apply_updates(p, u), zs

    step = jax.jit(shard_map(local_step, mesh=mesh,
                             in_specs=(P(), spec, P("data"), P("data")),
                             out_specs=(P(), spec), check_vma=False))
    zp = params
    for _ in range(3):
        zp, zstate = step(zp, zstate, x, y)
    mu = {k: zstate[0].mu[k].shape for k in ZERO_PARAMS}
    inputs = {"zero/x": np.asarray(x), "zero/y": np.asarray(y),
              **{f"zero/{k}": np.asarray(v) for k, v in params.items()}}
    return inputs, zp, ref, mu


def _batch(n=32):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 10).astype(np.float32),
            rng.randint(0, 4, size=n).astype(np.int32))


def _fsdp_side(n):
    """tests/test_fsdp.py's ``test_fsdp_step_matches_replicated_dp`` on an
    n-device communicator: the FSDP step's and the replicated step's
    losses and parameters after 3 steps."""
    comm = chainermn_tpu.create_communicator(
        "naive", devices=jax.devices("cpu")[:n])
    model = JaxMLP(n_units=64, n_out=4)
    x, y = _batch()
    params = model.init(jax.random.key(0), x[:1])["params"]

    def loss_fn(p, batch):
        xb, yb = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply({"params": p}, xb), yb).mean()

    opt_ref = create_multi_node_optimizer(optax.adamw(1e-2), comm)
    state_ref = create_train_state(params, opt_ref, comm)
    step_ref = make_train_step(loss_fn, opt_ref, comm, donate=False)
    opt = optax.adamw(1e-2)
    state, shardings = create_fsdp_train_state(params, opt, comm,
                                               min_size=2**8)
    step = make_fsdp_train_step(loss_fn, opt, comm, shardings, donate=False)
    losses, ref_losses = [], []
    for _ in range(3):
        state_ref, m_ref = step_ref(state_ref, (x, y))
        state, m = step(state, (x, y))
        losses.append(float(m["loss"]))
        ref_losses.append(float(m_ref["loss"]))
    sd = mlp_state_from_flax(jax.tree.map(np.asarray, params))
    inputs = {"fsdp/x": x, "fsdp/y": y,
              **{f"fsdp/sd/{k}": v.numpy() for k, v in sd.items()}}
    want = {"losses": np.array(losses), "ref_losses": np.array(ref_losses),
            "params": mlp_state_from_flax(
                jax.tree.map(np.asarray, state.params)),
            "ref_params": mlp_state_from_flax(
                jax.tree.map(np.asarray, state_ref.params))}
    return inputs, want


def _runs():
    res = {}
    for n in SIZES:
        zin, zp, ref, mu = _zero_side(n)
        fin, fwant = _fsdp_side(n)
        outs = run_distributed(zero_fsdp_worker, n, {**zin, **fin},
                               timeout=180)
        res[n] = (outs, jax.tree.map(np.asarray, zp),
                  jax.tree.map(np.asarray, ref), mu, fwant)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides once per test run (``run_once``: the xdist workers share
    the JAX references and the rank launch)."""
    return run_once("zero_fsdp_runs", _runs, tmp_path_factory)


@pytest.mark.parametrize("n", SIZES)
def test_zero_matches_jax_zero_and_unsharded_adam(runs, n):
    outs, zp, ref, _, _ = runs[n]
    for o in outs:
        for k in ZERO_PARAMS:
            np.testing.assert_allclose(o[f"zero/{k}"], np.asarray(zp[k]),
                                       **TOL, err_msg=k)
            np.testing.assert_allclose(o[f"zero/{k}"], np.asarray(ref[k]),
                                       **TOL, err_msg=k)


@pytest.mark.parametrize("n", SIZES)
def test_zero_state_is_sharded(runs, n):
    """Each rank's moments hold one chunk of ``ceil(size / n)``: JAX's
    global moment leaf is the ``n`` chunks concatenated."""
    outs, _, _, mu, _ = runs[n]
    for o in outs:
        for k in ZERO_PARAMS:
            assert tuple(n * o[f"zero/mu/{k}"]) == mu[k], k
            assert o[f"zero/spec/{k}"].tolist() == ["Shard(dim=0)",
                                                    "Replicate()"]


@pytest.mark.parametrize("n", SIZES)
def test_zero_step_is_one_reduce_scatter_and_one_all_gather_per_leaf(
        runs, n):
    """Every leaf's rows ride in one buffer: a step makes one
    reduce-scatter and one all-gather in all (the leaves share a dtype),
    and nothing else."""
    want = dict.fromkeys(CALLS, 0)
    want["reduce_scatter_tensor"] = 1
    want["all_gather_into_tensor"] = 1
    for o in runs[n][0]:
        got = dict(zip(CALLS, o["zero/calls"].tolist()))
        assert got == want


@pytest.mark.parametrize("n", SIZES)
def test_zero_step_follows_a_load_between_steps(runs, n):
    """Parameters written between steps (a checkpoint load) are what the
    next step updates: it equals the step of an optimizer built over the
    written values with the same state, bit for bit."""
    for o in runs[n][0]:
        assert bool(o["zero/reload_equal"])


def test_zero_compressed_wire_is_left_for_later():
    """The compressed wire is ported (the JAX ``compress_dtype``): at one
    rank a bf16 wire step equals AdamW on the bf16-rounded gradients,
    bit for bit; the int8 wire has no scatter form and raises."""
    import functools

    import torch

    from chainermn_tpu_torch.communicators import create_communicator
    from chainermn_tpu_torch.parallel.zero import zero_shard_optimizer

    create_communicator("naive")  # the one-rank group
    g = torch.tensor([0.1234567, -3.3333333, 7e-3])
    p = torch.zeros(3, requires_grad=True)
    ref = torch.zeros(3, requires_grad=True)
    opt = zero_shard_optimizer(functools.partial(torch.optim.AdamW, lr=1e-3),
                               [p], compress_dtype="bfloat16")
    plain = torch.optim.AdamW([ref], lr=1e-3)
    p.grad, ref.grad = g.clone(), g.to(torch.bfloat16).float()
    opt.step()
    plain.step()
    assert torch.equal(p.detach(), ref.detach())
    with pytest.raises(ValueError, match="int8"):
        zero_shard_optimizer(functools.partial(torch.optim.AdamW, lr=1e-3),
                             [torch.zeros(3)], compress_dtype="int8")


def test_zero_plan_surface_is_left_for_the_plan():
    """The plan's ZeRO surface is ported: the provider descriptor is the
    JAX package's (tests/test_torch_plan.py drives it)."""
    from chainermn_tpu.parallel.zero import zero_plan_axis as jax_axis

    assert zero_plan_axis() == jax_axis()


def _placement_of_spec(spec):
    names = tuple(spec)
    if "data" not in names:
        return "Replicate()"
    return f"Shard(dim={names.index('data')})"


@pytest.mark.parametrize("n", SIZES)
def test_fsdp_shardings_rules(n):
    shapes = {"big": (1024, 64), "tall": (63, 4096), "bias": (64,),
              "odd": (999, 999)}
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("data",))
    want = jax_fsdp_shardings({k: jnp.zeros(s) for k, s in shapes.items()},
                              mesh, "data", min_size=2**10)
    import torch

    got = fsdp_shardings({k: torch.zeros(s) for k, s in shapes.items()}, n,
                         min_size=2**10)
    for k in shapes:
        assert repr(got[k][0]) == _placement_of_spec(want[k].spec), k
    assert repr(got["big"][0]) == "Shard(dim=0)"
    assert repr(got["tall"][0]) == "Shard(dim=1)"


@pytest.mark.parametrize("n", SIZES)
def test_fsdp_step_matches_jax_fsdp_and_replicated_dp(runs, n):
    outs, *_, want = runs[n]
    for o in outs:
        np.testing.assert_allclose(o["fsdp/losses"], want["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o["fsdp/losses"], want["ref_losses"],
                                   rtol=1e-5)
        for name, p in want["params"].items():
            np.testing.assert_allclose(o[f"fsdp/p/{name}"], p.numpy(),
                                       **MLP_PARAM_TOL, err_msg=name)
            np.testing.assert_allclose(o[f"fsdp/p/{name}"],
                                       want["ref_params"][name].numpy(),
                                       **MLP_PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("n", SIZES)
def test_fsdp_shards_the_hidden_kernel_and_its_state(runs, n):
    """The 64 x 64 hidden kernel is sharded (each rank holds a strictly
    smaller block), and so is its Adam moment; the biases are below
    ``min_size`` and stay replicated."""
    for o in runs[n][0]:
        local = tuple(o["fsdp/local/dense1.weight"])
        assert local != (64, 64) and np.prod(local) == 64 * 64 // n
        assert tuple(o["fsdp/exp_avg_local"]) == local
        assert str(o["fsdp/placement/dense1.weight"]).startswith("Shard")
        assert str(o["fsdp/placement/dense1.bias"]) == "Replicate()"


@pytest.mark.parametrize("n", SIZES)
def test_fsdp_module_state_rides_along(runs, n):
    """A buffer the forward updates (the JAX ``model_state``) is the mean
    of the ranks' values after the step, the same on every rank."""
    outs = runs[n][0]
    rows = 16 // n
    want = np.mean([rows * (r + 1) for r in range(n)])
    for o in outs:
        assert float(o["fsdp/seen"]) == want
        assert np.isfinite(o["fsdp/seen_loss"])
