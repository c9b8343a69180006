"""Error feedback on the int8 wire (``MultiNodeOptimizer(
error_feedback=True)``) against the JAX wrapper over 3 SGD steps, in its
flat form (a per-rank fp32 residual shaped as the parameters: the naive
communicator's one axis, and the hierarchical communicator's two axes
merged) and its shard-level form (one ``[two_level_shard_len(bucket,
n_intra)]`` residual a bucket: ``two_dimensional``), with one bucket and
with a bucket size that splits the leaves; then a resume through the npz
checkpointer that gives each rank its own residual back. 4 gloo ranks
(``tests/torch_comm_workers.py::ef_worker``, one launch); the JAX side
carries each rank's residual through ``shard_map``, stacked over the
grad axes as its ``create_train_state`` lays it out.

Tolerances, held at every step as the int8 wire's mean is held
(``test_torch_wires``): each rank's parameters and residuals within one
code of JAX's everywhere (a code: the largest |message| over 127, the
message being the gradients plus the residual, or the intra shard's sum
of two ranks' gradients plus the residual; the parameters take lr times
one code a step so far), and the same value, up to 2 ulp, for at least
99% of the elements (a residual, the message less its round trip, up to
2 ulp of the largest message; a parameter, its start plus the updates so
far, up to 2 ulp of its own size plus the largest updates'); the resumed run bit for bit. The comparison must
reject planted faults (``torch_comm_workers.EF_FAULTS``): a residual
dropped from the next message, or fed back negated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import chainermn_tpu.optimizers as JO
from chainermn_tpu import create_communicator as jax_comm
from chainermn_tpu import create_multi_node_optimizer as jax_mno
from chainermn_tpu.communicators.xla_communicator import (
    HierarchicalCommunicator as JaxHier,
    TwoDimensionalCommunicator as JaxTwoD,
)
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.optimizers import (
    create_multi_node_optimizer,
    inner_transform,
)
from chainermn_tpu_torch.testing import run_distributed
from torch_comm_workers import (
    EF_FAULTS,
    LEAVES,
    SMALL_BUCKET,
    ef_worker,
    run_once,
)
from torch_rank_workers import few_threads  # noqa: F401

N = 4
LR = 0.1
AX2 = ("inter", "intra")
EQUAL_SHARE = 0.99


def _inputs(tmp):
    rs = np.random.RandomState(11)
    out = {"tmp": np.array(str(tmp))}
    for k, shape in LEAVES:
        out[f"p/{k}"] = rs.randn(*shape).astype(np.float32)
        out[f"gs/{k}"] = rs.randn(3, N, *shape).astype(np.float32)
    out["gs/a"][:, 1] *= 0.01
    out["lin/w"] = rs.randn(3, 5).astype(np.float32)
    out["lin/x"] = rs.randn(4, N, 2, 5).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = _inputs(tmp_path_factory.mktemp("ef"))
    outs = run_once("ef_worker", lambda: run_distributed(
        ef_worker, N, inputs, timeout=300), tmp_path_factory)
    return inputs, outs


def _jax_comm(cname):
    devs = np.array(jax.devices("cpu")[:N])
    if cname == "flat":
        return jax_comm("naive", devices=list(devs)), ("data",)
    mesh = Mesh(devs.reshape(2, 2), AX2)
    return (JaxHier(mesh=mesh) if cname == "hier" else JaxTwoD(mesh=mesh),
            AX2)


def _jax_ef(inputs, cname):
    comm, axes = _jax_comm(cname)
    opt = jax_mno(optax.sgd(LR), comm, allreduce_grad_dtype=jnp.int8,
                  error_feedback=True)
    params = {k: jnp.asarray(inputs[f"p/{k}"]) for k, _ in LEAVES}
    state = opt.init(params)
    state = state._replace(residual=jax.tree.map(
        lambda r: jnp.broadcast_to(r, (N,) + r.shape), state.residual))
    sspec = JO._ErrorFeedbackState(inner=P(), residual=P(axes))

    @jax.jit
    def step(params, state, grads):
        def body(params, state, grads):
            st = state._replace(residual=jax.tree.map(lambda r: r[0],
                                                      state.residual))
            upd, st = opt.update({k: v[0] for k, v in grads.items()}, st,
                                 params)
            st = st._replace(residual=jax.tree.map(lambda r: r[None],
                                                   st.residual))
            return optax.apply_updates(params, upd), st

        return shard_map(body, mesh=comm.mesh,
                         in_specs=(P(), sspec, P(axes)),
                         out_specs=(P(), sspec), check_vma=False)(
            params, state, grads)

    steps, residuals = [], []
    for s in range(3):
        grads = {k: jnp.asarray(inputs[f"gs/{k}"][s]) for k, _ in LEAVES}
        params, state = step(params, state, grads)
        steps.append({k: np.asarray(v) for k, v in params.items()})
        residuals.append([np.asarray(r)
                          for r in jax.tree.leaves(state.residual)])
    return steps, residuals


@pytest.fixture(scope="module")
def jax_ef(runs):
    """``(cname, bb) -> (params a step, residuals a step)`` of the JAX
    wrapper, each computed once."""
    inputs, _ = runs
    memo = {}

    def get(cname, bb):
        if (cname, bb) not in memo:
            with pytest.MonkeyPatch.context() as mp:
                if bb is not None:
                    mp.setattr(JO, "_EF_BUCKET_BYTES", bb)
                memo[cname, bb] = _jax_ef(inputs, cname)
        return memo[cname, bb]

    return get


def _assert_codes(got, want, code, magnitude=None):
    """Within ``code`` everywhere, and the same value up to 2 ulp (of
    ``want``, or of ``magnitude`` where ``want`` is a difference of values
    of that size) for at least EQUAL_SHARE of the elements."""
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got - want)
    assert (diff <= code).all(), (diff.max(), code)
    if want.size:
        ref = np.abs(want if magnitude is None else magnitude)
        same = diff <= 2 * np.spacing(np.float32(ref))
        assert np.mean(same) >= EQUAL_SHARE, np.mean(same)


def _assert_follows(inputs, outs, tag, cname, ref):
    """Every rank's parameters and residuals after each of the 3 steps
    of the run ``tag`` against JAX's ``ref``."""
    steps, residuals = ref
    g = max(np.abs(inputs[f"gs/{k}"]).max() for k, _ in LEAVES
            if inputs[f"gs/{k}"].size)
    # one code of a message: its largest |element| over 127, the residual
    # adding at most half a code of the stage-1 scale
    msg = (2 if cname == "shard" else 1) * g + 2 * g / 127
    code = msg / 127
    for r, o in enumerate(outs):
        assert int(o[f"{tag}/n_res"]) == len(residuals[0])
        for s in range(3):
            # a parameter sums the updates so far into its start: its ulp
            # is that of the largest of those
            for k, _ in LEAVES:
                want = steps[s][k]
                _assert_codes(o[f"{tag}/step{s}/{k}"], want,
                              (s + 1) * LR * code + 1e-7,
                              np.abs(want) + (s + 1) * LR * msg)
            for i, want in enumerate(residuals[s]):
                _assert_codes(o[f"{tag}/step{s}/res{i}"], want[r],
                              code + 1e-7, msg)


@pytest.mark.parametrize("bb", [None, SMALL_BUCKET], ids=["one", "small"])
@pytest.mark.parametrize("cname", ["flat", "hier", "shard"])
def test_error_feedback_follows_jax_over_three_steps(runs, jax_ef, cname,
                                                     bb):
    inputs, outs = runs
    _assert_follows(inputs, outs, f"ef/{cname}/{bb}", cname,
                    jax_ef(cname, bb))
    if cname == "shard":
        # one shard-shaped buffer a bucket: 1/n_intra of the flat form
        n_buckets = int(outs[0][f"ef/shard/{bb}/n_res"])
        assert n_buckets == (1 if bb is None else 3)
        total = sum(outs[0][f"ef/shard/{bb}/step2/res{i}"].size
                    for i in range(n_buckets))
        flat = sum(int(np.prod(s)) for _, s in LEAVES)
        assert total <= flat // 2 + n_buckets
    # the residual is per rank
    assert not np.array_equal(outs[0][f"ef/{cname}/{bb}/step2/res0"],
                              outs[1][f"ef/{cname}/{bb}/step2/res0"])


@pytest.mark.parametrize("fault", sorted(EF_FAULTS))
@pytest.mark.parametrize("cname", ["flat", "shard"])
def test_error_feedback_comparison_rejects_a_planted_fault(runs, jax_ef,
                                                           cname, fault):
    """The comparison above holds the feedback itself: a run whose
    residual is dropped from the next message (``nofb``) or fed back
    negated (``negfb``) fails it."""
    inputs, outs = runs
    with pytest.raises(AssertionError):
        _assert_follows(inputs, outs, f"ef/{cname}/None/{fault}", cname,
                        jax_ef(cname, None))


def test_a_resumed_run_gives_each_rank_its_own_residual(runs):
    _, outs = runs
    for o in outs:
        assert int(o["resume/iteration"]) == 2
        assert bool(o["resume/res_equal"])
        assert bool(o["resume/params_equal"])
    assert not np.array_equal(outs[0]["resume/res0"], outs[1]["resume/res0"])


def test_error_feedback_needs_the_int8_wire_and_stays_off_the_plan():
    comm = create_communicator("naive")
    p = [torch.zeros(3, requires_grad=True)]
    with pytest.raises(ValueError, match="int8"):
        create_multi_node_optimizer(torch.optim.SGD(p, lr=0.1), comm,
                                    allreduce_grad_dtype="bfloat16",
                                    error_feedback=True)
    opt = create_multi_node_optimizer(torch.optim.SGD(p, lr=0.1), comm,
                                      allreduce_grad_dtype="int8",
                                      error_feedback=True)
    assert [tuple(r.shape) for r in opt.state_dict()["residual"]] == [(3,)]
    with pytest.raises(ValueError, match="error_feedback"):
        inner_transform(opt)
    # at one rank the int8 wire is exact and the residual stays zero
    p[0].grad = torch.tensor([0.3, -1.7, 2.9])
    opt.step()
    assert torch.equal(p[0].detach(), -0.1 * torch.tensor([0.3, -1.7, 2.9]))
    assert torch.equal(opt.state_dict()["residual"][0], torch.zeros(3))
