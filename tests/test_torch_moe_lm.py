"""The port's MoE Transformer LM (``TransformerLM(n_experts=)``) and MoE
serving, also under tensor parallelism, against the JAX package's, case
for case with the MoE class of tests/test_serving.py.

In this process, over the same numpy-seeded fp32 weights carried across
with ``convert.lm_state_from_flax`` (``n_experts`` 4, the TP tests'
tiny widths): the forward's logits and every parameter's gradient of
``lm_loss`` against JAX's (the dense MoE form: every expert evaluated,
a one-hot times the gate); ``generate`` greedy and sampled against JAX's
``generate``; the mesh-less ``ServingEngine`` (paged and dense, K4's
plain version and ``'xla'``, greedy and sampled) against ``generate``;
the weight converter's expert slices; the shard and unshard round trip
and JAX's sharded layout; ``clone``'s MoE fields.

At 2 gloo ranks (``tests/torch_moe_workers.py::moe_lm_worker``, one
launch): ``ServingEngine(mesh=)`` with the experts on the TP ranks (the
ownership-split form) against the JAX TP engine on a 2-device ``'model'``
mesh and the mesh-less engine; every decode tick makes ``2 x num_layers``
all-reduces and ``2 x num_layers`` all-to-alls and nothing else (the JAX
test's HLO count); ``expert_signature``; the divisibility refusal and
the refusal of ``'auto'`` dispatch where a dispatch runs.

Tolerances: logits rtol 1e-4 (atol 1e-5), gradients rtol 1e-4 (atol
1e-6); streams token for token.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu.parallel.moe import make_expert_params as jax_mep
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu.serving.engine import shard_lm_params as jax_shard
from chainermn_tpu_torch.convert import (
    MOE_LEAVES,
    expert_params_from_stack,
    lm_state_from_flax,
)
from chainermn_tpu_torch.models import TransformerLM, generate, lm_loss
from chainermn_tpu_torch.serving import ServingEngine
from chainermn_tpu_torch.serving.engine import (
    shard_lm_params,
    unshard_lm_params,
)
from torch_comm_workers import shared_launch
from torch_lm_params import lm_variables
from torch_moe_workers import CALLS, moe_lm_worker
from torch_rank_workers import few_threads  # noqa: F401
from torch_tp_workers import ENGINE, LM_CFG, SAMPLED, serve

E = 4
TP = 2
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LAYOUTS = ("paged", "dense")
IMPLS = ("fused", "xla")
MODES = {"greedy": {}, "sampled": SAMPLED}


def _requests(n, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(1, LM_CFG["vocab_size"], size=int(rs.randint(1, 7)))
             .tolist(), int(rs.randint(1, 6))) for _ in range(n)]


@pytest.fixture(scope="module")
def setup():
    jm = JaxLM(**LM_CFG, n_experts=E, compute_dtype=jnp.float32)
    variables = jax.tree.map(jnp.asarray, lm_variables(jm, seed=3))
    state = lm_state_from_flax(jax.tree.map(np.asarray, variables))
    tm = TransformerLM(**LM_CFG, n_experts=E, compute_dtype=torch.float32,
                       device="cpu")
    tm.load_state_dict(state)
    reqs = _requests(5, seed=25)
    inputs = {f"state/{k}": v.numpy() for k, v in state.items()}
    inputs["n_experts"] = np.array(E)
    inputs["reqs/new"] = np.array([g for _, g in reqs])
    for i, (p, _) in enumerate(reqs):
        inputs[f"reqs/prompt{i}"] = np.array(p)
    return jm, variables, tm, state, reqs, inputs


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    *_, inputs = setup
    return shared_launch("moe_lm_worker", tmp_path_factory, moe_lm_worker,
                         TP, inputs, timeout=240)


def _split(out, key):
    toks, lens = out[f"{key}/tokens"], out[f"{key}/lens"]
    return [s.tolist() for s in np.split(toks, np.cumsum(lens)[:-1])]


def _gen_refs(tm, reqs, ids, sampling):
    """The port's ``generate`` stream of each request (the scheduler's
    seed for each under sampling)."""
    refs = []
    for (prompt, n_new), rid in zip(reqs, ids):
        kw = {k: v for k, v in sampling.items() if k != "base_seed"}
        if sampling:
            kw.update(rng=np.asarray(jax.random.PRNGKey(
                sampling["base_seed"])),
                seeds=[zlib.crc32(rid.encode()) & 0x7FFFFFFF])
        refs.append(generate(tm, torch.tensor([prompt]), len(prompt) + n_new,
                             **kw)[0].tolist())
    return refs


# ---------------------------------------------------------------------------
# the MoE LM in this process
# ---------------------------------------------------------------------------

def test_moe_leaves_and_init():
    tm = TransformerLM(**LM_CFG, n_experts=E, compute_dtype=torch.float32,
                       device="cpu", seed=1)
    blk = tm.blocks[0]
    assert not hasattr(blk, "ff_up") and not hasattr(blk, "ff_down")
    d, f = LM_CFG["d_model"], LM_CFG["d_ff"]
    assert blk.moe_router.shape == (d, E)
    assert blk.moe_w_up.shape == (E, d, f)
    assert blk.moe_b_up.shape == (E, f)
    assert blk.moe_w_down.shape == (E, f, d)
    assert blk.moe_b_down.shape == (E, d)
    assert all(getattr(blk, n).dtype == torch.float32 for n in MOE_LEAVES)
    # flax's initialisers' scales: router normal(0.02), the kernels the
    # fan-in truncated normal (|w| < 2 std), the biases zero
    with torch.no_grad():
        assert abs(float(blk.moe_router.std()) - 0.02) < 0.006
        std = d ** -0.5 / .87962566103423978
        assert float(blk.moe_w_up.abs().max()) < 2 * std
        assert abs(float(blk.moe_w_up.std()) - d ** -0.5) < 0.1 * d ** -0.5
        assert float(blk.moe_b_up.abs().max()) == 0.0
    jm = JaxLM(**LM_CFG, n_experts=E, compute_dtype=jnp.float32)
    jp = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        train=False))["params"]["block_0"]
    for name in MOE_LEAVES:
        assert tuple(jp[name].shape) == tuple(getattr(blk, name).shape)


def test_forward_matches_jax(setup):
    jm, variables, tm, *_ = setup
    tokens = np.random.RandomState(4).randint(
        0, LM_CFG["vocab_size"], size=(2, 12)).astype(np.int32)
    want = jax.jit(lambda v, t: jm.apply(v, t, train=False))(
        variables, jnp.asarray(tokens))
    got = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)


def test_backward_matches_jax(setup):
    """Every parameter's gradient of ``lm_loss``: JAX's through the same
    converter as the weights (kernels transposed, MoE leaves as they
    are)."""
    jm, variables, tm, *_ = setup
    tokens = np.random.RandomState(5).randint(
        0, LM_CFG["vocab_size"], size=(2, 12)).astype(np.int32)

    def jloss(v):
        return jax_lm_loss(jm.apply(v, jnp.asarray(tokens), train=False),
                           jnp.asarray(tokens))

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(variables)
    want = lm_state_from_flax(jax.tree.map(np.asarray, jgrads))
    tm.zero_grad()
    loss = lm_loss(tm(torch.from_numpy(tokens)), torch.from_numpy(tokens))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jval), rtol=1e-5)
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)
    assert float(got["blocks.0.moe_router"].grad.abs().sum()) > 0
    tm.zero_grad()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_matches_jax(setup, mode):
    jm, variables, tm, *_ = setup
    prompt = np.random.RandomState(6).randint(
        1, LM_CFG["vocab_size"], size=(3, 5)).astype(np.int32)
    prompt[1, 3:] = 0
    kw = {}
    if mode == "sampled":
        kw = dict(temperature=0.8, top_k=8, seeds=[3, 7, 11])
    jrng = jax.random.PRNGKey(9) if kw else None
    want = jax_generate(jm, variables, jnp.asarray(prompt), 14, rng=jrng,
                        **kw)
    got = generate(tm, torch.from_numpy(prompt), 14,
                   rng=None if jrng is None else np.asarray(jrng), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_engine_streams_match_generate(setup, layout, impl, mode):
    """The mesh-less engine over the dense MoE form: routing never
    couples co-resident rows, so every stream is ``generate``'s. The
    model's dispatch impl stays 'auto': the dense form never resolves
    it."""
    *_, tm, _, reqs, _ = setup
    assert tm.moe_dispatch_impl == "auto"
    engine = ServingEngine(tm, device="cpu", decode_impl=layout,
                           decode_attend_impl=impl, **ENGINE, **MODES[mode])
    streams, ids = serve(engine, reqs)
    assert streams == _gen_refs(tm, reqs, ids, MODES[mode])
    assert engine.expert_signature() == (E, E)


def test_dense_engine_has_no_expert_signature():
    tm = TransformerLM(**LM_CFG, compute_dtype=torch.float32, device="cpu")
    assert ServingEngine(tm, device="cpu", num_slots=1).expert_signature() \
        is None


def test_shard_unshard_round_trip_and_jax_layout(setup):
    jm, variables, tm, state, *_ = setup
    stacked = shard_lm_params(tm, state, TP)
    assert stacked["blocks.0.moe_w_up"].shape[:2] == (TP, E // TP)
    assert stacked["blocks.0.moe_router"].shape[0] == TP  # replicated
    jstacked = jax_shard(jm, {"params": variables["params"]}, TP)["params"]
    for i in range(LM_CFG["num_layers"]):
        for name in MOE_LEAVES:
            np.testing.assert_array_equal(
                stacked[f"blocks.{i}.{name}"].numpy(),
                np.asarray(jstacked[f"block_{i}"][name]))
    full = unshard_lm_params(tm, stacked)
    assert set(full) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(full[k].numpy(), v.numpy(), err_msg=k)
    odd = TransformerLM(**{**LM_CFG, "n_experts": 3},
                        compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        shard_lm_params(odd, odd.state_dict(), TP)


def test_expert_stack_converter_slices_like_the_expert_axis():
    def init(key):
        k1, k2 = jax.random.split(key)
        return {"w1": jax.random.normal(k1, (4, 8)),
                "w2": jax.random.normal(k2, (8, 4))}

    stack = jax.tree.map(np.asarray, jax_mep(init, jax.random.PRNGKey(1), 8))
    whole = expert_params_from_stack(stack)
    for name in ("w1", "w2"):
        np.testing.assert_array_equal(whole[name].numpy(), stack[name])
        for r in range(4):
            mine = expert_params_from_stack(stack, r, 4)[name]
            np.testing.assert_array_equal(mine.numpy(),
                                          stack[name][2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="divide"):
        expert_params_from_stack(stack, 0, 3)


def test_clone_takes_the_moe_fields(setup):
    *_, tm, _, _, _ = setup
    same = tm.clone(moe_dispatch_impl="sort", expert_axis=None)
    assert same.blocks[0].moe_w_up is tm.blocks[0].moe_w_up
    assert same.blocks[0].moe_dispatch_impl == "sort"
    local = tm.clone(moe_experts_local=E // TP)
    assert local.blocks[0].moe_w_up.shape[0] == E // TP
    assert local.blocks[0].moe_router is tm.blocks[0].moe_router
    assert local.blocks[0].ln1 is tm.blocks[0].ln1
    assert tm.blocks[0].moe_w_up.shape[0] == E


# ---------------------------------------------------------------------------
# tensor-parallel MoE serving at 2 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tp_streams(setup):
    """The JAX TP engine's streams on a 2-device 'model' mesh (its
    dispatch 'auto' resolves to 'sort' through its default table)."""
    jm, variables, _, _, reqs, _ = setup
    mesh = Mesh(np.array(jax.devices("cpu")[:TP]), ("model",))
    out = {}
    for layout, mode in (("paged", "greedy"), ("dense", "greedy"),
                         ("paged", "sampled")):
        engine = JaxEngine(jm, variables, decode_impl=layout,
                           decode_attend_impl="xla", spec_tokens=0,
                           prefix_cache="off", prefill_chunk=0,
                           prefill_seq_parallel="off", mesh=mesh, **ENGINE,
                           **MODES[mode])
        sched = JaxScheduler(engine, policy="prefill_priority")
        ids = [sched.submit(JaxRequest(prompt=p, max_new_tokens=g))
               for p, g in reqs]
        res = sched.run()
        out[layout, mode] = [res[i]["tokens"] for i in ids]
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_streams_match_jax_and_the_meshless_engine(
        setup, runs, jax_tp_streams, layout, impl, mode):
    *_, tm, _, reqs, _ = setup
    got = [_split(o, f"{layout}/{impl}/{mode}") for o in runs]
    assert got[1] == got[0]
    single, ids = serve(ServingEngine(tm, device="cpu", decode_impl=layout,
                                      **ENGINE, **MODES[mode]), reqs)
    assert got[0] == single
    assert got[0] == _gen_refs(tm, reqs, ids, MODES[mode])
    want = jax_tp_streams.get((layout, mode))
    if want is None:  # the JAX engine ran paged for this mode
        want = jax_tp_streams["paged", mode]
    assert got[0] == want


def test_tp_decode_tick_makes_2l_all_reduces_and_2l_all_to_alls(runs):
    layers = LM_CFG["num_layers"]
    ar, a2a = CALLS.index("all_reduce"), CALLS.index("all_to_all_single")
    for o in runs:
        ticks = o["tick_calls"]
        assert len(ticks) > 0
        for t in ticks:
            assert t[ar] == 2 * layers and t[a2a] == 2 * layers, t
            assert t.sum() == 4 * layers, t  # nothing else
        # each rank: its heads, the full d_ff, its E / n experts
        np.testing.assert_array_equal(
            o["local"], [LM_CFG["num_heads"] // TP, LM_CFG["d_ff"], E // TP])
        np.testing.assert_array_equal(o["signature"], [E, E // TP])


def test_tp_refusals(runs):
    for o in runs:
        assert "must divide" in str(o["refused/divide"])
        assert "n_experts=3" in str(o["refused/divide"])
        assert "queue 8" in str(o["refused/auto"])
