"""The port's tensor-parallel serving (``ServingEngine(mesh=)``) against
the JAX package's, case for case with tests/test_serving.py's
``TestTensorParallel`` and its divisibility check.

At 2 and 4 gloo ranks (``tests/torch_tp_workers.py::tp_serving_worker``,
one launch per world size), each rank serves the same 5 requests through
3 slots (joins and leaves staggered), over the same fp32 weights:

- paged and dense, K4's plain version (``'fused'``) and ``'xla'``,
  greedy and sampled (temperature 0.8, top-k 8, base seed 42): every
  rank's streams are the same; they equal the JAX TP engine's on an
  n-device ``'model'`` mesh, the port's engine without a mesh and the
  port's ``generate`` with the scheduler's seeds (which JAX's
  ``generate`` gives too: tests/test_torch_serving.py);
- every decode tick makes ``2 x num_layers`` all-reduces and no other
  ``torch.distributed`` call (the JAX test counts the collectives in the
  compiled decode step's HLO), and each rank's cache holds its
  ``Hkv / n`` heads;
- heads, kv heads or ``d_ff`` that the group size does not divide raise
  JAX's ``ValueError``; a scheduler run bounded by the clock is refused
  under tensor parallelism (the ranks must take the same decisions).

No tolerance: streams are compared token for token.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.models import generate as port_generate
from chainermn_tpu_torch.serving import ServingEngine
from torch_comm_workers import run_once, shared_launch
from torch_lm_params import lm_variables
from torch_rank_workers import few_threads  # noqa: F401
from torch_tp_workers import (
    CALLS,
    ENGINE,
    LM_CFG,
    SAMPLED,
    serve,
    tp_serving_worker,
)

SIZES = (2, 4)
LAYOUTS = ("paged", "dense")
IMPLS = ("fused", "xla")
MODES = {"greedy": {}, "sampled": SAMPLED}


def _requests(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p_len = int(rs.randint(1, 7))
        out.append((rs.randint(1, LM_CFG["vocab_size"], size=p_len)
                    .tolist(), int(rs.randint(1, 6))))
    return out


def _jax_serve(engine, reqs):
    sched = JaxScheduler(engine, policy="prefill_priority")
    ids = [sched.submit(JaxRequest(prompt=p, max_new_tokens=g))
           for p, g in reqs]
    results = sched.run()
    return [results[rid]["tokens"] for rid in ids], ids


def _split(out, key):
    toks, lens = out[f"{key}/tokens"], out[f"{key}/lens"]
    bounds = np.cumsum(lens)[:-1]
    return [s.tolist() for s in np.split(toks, bounds)]


@pytest.fixture(scope="module")
def setup():
    jm = JaxLM(**LM_CFG, compute_dtype=jnp.float32)
    variables = jax.tree.map(jnp.asarray, lm_variables(jm, seed=1))
    state = lm_state_from_flax(jax.tree.map(np.asarray, variables))
    tm = TransformerLM(**LM_CFG, compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(state)
    reqs = _requests(5, seed=11)
    inputs = {f"state/{k}": v.numpy() for k, v in state.items()}
    inputs["reqs/new"] = np.array([g for _, g in reqs])
    for i, (p, _) in enumerate(reqs):
        inputs[f"reqs/prompt{i}"] = np.array(p)
    return jm, variables, tm, reqs, inputs


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    *_, inputs = setup
    return {n: shared_launch(f"tp_serving_worker{n}", tmp_path_factory,
                             tp_serving_worker, n, inputs, timeout=240)
            for n in SIZES}


@pytest.fixture(scope="module")
def references(setup, tmp_path_factory):
    """The JAX TP engine's streams per (n, layout, mode), the port's
    mesh-less engine's per (layout, mode) (its ``'xla'`` impl gives the
    same: tests/test_torch_serving.py), and the port's ``generate``'s per
    mode; once per test run (``run_once``)."""
    return run_once("tp_serving_references", lambda: _references(setup),
                    tmp_path_factory)


def _references(setup):
    jm, variables, tm, reqs, _ = setup
    jax_tp, port_single, gen = {}, {}, {}
    for mode, sampling in MODES.items():
        for layout in LAYOUTS:
            for n in SIZES:
                mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("model",))
                engine = JaxEngine(
                    jm, variables, decode_impl=layout,
                    decode_attend_impl="xla", spec_tokens=0,
                    prefix_cache="off", prefill_chunk=0,
                    prefill_seq_parallel="off", mesh=mesh, **ENGINE,
                    **sampling)
                jax_tp[n, layout, mode], ids = _jax_serve(engine, reqs)
            port_single[layout, mode], ids = serve(ServingEngine(
                tm, device="cpu", decode_impl=layout, **ENGINE, **sampling),
                reqs)
        refs = []
        for (prompt, n_new), rid in zip(reqs, ids):
            kw = {k: v for k, v in sampling.items() if k != "base_seed"}
            if sampling:
                seed = zlib.crc32(rid.encode()) & 0x7FFFFFFF
                kw.update(rng=np.asarray(
                    jax.random.PRNGKey(sampling["base_seed"])), seeds=[seed])
            refs.append(port_generate(
                tm, torch.tensor([prompt]), len(prompt) + n_new, **kw)[0]
                .tolist())
        gen[mode] = refs
    return jax_tp, port_single, gen


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n", SIZES)
def test_tp_streams_match_jax_single_and_generate(runs, references, n,
                                                  layout, impl, mode):
    jax_tp, port_single, gen = references
    got = _split(runs[n][0], f"{layout}/{impl}/{mode}")
    assert got == jax_tp[n, layout, mode]
    assert got == port_single[layout, mode]
    assert got == gen[mode]


@pytest.mark.parametrize("n", SIZES)
def test_every_rank_serves_the_same_streams(runs, n):
    outs = runs[n]
    for key in outs[0]:
        if key.endswith(("/tokens", "/lens")):
            for o in outs[1:]:
                np.testing.assert_array_equal(o[key], outs[0][key], key)


@pytest.mark.parametrize("n", SIZES)
def test_decode_tick_makes_two_all_reduces_per_layer_and_nothing_else(
        runs, n):
    want = dict.fromkeys(CALLS, 0)
    want["all_reduce"] = 2 * LM_CFG["num_layers"]
    for o in runs[n]:
        assert len(o["tick_calls"]) > 0
        for tick in o["tick_calls"]:
            assert dict(zip(CALLS, tick.tolist())) == want


@pytest.mark.parametrize("n", SIZES)
def test_each_rank_holds_its_heads_and_its_cache(runs, n):
    for o in runs[n]:
        assert o["local_heads"].tolist() == [LM_CFG["num_heads"] // n,
                                             LM_CFG["num_heads"] // n,
                                             LM_CFG["d_ff"] // n]
        hd = LM_CFG["d_model"] // LM_CFG["num_heads"]
        assert o["cache_shape"].tolist()[1:] == [
            ENGINE["kv_block_size"], LM_CFG["num_heads"] // n, hd]


@pytest.mark.parametrize("n", SIZES)
def test_divisibility_errors_are_jax_s(setup, runs, n):
    bad = (dict(num_heads=3, d_model=18) if n == 2
           else dict(num_kv_heads=2))
    jm = JaxLM(**{**LM_CFG, **bad}, compute_dtype=jnp.float32)
    variables = jax.tree.map(jnp.asarray, lm_variables(jm, seed=0))
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("model",))
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, variables, num_slots=1, mesh=mesh,
                  decode_attend_impl="xla", spec_tokens=0,
                  prefix_cache="off", prefill_chunk=0,
                  prefill_seq_parallel="off")
    assert "divide" in str(want.value)
    for o in runs[n]:
        assert str(o["refused/divide"]) == str(want.value)


@pytest.mark.parametrize("n", SIZES)
def test_a_clock_bounded_run_is_refused_under_tp(runs, n):
    for o in runs[n]:
        assert "max_seconds" in str(o["refused/max_seconds"])
