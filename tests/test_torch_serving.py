"""The port's serving stack against the JAX package's.

- ``BlockAllocator``: the same ensure/trim/release sequence leaves the
  same tables, free list, refcounts and version in both packages.
- Engine + Scheduler on the CPU (the plain K4 version behind
  ``decode_attend_impl='fused'``): 6 requests through 2 slots — joins
  and leaves staggered mid-decode — give greedy streams token-identical
  to JAX ``generate`` and to the JAX engine's fused paged path, over
  weights carried across with ``convert.lm_state_from_flax``.
- The dense layout (``decode_impl='dense'``, ``'xla'`` and ``'fused'``)
  greedy and sampled (temperature 0.8, top-k 10, top-p 0.9): streams
  token-identical to JAX ``generate`` with the scheduler's seeds, to the
  port's ``generate``, and to the JAX engine's dense path; the
  scheduler derives JAX's seeds (``crc32(request_id) & 0x7FFFFFFF``).
- ``summary()``: the same rollup keys and values for the same events.
- Options the port does not serve yet raise ``NotImplementedError``; the
  sampling and layout options it does serve validate as JAX's do, and
  ``kv_signature`` is JAX's.
"""

import zlib


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import generate
from chainermn_tpu.observability.trace import (
    summarize_serving as jax_summarize,
)
from chainermn_tpu.ops.paged_decode import fused_supported
from chainermn_tpu.serving import BlockAllocator as JaxAllocator
from chainermn_tpu.serving import Request as JaxRequest
from chainermn_tpu.serving import Scheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.models import generate as port_generate
from chainermn_tpu_torch.observability.trace import summarize_serving
from chainermn_tpu_torch.serving import (
    BlockAllocator,
    Request,
    Scheduler,
    ServingEngine,
)
from torch_rank_workers import few_threads  # noqa: F401

VOCAB = 32
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, d_model=16,
           d_ff=32, max_len=32)
ENGINE = dict(num_slots=2, max_len=32, kv_block_size=8,
              prefill_buckets=(4, 8, 16))


@pytest.fixture(scope="module")
def lm_pair():
    jm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32),
                     train=False)
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(lm_state_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _requests(n, seed=0, max_prompt=7, max_new=6):
    rs = np.random.RandomState(seed)
    return [(rs.randint(1, VOCAB, size=int(rs.randint(1, max_prompt)))
             .tolist(), int(rs.randint(1, max_new))) for _ in range(n)]


def _serve(sched_cls, req_cls, engine, reqs, policy):
    sched = sched_cls(engine, policy=policy)
    ids = [sched.submit(req_cls(prompt=p, max_new_tokens=g))
           for p, g in reqs]
    results = sched.run()
    return [results[rid]["tokens"] for rid in ids], sched


def _alloc_trace(alloc, ops):
    for op, slot, n in ops:
        if op == "ensure":
            alloc.ensure(slot, n)
        elif op == "trim":
            alloc.trim(slot, n)
        else:
            alloc.release(slot)
    return (alloc.tables.copy(), list(alloc._free), alloc.refcounts.copy(),
            alloc.version, alloc.blocks_in_use, alloc.free_blocks)


def test_block_allocator_matches_jax():
    ops = [("ensure", 0, 9), ("ensure", 1, 3), ("ensure", 2, 17),
           ("ensure", 0, 20), ("release", 1, 0), ("ensure", 3, 12),
           ("trim", 2, 5), ("ensure", 1, 30), ("release", 0, 0),
           ("ensure", 0, 1), ("ensure", 2, 40), ("release", 3, 0)]
    got = _alloc_trace(BlockAllocator(24, 4, 4, 40), ops)
    want = _alloc_trace(JaxAllocator(24, 4, 4, 40), ops)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_block_allocator_refuses_like_jax_when_the_pool_runs_dry():
    for alloc in (BlockAllocator(5, 4, 2, 32), JaxAllocator(5, 4, 2, 32)):
        assert alloc.ensure(0, 12)
        v = alloc.version
        assert not alloc.ensure(1, 8)  # needs 2, one left: all-or-nothing
        assert alloc.version == v and alloc.free_blocks == 1


@pytest.mark.skipif(not fused_supported(),
                    reason="this jax's Pallas lacks scalar-prefetch grid "
                    "specs (no JAX fused engine to compare with)")
@pytest.mark.parametrize("policy", ["fcfs", "prefill_priority"])
def test_streams_match_generate_and_the_jax_fused_engine(lm_pair, policy):
    jm, params, tm = lm_pair
    reqs = _requests(6, seed=0)
    got, sched = _serve(Scheduler, Request,
                        ServingEngine(tm, device="cpu", **ENGINE), reqs,
                        policy)
    jax_engine = JaxEngine(
        jm, params, decode_impl="paged", decode_attend_impl="fused",
        spec_tokens=0, prefix_cache="off", prefill_chunk=0,
        prefill_seq_parallel="off", **ENGINE)
    want_engine, jsched = _serve(JaxScheduler, JaxRequest, jax_engine, reqs,
                                 policy)
    assert got == want_engine
    for (prompt, n_new), stream in zip(reqs, got):
        ref = np.asarray(generate(jm, params, jnp.asarray([prompt]),
                                  len(prompt) + n_new))[0].tolist()
        assert stream == ref
    # same events -> same rollup keys (the values are wall-clock times)
    assert set(sched.summary()) == set(jsched.summary())
    assert sched.summary()["generated_tokens"] == sum(n for _, n in reqs)


def test_xla_attend_engine_gives_the_same_streams(lm_pair):
    _, _, tm = lm_pair
    reqs = _requests(5, seed=3)
    fused, _ = _serve(Scheduler, Request,
                      ServingEngine(tm, device="cpu", **ENGINE), reqs,
                      "fcfs")
    xla, _ = _serve(Scheduler, Request,
                    ServingEngine(tm, device="cpu",
                                  decode_attend_impl="xla", **ENGINE),
                    reqs, "prefill_priority")
    assert fused == xla


def test_eos_finishes_early_and_frees_the_slot(lm_pair):
    _, _, tm = lm_pair
    engine = ServingEngine(tm, device="cpu", **ENGINE)
    prompt, _ = _requests(1, seed=5)[0]
    probe = Scheduler(engine)
    rid = probe.submit(Request(prompt=prompt, max_new_tokens=6))
    stream = probe.run()[rid]["generated"]
    sched = Scheduler(engine)
    rid = sched.submit(Request(prompt=prompt, max_new_tokens=6,
                               eos_id=stream[1]))
    out = sched.run()[rid]["generated"]
    assert out == stream[:stream.index(stream[1]) + 1]
    assert engine.free_slot_count == 2 and engine.blocks_in_use == 0


def test_summary_matches_jax_rollup_on_the_same_events():
    events = [
        {"kind": "serving", "phase": "queue_wait", "request": "a",
         "dur_s": 0.001},
        {"kind": "serving", "phase": "prefill", "request": "a", "slot": 0,
         "bucket": 16, "prompt_len": 9, "dur_s": 0.004, "ttft_s": 0.005},
        {"kind": "serving", "phase": "queue_wait", "request": "b",
         "dur_s": 0.002},
        {"kind": "serving", "phase": "prefill", "request": "b", "slot": 1,
         "bucket": 8, "prompt_len": 3, "dur_s": 0.003, "ttft_s": 0.006},
        {"kind": "serving", "phase": "decode_step", "n_active": 2,
         "n_slots": 4, "tokens": 2, "dur_s": 0.0021},
        {"kind": "serving", "phase": "decode_step", "n_active": 1,
         "n_slots": 4, "tokens": 1, "dur_s": 0.0019},
        {"kind": "serving", "phase": "finish", "request": "a",
         "generated": 3, "dur_s": 0.01, "tpot_ms": 2.0},
        {"kind": "serving", "phase": "finish", "request": "b",
         "generated": 2, "dur_s": 0.009},
        {"kind": "trace", "phase": "prefill", "dur_s": 1.0},  # not serving
    ]
    assert summarize_serving(events) == jax_summarize(events)
    assert summarize_serving([]) is None and jax_summarize([]) is None


@pytest.mark.parametrize("option", [
    dict(decode_impl="auto"),
    dict(decode_attend_impl="auto"),
    dict(kv_block_size="auto"),
    # mesh= is served (tests/test_torch_tp_serving.py); with it,
    # sequence-parallel prefill is not
    dict(mesh=object(), prefill_seq_parallel="on"),
    dict(spec_tokens=2),
    dict(prefix_cache="on"),
    dict(prefill_chunk=16),
    dict(prefill_seq_parallel="on"),
    dict(adapter_bank=object()),
])
def test_unported_engine_options_raise(lm_pair, option):
    _, _, tm = lm_pair
    kw = {**ENGINE, **option}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(tm, device="cpu", **kw)


def test_unported_scheduler_options_raise(lm_pair):
    _, _, tm = lm_pair
    engine = ServingEngine(tm, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(engine, policy="slo")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Scheduler(engine, tenant_weights={"a": 1.0})


def test_engine_refuses_a_model_on_another_device(lm_pair):
    _, _, tm = lm_pair
    with pytest.raises(ValueError, match="lives on"):
        ServingEngine(tm, device="meta", **ENGINE)


def test_request_past_the_horizon_is_refused_up_front(lm_pair):
    _, _, tm = lm_pair
    sched = Scheduler(ServingEngine(tm, device="cpu", **ENGINE))
    with pytest.raises(ValueError, match="horizon"):
        sched.submit(Request(prompt=[1] * 30, max_new_tokens=5))


SAMPLED = dict(temperature=0.8, top_k=10, top_p=0.9)


def _seeded_refs(jm, params, tm, reqs, ids, sampling):
    """JAX ``generate`` and the port's on each request alone, with the
    scheduler's seed for that request id."""
    refs, port_refs = [], []
    for (prompt, n_new), rid in zip(reqs, ids):
        kw = dict(sampling)
        seed = zlib.crc32(rid.encode()) & 0x7FFFFFFF
        if sampling:
            kw.update(rng=jax.random.PRNGKey(0), seeds=[seed])
        refs.append(np.asarray(generate(jm, params, jnp.asarray([prompt]),
                                        len(prompt) + n_new, **kw))[0]
                    .tolist())
        if sampling:
            kw["rng"] = np.asarray(kw["rng"])
        port_refs.append(port_generate(tm, torch.tensor([prompt]),
                                       len(prompt) + n_new, **kw)[0]
                         .tolist())
    return refs, port_refs


def _serve_ids(sched_cls, req_cls, engine, reqs, policy="prefill_priority"):
    sched = sched_cls(engine, policy=policy)
    ids = [sched.submit(req_cls(prompt=p, max_new_tokens=g))
           for p, g in reqs]
    results = sched.run()
    return [results[rid]["tokens"] for rid in ids], ids


@pytest.mark.skipif(not fused_supported(),
                    reason="this jax's Pallas lacks scalar-prefetch grid "
                    "specs (no JAX fused engine to compare with)")
@pytest.mark.parametrize("sampling", [{}, SAMPLED],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_dense_engine_streams_match_generate_and_the_jax_dense_engine(
        lm_pair, impl, sampling):
    jm, params, tm = lm_pair
    reqs = _requests(6, seed=11)
    got, ids = _serve_ids(Scheduler, Request, ServingEngine(
        tm, device="cpu", decode_impl="dense", decode_attend_impl=impl,
        **ENGINE, **sampling), reqs)
    jax_engine = JaxEngine(
        jm, params, decode_impl="dense", decode_attend_impl=impl,
        spec_tokens=0, prefix_cache="off", prefill_chunk=0,
        prefill_seq_parallel="off", **ENGINE, **sampling)
    want, jids = _serve_ids(JaxScheduler, JaxRequest, jax_engine, reqs)
    assert ids == jids
    assert got == want
    refs, port_refs = _seeded_refs(jm, params, tm, reqs, ids, sampling)
    assert got == refs == port_refs


def test_paged_engine_samples_the_dense_engines_streams(lm_pair):
    _, _, tm = lm_pair
    reqs = _requests(5, seed=12)
    paged, _ = _serve_ids(Scheduler, Request, ServingEngine(
        tm, device="cpu", **ENGINE, **SAMPLED), reqs, "fcfs")
    dense, _ = _serve_ids(Scheduler, Request, ServingEngine(
        tm, device="cpu", decode_impl="dense", **ENGINE, **SAMPLED), reqs)
    assert paged == dense


def test_scheduler_derives_and_stores_jax_seeds(lm_pair):
    jm, params, tm = lm_pair
    sched = Scheduler(ServingEngine(tm, device="cpu", **ENGINE))
    jsched = JaxScheduler(JaxEngine(
        jm, params, decode_impl="dense", decode_attend_impl="xla",
        spec_tokens=0, prefix_cache="off", prefill_chunk=0,
        prefill_seq_parallel="off", **ENGINE))
    for rid in (None, "req-7", "x" * 40):
        r = Request(prompt=[1, 2], max_new_tokens=2, request_id=rid)
        jr = JaxRequest(prompt=[1, 2], max_new_tokens=2, request_id=rid)
        sched.submit(r)
        jsched.submit(jr)
        assert r.request_id == jr.request_id and r.seed == jr.seed
    given = Request(prompt=[1], max_new_tokens=1, seed=5)
    sched.submit(given)
    assert given.seed == 5


def test_dense_engine_has_no_pool_and_forces_the_prefix_cache_off(lm_pair):
    jm, params, tm = lm_pair
    engine = ServingEngine(tm, device="cpu", decode_impl="dense",
                           prefix_cache="on", **ENGINE)
    assert not engine.prefix_cache_enabled
    assert (engine.kv_blocks_free(), engine.pool_utilization(),
            engine.blocks_in_use, engine.num_blocks) == (None,) * 4
    with pytest.raises(ValueError, match="prefix_cache must be one of"):
        ServingEngine(tm, device="cpu", decode_impl="dense",
                      prefix_cache="bogus", **ENGINE)
    for impl in ("dense", "paged"):
        port = ServingEngine(tm, device="cpu", decode_impl=impl, **ENGINE)
        jax_engine = JaxEngine(
            jm, params, decode_impl=impl, decode_attend_impl="xla",
            kv_block_size=8, spec_tokens=0, prefix_cache="off",
            prefill_chunk=0, prefill_seq_parallel="off",
            **{k: v for k, v in ENGINE.items() if k != "kv_block_size"})
        assert port.kv_signature() == jax_engine.kv_signature()
    paged = ServingEngine(tm, device="cpu", **ENGINE)
    assert paged.kv_blocks_free() == paged.num_blocks - 1


@pytest.mark.parametrize("option", [
    dict(temperature=0.5, rng=np.zeros(2, np.uint32), base_seed=3),
    dict(top_k=4),
    dict(top_p=0.5),
    dict(temperature=0.5, top_p=1.5),
    dict(temperature=0.5, top_k=0),
    dict(temperature=0.5, top_k=VOCAB + 1),
    dict(decode_impl="ring"),
], ids=["rng-and-base_seed", "top_k-greedy", "top_p-greedy", "top_p-high",
        "top_k-zero", "top_k-vocab", "unknown-layout"])
def test_sampling_and_layout_options_validate_as_jax(lm_pair, option):
    jm, params, tm = lm_pair
    with pytest.raises(ValueError) as got:
        ServingEngine(tm, device="cpu", **{**ENGINE, **option})
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, params, decode_attend_impl="xla", spec_tokens=0,
                  prefix_cache="off", prefill_chunk=0,
                  prefill_seq_parallel="off", **{**ENGINE, **option})
    assert str(got.value) == str(want.value)
