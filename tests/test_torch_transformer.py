"""The port's Transformer LM against the JAX package's, same weights.

flax parameters are initialised in JAX, carried across with
``convert.lm_state_from_flax`` (numpy in between) and both models run
at fp32 compute on the same numpy tokens:

- logits of the non-decode causal forward;
- logits of a bucketed prefill per slot plus 3 decode ticks through the
  paged slot path, with both attend impls (``'fused'`` runs the JAX
  Pallas kernel in interpret mode and the port's plain K4 version), and
  the K/V pools they leave behind;
- the same through the dense slot layout (``kv_layout='dense'``, the
  prefill through ``decode_slots``), and a span overhanging the dense
  ring, whose writes past it are dropped as JAX drops them.

Tolerance ``atol = rtol = 1e-4``: fp32 throughout, with reductions in
different orders (XLA vs PyTorch CPU kernels) over a few layers.
Variants: learned / rotary positions, MHA / GQA (4 heads over 2 kv
heads), and a sliding window (the training forward takes it through an
``attention_fn`` on both sides, the xla attention with the band bias).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.ops.attention import attention
from chainermn_tpu.ops.paged_decode import fused_supported
from chainermn_tpu.serving.kv_blocks import init_serving_cache as jax_cache
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops.attention import attention as port_attention
from chainermn_tpu_torch.serving.kv_blocks import init_serving_cache
from torch_rank_workers import few_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)
BS, NB = 4, 20

VARIANTS = {
    "learned-mha": dict(pos_encoding="learned"),
    "rope-mha": dict(pos_encoding="rope"),
    "learned-gqa": dict(pos_encoding="learned", num_kv_heads=2),
    "rope-gqa-window": dict(pos_encoding="rope", num_kv_heads=2, window=6),
}


def _pair(variant, seed=0):
    kw = VARIANTS[variant]
    window = kw.get("window")
    attn = (functools.partial(attention, window=window, impl="xla")
            if window else None)
    jm = JaxLM(**CFG, compute_dtype=jnp.float32, attention_fn=attn, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
                     train=False)
    tattn = (functools.partial(port_attention, window=window, impl="xla")
             if window else None)
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                       attention_fn=tattn, **kw)
    tm.load_state_dict(lm_state_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def test_converted_state_covers_every_parameter():
    jm, params, tm = _pair("learned-gqa")
    state = lm_state_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(tm.state_dict())
    qkv = params["params"]["block_0"]["qkv"]["kernel"]
    assert state["blocks.0.qkv.weight"].shape == (qkv.shape[1], qkv.shape[0])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match(variant):
    jm, params, tm = _pair(variant)
    tokens = np.random.RandomState(1).randint(0, CFG["vocab_size"],
                                              size=(2, 11))
    want = np.asarray(jm.apply(params, jnp.asarray(tokens), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.skipif(not fused_supported(),
                    reason="this jax's Pallas lacks scalar-prefetch grid "
                    "specs (no JAX fused reference)")
@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_prefill_and_decode_logits_match(variant, impl):
    jm, params, tm = _pair(variant)
    M = CFG["max_len"] // BS
    jpaged = jm.clone(kv_layout="paged", kv_block_size=BS, kv_num_blocks=NB,
                      decode_attend_impl=impl)
    jcache = jax_cache(jpaged, {"params": params["params"]}, 2)
    tpaged = tm.clone(decode_attend_impl=impl)
    tcache = init_serving_cache(tm, num_blocks=NB, block_size=BS,
                                device="cpu")
    # two slots at different depths, blocks interleaved in the pool
    tables = np.zeros((2, M), np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[1, :3] = [2, 11, 5]
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, CFG["vocab_size"], size=n) for n in (6, 3)]

    def step(tokens, positions, table_rows):
        nonlocal jcache
        want, mut = jpaged.apply(
            {**params, "cache": jcache}, jnp.asarray(tokens, jnp.int32),
            train=False, decode=True,
            decode_positions=jnp.asarray(positions, jnp.int32),
            block_tables=jnp.asarray(table_rows), mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tpaged(torch.as_tensor(tokens), decode=True,
                         decode_positions=torch.as_tensor(positions,
                                                          dtype=torch.int32),
                         block_tables=torch.from_numpy(table_rows),
                         cache=tcache)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return want

    last = []
    for s, p in enumerate(prompts):
        padded = np.zeros((1, 8), np.int64)  # bucket 8, pad id 0
        padded[0, :len(p)] = p
        logits = step(padded, [0], tables[s:s + 1])
        last.append(int(np.argmax(logits[0, len(p) - 1])))
    positions = np.array([len(p) for p in prompts])
    toks = np.array(last)
    for _ in range(3):
        logits = step(toks[:, None], positions, tables)
        toks = np.argmax(logits[:, 0], axis=-1)
        positions = positions + 1
    for layer in range(CFG["num_layers"]):
        jl = jcache[f"block_{layer}"]
        for name in ("pool_key", "pool_value"):
            np.testing.assert_allclose(tcache[layer][name][1:].numpy(),
                                       np.asarray(jl[name])[1:], **TOL)


def test_clone_shares_weights_and_leaves_the_original_untouched():
    _, _, tm = _pair("learned-mha")
    c = tm.clone(decode_attend_impl="fused")
    assert tm.decode_attend_impl == "xla"
    assert all(b.decode_attend_impl == "xla" for b in tm.blocks)
    assert all(b.decode_attend_impl == "fused" for b in c.blocks)
    assert c.tok_emb.weight is tm.tok_emb.weight
    assert c.blocks[0].qkv.weight is tm.blocks[0].qkv.weight
    with pytest.raises(ValueError):
        tm.clone(window=3)


def test_window_without_an_attention_fn_raises_as_in_jax():
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                       window=6)
    with pytest.raises(ValueError, match="window-honouring attention_fn"):
        tm(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="segment-capable attention_fn"):
        tm(torch.zeros(1, 4, dtype=torch.long),
           segment_ids=torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.skipif(not fused_supported(),
                    reason="this jax's Pallas lacks scalar-prefetch grid "
                    "specs (no JAX fused reference)")
@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_slot_prefill_and_decode_logits_match(variant, impl):
    """The dense slot layout: a bucketed prefill of each slot through
    ``decode_slots`` (its one cache row), then 3 decode ticks over both
    slots at different depths; logits every call and the caches left
    behind match JAX's."""
    jm, params, tm = _pair(variant)
    jdense = jm.clone(kv_layout="dense", decode_attend_impl=impl)
    jcache = jax_cache(jdense, {"params": params["params"]}, 2)
    tdense = tm.clone(kv_layout="dense", decode_attend_impl=impl)
    tcache = init_serving_cache(tdense, num_slots=2, device="cpu")
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, CFG["vocab_size"], size=n) for n in (5, 2)]

    def step(tokens, positions, slots):
        nonlocal jcache
        jslots = None if slots is None else jnp.asarray(slots, jnp.int32)
        want, mut = jdense.apply(
            {**params, "cache": jcache}, jnp.asarray(tokens, jnp.int32),
            train=False, decode=True,
            decode_positions=jnp.asarray(positions, jnp.int32),
            decode_slots=jslots, mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tdense(torch.as_tensor(tokens), decode=True,
                         decode_positions=torch.as_tensor(
                             positions, dtype=torch.int32),
                         decode_slots=None if slots is None else
                         torch.as_tensor(slots, dtype=torch.int32),
                         cache=tcache)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        return want

    last = []
    for s, p in enumerate(prompts):
        padded = np.zeros((1, 8), np.int64)  # bucket 8, pad id 0
        padded[0, :len(p)] = p
        logits = step(padded, [0], [s])
        last.append(int(np.argmax(logits[0, len(p) - 1])))
    positions = np.array([len(p) for p in prompts])
    toks = np.array(last)
    for _ in range(3):
        logits = step(toks[:, None], positions, None)
        toks = np.argmax(logits[:, 0], axis=-1)
        positions = positions + 1
    for layer in range(CFG["num_layers"]):
        jl = jcache[f"block_{layer}"]
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(tcache[layer][name].numpy(),
                                       np.asarray(jl[name]), **TOL)


def test_dense_writes_past_the_ring_are_dropped_as_in_jax():
    """A span overhanging the dense ring (positions + T > L) writes only
    its columns below L, as JAX's ``.at[].set`` drops the rest; the
    logits of the kept rows and the cache match JAX's."""
    jm, params, tm = _pair("rope-gqa-window")
    L = 12
    jdense = jm.clone(kv_layout="dense", decode_cache_len=L)
    jcache = jax_cache(jdense, {"params": params["params"]}, 2)
    tdense = tm.clone(kv_layout="dense", decode_cache_len=L)
    tcache = init_serving_cache(tdense, num_slots=2, device="cpu")
    toks = np.random.RandomState(6).randint(1, 64, size=(2, 5))
    positions = np.array([3, 9], np.int32)  # row 1 overhangs by 2
    want, mut = jdense.apply(
        {**params, "cache": jcache}, jnp.asarray(toks, jnp.int32),
        train=False, decode=True, decode_positions=jnp.asarray(positions),
        mutable=["cache"])
    with torch.no_grad():
        got = tdense(torch.from_numpy(toks), decode=True,
                     decode_positions=torch.from_numpy(positions),
                     cache=tcache)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], **TOL)
    np.testing.assert_allclose(got[1, :3].numpy(), np.asarray(want)[1, :3],
                               **TOL)
    for layer in range(CFG["num_layers"]):
        jl = mut["cache"][f"block_{layer}"]
        np.testing.assert_allclose(tcache[layer]["cached_key"].numpy(),
                                   np.asarray(jl["cached_key"]), **TOL)
