"""``generate`` and ``beam_search`` of the PyTorch port against the JAX
package's, over weights carried across with ``convert.lm_state_from_flax``
(fp32 compute, 2 layers, d_model 32, vocab 64).

- The legacy dense ring (``forward(decode=True)`` without
  ``decode_positions``, :func:`init_cache`): logits of every step equal
  JAX's at ``rtol = atol = 1e-4`` (fp32, reductions in another order).
- Greedy ``generate`` over ragged prompts (learned and rotary positions,
  MHA and GQA, a sliding window): token streams identical.
- ``beam_search`` (eos, GNMT length penalty, ragged prompts): tokens
  identical and raw scores within ``1e-4``; beam 1 is greedy.
- The validation errors are JAX's, message for message.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import beam_search as jax_beam
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.models.transformer import init_cache as jax_init_cache
from chainermn_tpu.ops.attention import attention
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import (
    TransformerLM,
    beam_search,
    generate,
    init_cache,
)
from chainermn_tpu_torch.ops.attention import attention as port_attention
from torch_rank_workers import few_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)
VARIANTS = {
    "learned-mha": dict(pos_encoding="learned"),
    "rope-gqa": dict(pos_encoding="rope", num_kv_heads=2),
    "learned-gqa-window": dict(pos_encoding="learned", num_kv_heads=2,
                               window=5),
}


@functools.lru_cache(maxsize=None)
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


def _prompts(seed, B=3, P=7):
    rs = np.random.RandomState(seed)
    prompt = rs.randint(1, CFG["vocab_size"], size=(B, P)).astype(np.int32)
    prompt[0, 4:] = 0  # ragged rows, right-padded with pad id 0
    if B > 2:
        prompt[2, 1:] = 0
    return prompt


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_ring_logits_match_jax(variant):
    jm, params, tm = _pair(variant)
    rs = np.random.RandomState(3)
    toks = rs.randint(0, CFG["vocab_size"], size=(2, 12)).astype(np.int32)
    jcache = jax_init_cache(jm, params, 2)["cache"]
    tcache = init_cache(tm, 2)
    for t in range(toks.shape[1]):
        want, mut = jm.apply({**params, "cache": jcache},
                             jnp.asarray(toks[:, t:t + 1]),
                             positions=jnp.full((1,), t, jnp.int32),
                             train=False, decode=True, mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tm(torch.from_numpy(toks[:, t:t + 1]),
                     positions=torch.full((1,), t), decode=True,
                     cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for layer, c in enumerate(tcache):
        jl = jcache[f"block_{layer}"]
        assert int(c["cache_index"]) == int(jl["cache_index"]) == 12
        for name in ("cached_key", "cached_value"):
            np.testing.assert_allclose(c[name].numpy(), np.asarray(jl[name]),
                                       **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_generate_matches_jax(variant):
    jm, params, tm = _pair(variant)
    prompt = _prompts(1)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 24))
    got = generate(tm, torch.from_numpy(prompt), 24)
    assert got.dtype == torch.int32 and got.shape == (3, 24)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eos_id,length_penalty",
                         [(None, 0.0), (9, 0.0), (None, 0.6), (9, -0.5)],
                         ids=["plain", "eos", "penalty", "eos-negative"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam_search_matches_jax(variant, eos_id, length_penalty):
    jm, params, tm = _pair(variant)
    prompt = _prompts(2)
    wt, ws = jax_beam(jm, params, jnp.asarray(prompt), 16, 3,
                      eos_id=eos_id, length_penalty=length_penalty)
    gt, gs = beam_search(tm, torch.from_numpy(prompt), 16, 3,
                         eos_id=eos_id, length_penalty=length_penalty)
    assert gt.shape == (3, 3, 16) and gs.shape == (3, 3)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)


def test_beam_one_is_greedy_and_the_top_beam_scores_no_lower():
    _, _, tm = _pair("rope-gqa")
    prompt = torch.from_numpy(_prompts(4))
    greedy = generate(tm, prompt, 20)
    one, one_scores = beam_search(tm, prompt, 20, 1)
    torch.testing.assert_close(one[:, 0], greedy, rtol=0, atol=0)
    beams, scores = beam_search(tm, prompt, 20, 4)
    assert bool((scores[:, 0] >= one_scores[:, 0] - 1e-5).all())
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())  # best first


def test_beam_search_eos_freezes_beams_with_pad():
    """A finished beam extends only with pad at no cost: with eos set to
    a token that a beam emits, the tokens after it are pad."""
    jm, params, tm = _pair("learned-mha")
    prompt = _prompts(5, B=2)
    free, _ = beam_search(tm, torch.from_numpy(prompt), 16, 3)
    eos = int(free[0, 0, 8])
    toks, scores = beam_search(tm, torch.from_numpy(prompt), 16, 3,
                               eos_id=eos)
    wt, ws = jax_beam(jm, params, jnp.asarray(prompt), 16, 3, eos_id=eos)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(wt))
    row = toks[0, 0].tolist()
    if eos in row[4:]:
        after = row[row.index(eos, 4) + 1:]
        assert all(t == 0 for t in after)


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("call", [
    dict(n_steps=33),
    dict(temperature=0.5),
    dict(top_k=3),
    dict(top_p=0.5),
    dict(temperature=0.5, rng=0, top_p=1.5),
    dict(temperature=0.5, rng=0, top_p=0.0),
    dict(temperature=0.5, rng=0, top_k=0),
    dict(temperature=0.5, rng=0, top_k=65),
], ids=["horizon", "no-rng", "top_k-greedy", "top_p-greedy", "top_p-high",
        "top_p-zero", "top_k-zero", "top_k-vocab"])
def test_generate_validation_matches_jax(call):
    jm, params, tm = _pair("learned-mha")
    kw = dict(call)
    n_steps = kw.pop("n_steps", 12)
    prompt = _prompts(6)
    jkw = {**kw, **({"rng": jax.random.PRNGKey(0)} if "rng" in kw else {})}
    tkw = {**kw, **({"rng": np.asarray(jax.random.PRNGKey(0))}
                    if "rng" in kw else {})}
    want = _error(lambda: jax_generate(jm, params, jnp.asarray(prompt),
                                       n_steps, **jkw))
    got = _error(lambda: generate(tm, torch.from_numpy(prompt), n_steps,
                                  **tkw))
    assert got == want


def test_beam_and_return_hidden_validation_match_jax():
    jm, params, tm = _pair("learned-mha")
    prompt = _prompts(7)
    assert _error(lambda: beam_search(tm, torch.from_numpy(prompt), 8,
                                      0)) == _error(
        lambda: jax_beam(jm, params, jnp.asarray(prompt), 8, 0))
    hidden = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                           return_hidden=True)
    jhidden = jm.clone(return_hidden=True)
    assert _error(lambda: generate(hidden, torch.from_numpy(prompt),
                                   8)) == _error(
        lambda: jax_generate(jhidden, params, jnp.asarray(prompt), 8))


def test_adapters_are_refused_naming_their_roadmap_item():
    _, _, tm = _pair("learned-mha")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        generate(tm, torch.from_numpy(_prompts(8)), 8, adapters=[{}, {}])
