"""Counter-keyed sampling in the PyTorch port against ``jax.random`` and
the JAX package's sampling front.

- ``utils.prng``: key data (``PRNGKey`` of seeds that are negative or at
  least 2**31), ``fold_in`` of counters up to 2**31 - 1, the random bits
  and the fp32 and bf16 uniforms are held **bit-exact** to jax 0.9
  (``jax_threefry_partitionable`` on). Gumbel noise goes through ``log``
  twice, and torch's and XLA's ``log`` may differ in the last bit: it is
  held to ``rtol 1e-6``, and ``categorical`` must give the same token as
  ``jax.random.categorical`` on the same logits, row for row.
- ``stream_sample_keys``: the same ``[B, 2]`` key words as JAX's.
- ``_filter_logits`` / ``_tempered_filtered``: the same surviving tokens
  (the same ``-inf`` pattern, the survivors' values within fp32 ``1e-6``
  after the temperature's division) for top-k, top-p and both.
- ``generate`` sampled (temperature 0.8, top-k, top-p, per-row seeds):
  the same token streams as JAX ``generate`` over weights carried across
  with ``convert.lm_state_from_flax``, fp32 compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import _filter_logits as jax_filter
from chainermn_tpu.models.transformer import (
    _tempered_filtered as jax_tempered,
)
from chainermn_tpu.models.transformer import generate as jax_generate
from chainermn_tpu.models.transformer import (
    stream_sample_keys as jax_stream_keys,
)
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM, generate
from chainermn_tpu_torch.models.transformer import (
    _filter_logits,
    _tempered_filtered,
    stream_sample_keys,
)
from chainermn_tpu_torch.utils import prng
from torch_rank_workers import few_threads  # noqa: F401

SEEDS = [0, 1, 7, 12345, -1, -2**31, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5,
         2**40 + 3]
COUNTERS = [0, 1, 2, 255, 2048, 123456789, 2**31 - 1]


def _words(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_and_fold_in_are_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(),
                                  _words(jax.random.key_data(jk)))
    want = np.stack([_words(jax.random.fold_in(jk, c)) for c in COUNTERS])
    got = prng.fold_in(tk, torch.tensor(COUNTERS)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("counter", COUNTERS)
def test_bits_and_uniforms_are_bit_exact(counter):
    jk = jax.random.fold_in(jax.random.PRNGKey(2024), counter)
    tk = prng.fold_in(prng.PRNGKey(2024), counter)
    for shape in [(1,), (37,), (3, 129)]:
        np.testing.assert_array_equal(
            prng.random_bits(tk, shape).numpy(),
            _words(jax.random.bits(jk, shape)))
        for jdt, tdt in [(jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)]:
            want = np.asarray(jax.random.uniform(jk, shape, jdt)
                              .astype(jnp.float32))
            got = prng.uniform(tk, shape, tdt).float().numpy()
            np.testing.assert_array_equal(got, want)
        want = np.asarray(jax.random.uniform(jk, shape, minval=-2.0,
                                             maxval=3.0))
        got = prng.uniform(tk, shape, minval=-2.0, maxval=3.0).numpy()
        np.testing.assert_array_equal(got, want)


def test_gumbel_within_an_ulp_and_categorical_token_identical():
    base = jax.random.PRNGKey(3)
    counters = np.arange(64, dtype=np.int32) * 7919
    jkeys = jax.vmap(lambda c: jax.random.fold_in(base, c))(counters)
    tkeys = prng.fold_in(prng.PRNGKey(3), torch.from_numpy(counters))
    np.testing.assert_array_equal(tkeys.numpy(), _words(jkeys))
    want_g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (512,)))(
        jkeys))
    got_g = prng.gumbel(tkeys, (512,)).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)
    logits = np.random.RandomState(0).randn(64, 512).astype(np.float32) * 3
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jkeys, jnp.asarray(logits)))
    got = prng.categorical(tkeys, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_stream_sample_keys_match_jax():
    base = jax.random.PRNGKey(11)
    seeds = np.array([0, 5, 2**31 - 1, 77, 123456], np.int32)
    counters = np.array([1, 16, 2047, 2**31 - 1, 9], np.int32)
    want = _words(jax_stream_keys(base, seeds, counters))
    got = stream_sample_keys(np.asarray(base), torch.from_numpy(seeds),
                             torch.from_numpy(counters)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None),
                                         (None, 0.9), (20, 0.8), (1, 0.5),
                                         (64, 1.0)])
def test_filter_logits_match_jax(top_k, top_p):
    logits = np.random.RandomState(1).randn(6, 64).astype(np.float32) * 2
    want = np.asarray(jax_filter(jnp.asarray(logits), top_k, top_p))
    got = _filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax_tempered(jnp.asarray(logits), 0.7, top_k, top_p))
    got = _tempered_filtered(torch.from_numpy(logits), 0.7, top_k,
                             top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)


@pytest.fixture(scope="module")
def lm_pair():
    jm = JaxLM(**CFG, compute_dtype=jnp.float32, pos_encoding="rope",
               num_kv_heads=2)
    params = jm.init(jax.random.PRNGKey(4), jnp.zeros((1, 4), jnp.int32),
                     train=False)
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                       pos_encoding="rope", num_kv_heads=2)
    tm.load_state_dict(lm_state_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("kw", [dict(temperature=1.0),
                                dict(temperature=0.8, top_k=10),
                                dict(temperature=0.8, top_k=50, top_p=0.95),
                                dict(temperature=1.3, top_p=0.6)],
                         ids=["t1", "t0.8-k10", "t0.8-k50-p0.95",
                              "t1.3-p0.6"])
def test_sampled_generate_streams_match_jax(lm_pair, kw):
    jm, params, tm = lm_pair
    rs = np.random.RandomState(8)
    prompt = rs.randint(1, CFG["vocab_size"], size=(4, 6)).astype(np.int32)
    prompt[1, 3:] = 0  # ragged rows (pad id 0)
    prompt[3, 1:] = 0
    seeds = [0, 99, 2**31 - 1, 4242]
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), 24,
                                   rng=key, seeds=seeds, **kw))
    got = generate(tm, torch.from_numpy(prompt), 24, rng=np.asarray(key),
                   seeds=seeds, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    again = generate(tm, torch.from_numpy(prompt), 24, rng=prng.PRNGKey(17),
                     seeds=seeds, **kw).numpy()
    np.testing.assert_array_equal(again, got)
