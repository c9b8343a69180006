"""The port's bidirectional MLM encoder against the JAX package's.

- ``TransformerLM(causal=False)``: logits, ``mlm_loss`` and every
  parameter's gradient against JAX ``TransformerLM(causal=False)`` on
  flax weights carried across by ``convert.lm_state_from_flax``, at fp32
  compute, with flash attention on both sides (the JAX Pallas kernels in
  interpret mode, the port's plain versions of K1-K3 without the mask),
  and with the default blockwise attention.
- Position 0 sees token 5 if and only if ``causal=False`` (JAX
  ``tests/test_language_models.py``'s future-token test).
- Decode and the window are refused without the mask.
- ``mlm_loss`` against JAX ``mlm_loss`` on the same logits.
- ``mlm_corrupt_from_draws`` fed the draws JAX ``mlm_corrupt`` makes
  (``jax.random.split(key, 3)`` and its three draws replayed here) gives
  JAX's ``(corrupted, selected)`` bit for bit, small vocabularies (where
  a random token lands on the mask id) included.
- ``mlm_corrupt`` drawing from a ``torch.Generator``: the 80/10/10 shares
  within 5 binomial standard deviations, and the example twin's ``--mlm``.

Tolerances: logits, loss and gradients 1e-4 (relative and absolute; fp32
with reductions in other orders, as in ``tests/test_torch_transformer.py``);
``mlm_loss`` 1e-6; the corruption exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import mlm_corrupt as jax_mlm_corrupt
from chainermn_tpu.models.transformer import mlm_loss as jax_mlm_loss
from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.examples.transformer import train_transformer_lm
from chainermn_tpu_torch.models import (
    TransformerLM,
    mlm_corrupt,
    mlm_corrupt_from_draws,
    mlm_loss,
)
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from torch_rank_workers import few_threads, restore_excepthook  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)
MASK_ID = 63
B, T = 2, 16


def _jax_attn(q, k, v, *, causal, scale, segment_ids=None):
    return jax_flash(q, k, v, causal=causal, scale=scale,
                     segment_ids=segment_ids, block_q=8, block_k=8,
                     interpret=True)


def _pair(flash, seed=0):
    jm = JaxLM(**CFG, compute_dtype=jnp.float32, causal=False,
               attention_fn=_jax_attn if flash else None)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                       causal=False,
                       attention_fn=flash_attention if flash else None)
    tm.load_state_dict(lm_state_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params["params"], tm


def _mlm_batch(seed):
    rs = np.random.RandomState(seed)
    targets = rs.randint(0, MASK_ID, size=(B, T)).astype(np.int32)
    x, sel = jax_mlm_corrupt(jax.random.PRNGKey(seed), jnp.asarray(targets),
                             mask_id=MASK_ID, vocab_size=CFG["vocab_size"],
                             rate=0.3)
    return np.array(x), targets, np.array(sel)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "blockwise"])
def test_encoder_logits_loss_and_every_gradient_match(flash):
    jm, params, tm = _pair(flash)
    x, targets, sel = _mlm_batch(1)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    def jloss(p):
        return jax_mlm_loss(jm.apply({"params": p}, jnp.asarray(x)),
                            jnp.asarray(targets), jnp.asarray(sel))

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    loss = mlm_loss(tm(torch.from_numpy(x)), torch.from_numpy(targets),
                    torch.from_numpy(sel))
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    loss.backward()
    want_g = lm_state_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   err_msg=name, **TOL)


def _tiny(causal):
    return TransformerLM(vocab_size=32, num_layers=2, d_model=32, num_heads=2,
                         d_ff=64, max_len=16, compute_dtype=torch.float32,
                         causal=causal, attention_fn=flash_attention,
                         device="cpu")


def test_future_token_dependency_is_the_causal_flag():
    toks = torch.arange(8)[None] % 32
    toks2 = toks.clone()
    toks2[0, 5] = (toks[0, 5] + 7) % 32
    for causal, changes in ((False, True), (True, False)):
        m = _tiny(causal).eval()
        with torch.no_grad():
            a, b = m(toks)[0, 0], m(toks2)[0, 0]
        assert bool((a - b).abs().max() > 1e-6) == changes, causal


def test_decode_and_window_refused_without_the_mask():
    m = _tiny(False)
    with pytest.raises(ValueError, match="causal=True"):
        m(torch.zeros(1, 1, dtype=torch.long), decode=True,
          decode_positions=torch.zeros(1, dtype=torch.int32))
    w = TransformerLM(vocab_size=32, num_layers=1, d_model=32, num_heads=2,
                      d_ff=64, max_len=16, compute_dtype=torch.float32,
                      causal=False, window=4, attention_fn=flash_attention,
                      device="cpu")
    with pytest.raises(ValueError, match="window requires a causal block"):
        w(torch.zeros(1, 8, dtype=torch.long))


def test_mlm_loss_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 10, 40).astype(np.float32)
    targets = rs.randint(0, 40, size=(3, 10)).astype(np.int32)
    for mask in (rs.rand(3, 10) < 0.3, np.zeros((3, 10), bool)):
        want = jax_mlm_loss(jnp.asarray(logits), jnp.asarray(targets),
                            jnp.asarray(mask))
        got = mlm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                       torch.from_numpy(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("seed,vocab,rate", [(0, 1024, 0.15), (1, 8, 0.5),
                                             (2, 3, 0.9), (3, 32000, 0.15)])
def test_mlm_corrupt_rule_on_jax_draws_is_bit_exact(seed, vocab, rate):
    """The JAX function's three draws, replayed: split the key in three,
    two fp32 uniforms and ``randint`` over the vocabulary."""
    shape = (4, 64)
    key = jax.random.PRNGKey(seed)
    tokens = np.random.RandomState(seed).randint(0, vocab - 1, size=shape)
    tokens = jnp.asarray(tokens, jnp.int32)
    mask_id = vocab - 1
    want_x, want_sel = jax_mlm_corrupt(key, tokens, mask_id=mask_id,
                                       vocab_size=vocab, rate=rate)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = [np.array(d) for d in (
        jax.random.uniform(k1, shape), jax.random.uniform(k2, shape),
        jax.random.randint(k3, shape, 0, vocab))]
    got_x, got_sel = mlm_corrupt_from_draws(
        torch.from_numpy(np.array(tokens)),
        *(torch.from_numpy(d) for d in draws), mask_id=mask_id,
        vocab_size=vocab, rate=rate)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    if vocab <= 8:  # a random token drawn at the mask id was shifted
        assert (draws[2] == mask_id).any()
        assert not (got_x.numpy() == mask_id)[
            np.asarray(want_sel) & (draws[1] >= 0.8)].any()


def test_mlm_corrupt_shares_within_binomial_bounds():
    n, vocab, rate = 400_000, 1000, 0.15
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, vocab - 1, (n,), generator=gen)
    x, sel = mlm_corrupt(torch.Generator().manual_seed(1), tokens,
                         mask_id=vocab - 1, vocab_size=vocab, rate=rate)

    def within(count, total, p):
        sd = math.sqrt(total * p * (1 - p))
        return abs(count - total * p) <= 5 * sd

    n_sel = int(sel.sum())
    assert within(n_sel, n, rate)
    masked = int((sel & (x == vocab - 1)).sum())
    kept = int((sel & (x == tokens)).sum())
    # a random draw equal to the original token also keeps it
    p_kept = 0.1 + 0.1 / (vocab - 1)
    assert within(masked, n_sel, 0.8)
    assert within(kept, n_sel, p_kept)
    assert within(n_sel - masked - kept, n_sel, 1 - 0.8 - p_kept)
    assert not bool((~sel & (x != tokens)).any())


def test_example_twin_trains_the_encoder(capsys):
    metrics = train_transformer_lm.main(
        ["--device", "cpu", "--num-layers", "1", "--d-model", "32",
         "--seq-len", "48", "--batchsize", "2", "--iterations", "2",
         "--mlm"])
    assert math.isfinite(float(metrics["loss"]))
    out = capsys.readouterr().out
    assert "iter 2/2 loss=" in out and "done (mlm)" in out
