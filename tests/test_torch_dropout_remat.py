"""The port's residual dropout and per-block rematerialisation against
the JAX package's behaviour.

- Remat, ``'dots'`` and ``'nothing'``, changes memory and never values:
  the same logits and gradients as without it (JAX
  ``test_remat_matches_plain``), and against JAX ``TransformerLM(remat=
  True)`` on the same flax weights (the default blockwise attention on
  both sides).
- Dropout is active in training, where two generators give two results,
  and inert in eval, where it equals the rate-0 model and needs no
  generator (JAX ``test_dropout_active_in_train_inert_in_eval``); training
  without a generator raises.
- Dropout composes with remat under an explicit generator (JAX
  ``test_dropout_composes_with_remat``): the masks are drawn before a
  block is entered, so the recomputed block applies the same masks and
  the gradients equal those of the same generator without remat.
- A dropped branch entry is 0 and a kept one is scaled by 1/(1 - rate),
  with the kept share within binomial bounds.

Tolerances: remat against plain 1e-6 on logits and 1e-5 relative / 1e-6
absolute on gradients (the JAX test's); against JAX 1e-4 (the model
tests'); dropout with and without remat exact (the same operations on
the same masks).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM, lm_loss
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from torch_rank_workers import few_threads  # noqa: F401

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)


def _model(**kw):
    return TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                         attention_fn=flash_attention, seed=3, **kw)


def _tokens(seed, B=2, T=16):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 64,
                                                                (B, T)))


def _grads(model, tokens, **kw):
    model.zero_grad(set_to_none=True)
    logits = model(tokens, **kw)
    lm_loss(logits, tokens).backward()
    return logits.detach(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_remat_matches_plain(policy):
    tokens = _tokens(2)
    la, ga = _grads(_model(), tokens)
    lb, gb = _grads(_model(remat=True, remat_policy=policy), tokens)
    np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-6, atol=1e-6)
    for n in ga:
        np.testing.assert_allclose(gb[n].numpy(), ga[n].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_remat_policy_is_validated():
    with pytest.raises(ValueError, match="remat_policy"):
        _model(remat=True, remat_policy="everything")


def test_remat_matches_jax_remat():
    jm = JaxLM(**CFG, compute_dtype=jnp.float32, remat=True)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                       remat=True)
    tm.load_state_dict(lm_state_from_flax(jax.tree.map(np.asarray, params)))
    tokens = _tokens(6)
    jt = jnp.asarray(tokens.numpy())
    want = jax.jit(jm.apply)(params, jt)
    jgrads = jax.jit(jax.grad(lambda p: jax_lm_loss(jm.apply(p, jt), jt)))(
        params)
    got, grads = _grads(tm, tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    want_g = lm_state_from_flax(jax.tree.map(np.asarray, jgrads))
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[n].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_dropout_active_in_train_inert_in_eval():
    model = _model(dropout_rate=0.5)
    tokens = _tokens(70, T=12)
    with torch.no_grad():
        a = model(tokens, dropout_generator=torch.Generator().manual_seed(1))
        b = model(tokens, dropout_generator=torch.Generator().manual_seed(2))
        a2 = model(tokens, dropout_generator=torch.Generator().manual_seed(1))
    assert not torch.allclose(a, b, atol=1e-4)
    assert torch.equal(a, a2)  # the generator decides the masks
    with pytest.raises(ValueError, match="dropout_generator"):
        model(tokens)
    model.eval()
    with torch.no_grad():
        e1, e2 = model(tokens), model(tokens)
        ref = _model().eval()(tokens)
    assert torch.equal(e1, e2)
    np.testing.assert_allclose(e1.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_dropout_composes_with_remat(policy):
    """The generator's state moves on between the forward and the
    backward; a block that redrew its masks in the recomputation would
    apply other masks there and give other gradients."""
    tokens = _tokens(73, T=8)
    plain = _model(dropout_rate=0.3)
    remat = _model(dropout_rate=0.3, remat=True, remat_policy=policy)
    la, ga = _grads(plain, tokens,
                    dropout_generator=torch.Generator().manual_seed(3))
    lb, gb = _grads(remat, tokens,
                    dropout_generator=torch.Generator().manual_seed(3))
    assert torch.equal(la, lb)
    for n in ga:
        assert torch.isfinite(gb[n]).all(), n
        assert torch.equal(ga[n], gb[n]), n


def test_dropout_zeroes_and_scales_the_branch_outputs():
    block = _model(dropout_rate=0.25).blocks[0]
    h = torch.randn(4, 64, 32, generator=torch.Generator().manual_seed(0))
    keep = torch.rand(h.shape, generator=torch.Generator().manual_seed(1)) \
        < 0.75
    out = block._dropout(h, keep)
    assert torch.equal(out[~keep], torch.zeros_like(out[~keep]))
    torch.testing.assert_close(out[keep], h[keep] / 0.75)
    assert block._dropout(h, None) is h
    n = keep.numel()
    assert abs(int(keep.sum()) - 0.75 * n) <= 5 * math.sqrt(n * 0.75 * 0.25)
