"""The port's ``lm_loss_fused`` (chunked tied head + next-token
cross-entropy, each chunk recomputed in the backward) against ``lm_loss``
and against the JAX package's ``lm_loss_fused``.

- Port fused == port unfused on the same hidden states and table, value
  and both gradients, with chunk counts that leave a padded tail chunk
  and one that does not; and the JAX test ``test_fused_lm_loss_matches_
  plain`` ported: the whole model with ``return_hidden=True`` + fused
  against the model's logits + ``lm_loss``, every parameter's gradient.
- Port fused == JAX ``lm_loss_fused`` on the same hidden states, table
  and tokens: the loss and the gradients in the hidden states and in the
  table, at fp32 and at bf16 compute.

Tolerances: fp32 1e-5 on the loss and 1e-4 relative / 1e-5 absolute on
gradients (the JAX test's own); the whole-model comparison 1e-4 (the
model tests'). bf16 compute: the loss 1e-5 relative (the products of
bf16 operands are exact in fp32 on both sides, only the summation order
differs), the gradients 1e-2 of their largest entry (JAX feeds the fp32
logit cotangent to a bf16-output product, the port rounds it to bf16
first: a bf16 rounding apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chainermn_tpu.models.transformer import lm_loss_fused as jax_fused
from chainermn_tpu_torch.models import TransformerLM, lm_loss, lm_loss_fused
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from torch_rank_workers import few_threads  # noqa: F401

V, D = 48, 16


def _inputs(seed, B=3, T=17):
    rs = np.random.RandomState(seed)
    hidden = rs.randn(B, T, D).astype(np.float32)
    table = (rs.randn(V, D) * 0.5).astype(np.float32)
    tokens = rs.randint(0, V, size=(B, T)).astype(np.int32)
    return hidden, table, tokens


def _port(fn, hidden, table, tokens, **kw):
    h = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(table, requires_grad=True)
    loss = fn(h, w, torch.from_numpy(tokens), **kw)
    loss.backward()
    return float(loss.detach()), h.grad.numpy(), w.grad.numpy()


def _unfused(h, w, tokens):
    return lm_loss(F.linear(h, w), tokens)


@pytest.mark.parametrize("n_chunks", [1, 4, 5, 7],
                         ids=["one", "even", "padded-tail", "padded-7"])
def test_fused_equals_unfused(n_chunks):
    """3 x 16 = 48 positions: 4 chunks divide them, 5 and 7 leave a
    padded tail chunk."""
    args = _inputs(0)
    lf, hf, wf = _port(lm_loss_fused, *args, n_chunks=n_chunks,
                       compute_dtype=torch.float32)
    lu, hu, wu = _port(_unfused, *args)
    np.testing.assert_allclose(lf, lu, rtol=1e-5)
    np.testing.assert_allclose(hf, hu, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wf, wu, rtol=1e-4, atol=1e-5)


def test_fused_lm_loss_matches_plain_through_the_model():
    cfg = dict(vocab_size=V, num_layers=2, num_heads=2, d_model=D,
               d_ff=32, max_len=32, compute_dtype=torch.float32,
               attention_fn=flash_attention, device="cpu", seed=4)
    plain = TransformerLM(**cfg)
    hidden_model = TransformerLM(**cfg, return_hidden=True)
    hidden_model.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, V, (3, 17)))
    lp = lm_loss(plain(tokens), tokens)
    lp.backward()
    lf = lm_loss_fused(hidden_model(tokens), hidden_model.tok_emb.weight,
                       tokens, n_chunks=4, compute_dtype=torch.float32)
    lf.backward()
    np.testing.assert_allclose(float(lf.detach()), float(lp.detach()),
                               rtol=1e-5)
    for (name, a), b in zip(hidden_model.named_parameters(),
                            plain.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [4, 5], ids=["even", "padded-tail"])
def test_fused_matches_jax(dtype, n_chunks):
    hidden, table, tokens = _inputs(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(h, w):
        return jax_fused(h, w, jnp.asarray(tokens), n_chunks=n_chunks,
                         compute_dtype=jdt)

    jl, (jh, jw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    lf, hf, wf = _port(lm_loss_fused, hidden, table, tokens,
                       n_chunks=n_chunks, compute_dtype=tdt)
    if dtype == "float32":
        np.testing.assert_allclose(lf, float(jl), rtol=1e-5)
        np.testing.assert_allclose(hf, np.asarray(jh), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(wf, np.asarray(jw), rtol=1e-4, atol=1e-5)
        return
    np.testing.assert_allclose(lf, float(jl), rtol=1e-5)
    for got, want in ((hf, np.asarray(jh, np.float32)),
                      (wf, np.asarray(jw, np.float32))):
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
