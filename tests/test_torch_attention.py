"""The port's attention primitives against the JAX package's, fp32, the
same numpy inputs on both sides.

Tolerance 1e-5 (relative and absolute): fp32 throughout, reductions in
other orders (XLA vs PyTorch CPU kernels).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu_torch.ops import attention as tat
from torch_rank_workers import few_threads  # noqa: F401

# the JAX package's ops/__init__ exports a function named ``attention``
jat = importlib.import_module("chainermn_tpu.ops.attention")

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, H, D = 2, 24, 4, 8


def _qkv(seed, kv_heads=H, Tk=T):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T, H, D).astype(np.float32),
            rs.randn(B, Tk, kv_heads, D).astype(np.float32),
            rs.randn(B, Tk, kv_heads, D).astype(np.float32))


def _seg(seed):
    rs = np.random.RandomState(seed)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cut = rs.randint(4, T - 4)
        seg[b, cut:] = 1
    return seg


def _both(fn_j, fn_t, arrays, **kw):
    want = fn_j(*map(jnp.asarray, arrays), **kw)
    got = fn_t(*map(torch.tensor, arrays), **kw)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=True), dict(causal=True, kv_heads=2),
    dict(causal=True, q_offset=5, kv_offset=2), dict(seg=True),
    dict(causal=True, seg=True), dict(bias=True), dict(scale=0.3)],
    ids=["full", "causal", "gqa", "offsets", "segments", "causal-segments",
         "bias", "scale"])
def test_dot_product_attention(kw):
    kw = dict(kw)
    q, k, v = _qkv(1, kw.pop("kv_heads", H))
    extra = {}
    if kw.pop("seg", False):
        extra["segment_ids"] = _seg(2)
    if kw.pop("bias", False):
        extra["bias"] = np.random.RandomState(3).randn(1, H, T, T).astype(
            np.float32)
    want = jat.dot_product_attention(
        *map(jnp.asarray, (q, k, v)),
        **{n: jnp.asarray(a) for n, a in extra.items()}, **kw)
    got = tat.dot_product_attention(
        *map(torch.tensor, (q, k, v)),
        **{n: torch.tensor(a) for n, a in extra.items()}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_online_softmax_blocks_then_finalize(causal):
    """Two online steps over two K/V blocks, then the normalisation."""
    q, k, v = _qkv(4, Tk=16)
    o = np.zeros((B, T, H, D), np.float32)
    m = np.full((B, H, T), -1e30, np.float32)
    l = np.zeros((B, H, T), np.float32)
    jo, jm, jl = map(jnp.asarray, (o, m, l))
    to, tm, tl = map(torch.tensor, (o, m, l))
    for start in (0, 8):
        kw = dict(causal=causal, q_offset=4, kv_offset=start)
        jo, jm, jl = jat.online_softmax_block(
            jnp.asarray(q), jnp.asarray(k[:, start:start + 8]),
            jnp.asarray(v[:, start:start + 8]), jo, jm, jl, **kw)
        to, tm, tl = tat.online_softmax_block(
            torch.tensor(q), torch.tensor(k[:, start:start + 8]),
            torch.tensor(v[:, start:start + 8]), to, tm, tl, **kw)
        for got, want in ((to, jo), (tm, jm), (tl, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tat.finalize_online_softmax(to, tl, torch.float32).numpy(),
        np.asarray(jat.finalize_online_softmax(jo, jl, jnp.float32)), **TOL)


@pytest.mark.parametrize("causal,block_k,kv_heads", [
    (False, 8, H), (True, 8, H), (True, 7, H), (True, 12, 2)])
def test_blockwise_attention(causal, block_k, kv_heads):
    got, want = _both(jat.blockwise_attention, tat.blockwise_attention,
                      _qkv(5, kv_heads), causal=causal, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl,window,seg", [
    ("xla", None, False), ("xla", 5, False), ("xla", 5, True),
    ("flash", None, True), ("windowed", 5, True)])
def test_attention_dispatch(impl, window, seg):
    """Every variant computes the same attention; the xla window is the
    additive band bias."""
    q, k, v = _qkv(6)
    s = _seg(7) if seg else None
    want = jat.attention(*map(jnp.asarray, (q, k, v)), causal=True,
                         window=window, impl=impl,
                         segment_ids=None if s is None else jnp.asarray(s),
                         interpret=True)
    got = tat.attention(*map(torch.tensor, (q, k, v)), causal=True,
                        window=window, impl=impl,
                        segment_ids=None if s is None else torch.tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_auto_and_bad_options_raise():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tat.attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tat.attention(q, q, q, impl="fast")
    with pytest.raises(ValueError, match="causal"):
        tat.attention(q, q, q, window=2, impl="xla")
