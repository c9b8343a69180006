"""The port's flash attention (plain versions of K1–K3, the autograd
function, the block entries) against the JAX package's Pallas kernels,
which run in interpret mode exactly as ``tests/test_ops.py`` runs them.

The same numpy inputs go to both sides at fp32. Tolerances are those of
``tests/test_ops.py``: 1e-5 on the forward (O, LSE), 1e-4 on gradients
(both relative and absolute), since the two sides sum in other orders and
the port's plain version takes one softmax pass where the kernels take
the online recurrence.

Two rules the bf16 CUDA kernels rely on are held here on the CPU too: a
masked entry gives p = 0, so rows that see no key get O = 0 and exact
zero gradients; and the segment tile skip drops only fully masked
tiles, which K1's tile loop, emulated here, shows on the forward.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_block_bwd as jax_block_bwd,
    flash_block_fwd as jax_block_fwd,
)
from chainermn_tpu_torch.examples.transformer.train_transformer_lm import (
    pack_documents,
)
from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.ops import flash_attention as fa
from torch_rank_workers import few_threads  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
B, H, D = 2, 4, 16


def _segments(rs, T):
    """Three packed documents of uneven length per row."""
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = sorted(rs.choice(np.arange(4, T - 4), 2, replace=False))
        seg[b, cuts[0]:cuts[1]] = 1
        seg[b, cuts[1]:] = 2
    return seg


def _alibi(T):
    slopes = 2.0 ** (-np.arange(1, H + 1))
    dist = np.arange(T)[None, :] - np.arange(T)[:, None]
    return (slopes[:, None, None] * np.minimum(dist, 0)[None])[None].astype(
        np.float32)


# The cases of tests/test_ops.py: causal on/off, segments, GQA with 1 and
# 2 kv heads, bias with and without its gradient, windows (mixed block
# sizes, window >= T, with segments and GQA, with a trainable bias) and
# odd sequence lengths.
CASES = {
    "full": dict(causal=False),
    "causal": dict(causal=True),
    "segments": dict(causal=False, seg=True),
    "causal-segments": dict(causal=True, seg=True),
    "gqa-1": dict(causal=True, kv_heads=1),
    "gqa-2": dict(causal=True, kv_heads=2),
    "bias": dict(causal=False, bias="alibi"),
    "causal-bias": dict(causal=True, bias="alibi"),
    "bias-grad": dict(causal=True, bias="alibi", bias_grad=True),
    "window-1": dict(causal=True, window=1),
    "window-7": dict(causal=True, window=7),
    "window-mixed-8x16": dict(causal=True, window=10, blocks=(8, 16)),
    "window-mixed-16x8": dict(causal=True, window=2, blocks=(16, 8)),
    "window-mixed-8x8": dict(causal=True, window=10, blocks=(8, 8)),
    "window-ge-T": dict(causal=True, window=48),
    "window-segments-gqa": dict(causal=True, window=9, seg=True,
                                kv_heads=2),
    "window-trainable-bias": dict(causal=True, window=12, bias="random",
                                  bias_grad=True),
    "odd-T-37": dict(causal=True, T=37),
    "odd-T-61-segments": dict(causal=True, T=61, seg=True),
}


def _inputs(case, seed):
    rs = np.random.RandomState(seed)
    T = case.get("T", 48)
    kvh = case.get("kv_heads", H)
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, T, kvh, D).astype(np.float32)
    v = rs.randn(B, T, kvh, D).astype(np.float32)
    seg = _segments(rs, T) if case.get("seg") else None
    bias = None
    if case.get("bias") == "alibi":
        bias = _alibi(T)
    elif case.get("bias") == "random":
        bias = (rs.randn(1, 1, T, T) * 0.1).astype(np.float32)
    return q, k, v, seg, bias


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    case = CASES[name]
    q, k, v, seg, bias = _inputs(case, seed=sorted(CASES).index(name))
    bq, bk = case.get("blocks", (16, 16))
    kw = dict(causal=case["causal"], window=case.get("window"),
              bias_grad=case.get("bias_grad", False))
    with_bias = bias is not None

    def jax_loss(q, k, v, b):
        out = jax_flash(q, k, v, segment_ids=None if seg is None
                        else jnp.asarray(seg), bias=b if with_bias else None,
                        block_q=bq, block_k=bk, interpret=True, **kw)
        return (out ** 2).sum(), out

    args = [jnp.asarray(x) for x in (q, k, v)]
    args.append(jnp.asarray(bias) if with_bias else jnp.zeros(()))
    (_, want), grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)

    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tb = torch.tensor(bias, requires_grad=True) if with_bias else None
    out = fa.flash_attention(
        tq, tk, tv, segment_ids=None if seg is None else torch.tensor(seg),
        bias=tb, block_q=bq, block_k=bk, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    (out ** 2).sum().backward()
    pairs = [(tq.grad, grads[0]), (tk.grad, grads[1]), (tv.grad, grads[2])]
    if with_bias:
        pairs.append((tb.grad, grads[3]))
        if not kw["bias_grad"]:  # the static-bias contract: zero cotangent
            assert float(tb.grad.abs().max()) == 0.0
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD)


@pytest.mark.parametrize("q_offset,window,seg", [
    (16, None, False), (40, None, False), (16, 20, False), (24, None, True)])
def test_block_entries_match_jax(q_offset, window, seg):
    """``flash_block_fwd``/``flash_block_bwd`` with ``q_offset > 0``: a
    16-row Q shard against a 48-key block, LSE/delta as [B, H, Tq]."""
    rs = np.random.RandomState(q_offset + (window or 0))
    Tq, Tk = 16, 48
    q = rs.randn(B, Tq, H, D).astype(np.float32)
    k = rs.randn(B, Tk, 2, D).astype(np.float32)
    v = rs.randn(B, Tk, 2, D).astype(np.float32)
    do = rs.randn(B, Tq, H, D).astype(np.float32)
    seg_kv = None
    if seg:
        seg_kv = np.repeat(np.arange(3)[None], B, 0).repeat(16, 1)
        seg_kv = seg_kv.astype(np.int32)
    seg_q = None if seg_kv is None else seg_kv[:, q_offset:q_offset + Tq]
    kw = dict(causal=True, scale=0.3, window=window, q_offset=q_offset,
              block_q=8, block_k=16)
    jseg = ({} if seg_kv is None else
            dict(seg_q=jnp.asarray(seg_q), seg_kv=jnp.asarray(seg_kv)))
    tseg = ({} if seg_kv is None else
            dict(seg_q=torch.tensor(seg_q), seg_kv=torch.tensor(seg_kv)))
    jo, jlse = jax_block_fwd(*map(jnp.asarray, (q, k, v)), interpret=True,
                             **kw, **jseg)
    to, tlse = fa.flash_block_fwd(*map(torch.tensor, (q, k, v)), **kw,
                                  **tseg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD)
    delta = (do * np.asarray(jo)).sum(-1).transpose(0, 2, 1)
    want = jax_block_bwd(*map(jnp.asarray, (q, k, v, do)), jlse,
                         jnp.asarray(delta), interpret=True, **kw, **jseg)
    got = fa.flash_block_bwd(*map(torch.tensor, (q, k, v, do)),
                             torch.tensor(np.asarray(jlse)),
                             torch.tensor(delta), **kw, **tseg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)


@pytest.mark.parametrize("variant", [
    dict(causal=True, seg=True), dict(causal=False, bias=True),
    dict(causal=True, window=3, kv_heads=1)])
def test_autograd_function_gradcheck_float64(variant):
    """The autograd function's backward (the plain K2/K3 on fp64) is the
    true gradient of its forward."""
    rs = np.random.RandomState(3)
    T, kvh = 6, variant.get("kv_heads", 2)
    q, k, v = (torch.tensor(rs.randn(1, T, n, 4), dtype=torch.float64,
                            requires_grad=True) for n in (2, kvh, kvh))
    seg = torch.tensor([[0, 0, 0, 1, 1, 1]]) if variant.get("seg") else None
    inputs = [q, k, v]
    if variant.get("bias"):
        inputs.append(torch.tensor(rs.randn(1, 2, T, T) * 0.3,
                                   dtype=torch.float64, requires_grad=True))

    def f(*xs):
        bias = xs[3] if len(xs) > 3 else None
        return fa.flash_attention(xs[0], xs[1], xs[2],
                                  causal=variant["causal"], segment_ids=seg,
                                  bias=bias, bias_grad=bias is not None,
                                  window=variant.get("window"))

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-5)


def test_validation_matches_jax():
    q = torch.zeros(1, 16, 4, 8)
    kv = torch.zeros(1, 16, 3, 8)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="bias must be"):
        fa.flash_attention(q, q, q, bias=torch.zeros(1, 4, 16, 17))
    with pytest.raises(ValueError, match="bias_grad"):
        fa.flash_attention(q, q, q, bias_grad=True)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        fa.flash_attention(q, q, q, causal=True, window=0)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(fa, "load_kernel", no_kernel)
    before = dict(fa.LAUNCHES)
    rs = np.random.RandomState(0)
    q = torch.tensor(rs.randn(1, 8, 2, 4), dtype=torch.float32,
                     requires_grad=True)
    out = fa.flash_attention(q, q, q, causal=True)
    out.sum().backward()
    want, _ = fa.flash_attention_fwd_reference(q, q, q, causal=True,
                                               scale=0.5)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert fa.LAUNCHES == before


def test_loading_the_library_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc, no built library: the load raises and nothing falls back
    to another implementation."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(fa, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.load_kernel()
    assert fa._lib is None


@pytest.mark.parametrize("fails", [False, True])
def test_a_build_leaves_only_its_library(monkeypatch, tmp_path, fails):
    """One ``nvcc -c`` per source, then a link: the objects go with their
    temporary directory whether or not a compile fails, and a failure
    raises with nvcc's output and leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "out=''\nprev=''\n"
        "for a in \"$@\"; do [ \"$prev\" = -o ] && out=$a; prev=$a; done\n"
        ": > \"$out\"\n"
        + ("case \"$*\" in *_sm90.cu*) echo bad source >&2; exit 1;; esac\n"
           if fails else "") + "exit 0\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    build = tmp_path / "build"
    out = build / "libflash_attention_test.so"
    paths = [_build.CSRC_DIR / s for s in fa.SOURCES]
    if fails:
        with pytest.raises(RuntimeError, match="bad source"):
            _build.compile_library("flash_attention", paths, out)
        assert list(build.iterdir()) == []
    else:
        _build.compile_library("flash_attention", paths, out)
        assert list(build.iterdir()) == [out]


# ------------------------------------------------- rows that see no key

def _no_key_inputs(seed):
    """A 16-row Q shard at q_offset 32 against three 16-key documents:
    the rows ask for the last document, except rows 0, 5 and 11, whose
    segment id no key carries."""
    rs = np.random.RandomState(seed)
    Tq, Tk = 16, 48
    q = rs.randn(B, Tq, H, D).astype(np.float32)
    k = rs.randn(B, Tk, 2, D).astype(np.float32)
    v = rs.randn(B, Tk, 2, D).astype(np.float32)
    do = rs.randn(B, Tq, H, D).astype(np.float32)
    seg_kv = np.repeat(np.arange(3)[None], B, 0).repeat(16, 1)
    seg_kv = seg_kv.astype(np.int32)
    seg_q = np.full((B, Tq), 2, np.int32)
    seg_q[:, [0, 5, 11]] = 9
    return q, k, v, do, seg_q, seg_kv


NO_KEY = [0, 5, 11]
NO_KEY_KW = dict(causal=True, scale=0.3, q_offset=32, block_q=8, block_k=16)


def test_rows_that_see_no_key_get_zero_gradients():
    """No row sees a key (every query's segment differs from every key's):
    the forward gives O = 0 and LSE = NEG_INF as the JAX kernel does, and
    the port's dq, dk and dv are exactly 0 -- the gradient of a constant
    output -- where ``exp(s - lse)`` alone would give p = 1."""
    rs = np.random.RandomState(7)
    q = rs.randn(1, 16, 2, 8).astype(np.float32)
    k = rs.randn(1, 48, 2, 8).astype(np.float32)
    v = rs.randn(1, 48, 2, 8).astype(np.float32)
    do = rs.randn(1, 16, 2, 8).astype(np.float32)
    seg_q = np.zeros((1, 16), np.int32)
    seg_kv = np.ones((1, 48), np.int32)
    kw = dict(causal=True, scale=8 ** -0.5, q_offset=0, block_q=8,
              block_k=16)
    jo, jlse = jax_block_fwd(*map(jnp.asarray, (q, k, v)), interpret=True,
                             seg_q=jnp.asarray(seg_q),
                             seg_kv=jnp.asarray(seg_kv), **kw)
    tseg = dict(seg_q=torch.tensor(seg_q), seg_kv=torch.tensor(seg_kv))
    to, tlse = fa.flash_block_fwd(*map(torch.tensor, (q, k, v)), **kw,
                                  **tseg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **FWD)
    assert float(to.abs().max()) == 0.0
    delta = (torch.tensor(do) * to).sum(-1).transpose(1, 2)
    got = fa.flash_block_bwd(*map(torch.tensor, (q, k, v, do)), tlse, delta,
                             **kw, **tseg)
    for g in got:
        assert float(g.abs().max()) == 0.0


def test_mixed_no_key_rows_match_jax_with_their_dout_zeroed():
    """Rows 0, 5 and 11 see no key, the rest do. With those rows' dO
    zeroed on the JAX side, the JAX kernel's p = 1 on them multiplies
    zeros, so both sides compute the true gradient; the port gives it
    whatever dO those rows carry."""
    q, k, v, do, seg_q, seg_kv = _no_key_inputs(11)
    do_zeroed = do.copy()
    do_zeroed[:, NO_KEY] = 0.0
    jseg = dict(seg_q=jnp.asarray(seg_q), seg_kv=jnp.asarray(seg_kv))
    tseg = dict(seg_q=torch.tensor(seg_q), seg_kv=torch.tensor(seg_kv))
    jo, jlse = jax_block_fwd(*map(jnp.asarray, (q, k, v)), interpret=True,
                             **NO_KEY_KW, **jseg)
    to, tlse = fa.flash_block_fwd(*map(torch.tensor, (q, k, v)),
                                  **NO_KEY_KW, **tseg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD)
    assert float(to[:, NO_KEY].abs().max()) == 0.0
    jdelta = (do_zeroed * np.asarray(jo)).sum(-1).transpose(0, 2, 1)
    want = jax_block_bwd(*map(jnp.asarray, (q, k, v, do_zeroed)), jlse,
                         jnp.asarray(jdelta), interpret=True, **NO_KEY_KW,
                         **jseg)
    outs = {}
    for name, g in (("do", do), ("zeroed", do_zeroed)):
        tdo = torch.tensor(g)
        delta = (tdo * to).sum(-1).transpose(1, 2)
        outs[name] = fa.flash_block_bwd(*map(torch.tensor, (q, k, v)), tdo,
                                        tlse, delta, **NO_KEY_KW, **tseg)
    for got, zeroed, w in zip(outs["do"], outs["zeroed"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD)
        assert torch.equal(got, zeroed)
    assert float(outs["do"][0][:, NO_KEY].abs().max()) == 0.0


def test_plain_backward_is_the_autograd_gradient_of_the_plain_forward():
    """On the mixed input (fp64), ``torch.autograd.grad`` through the
    plain forward equals the plain backward, rows that see no key
    included."""
    q, k, v, do, seg_q, seg_kv = _no_key_inputs(12)
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in (q, k, v))
    do = torch.tensor(do, dtype=torch.float64)
    kw = dict(causal=True, scale=0.3, q_offset=32,
              seg_q=torch.tensor(seg_q), seg_k=torch.tensor(seg_kv))
    out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    want = torch.autograd.grad((out * do).sum(), (q, k, v))
    delta = (do * out.detach()).sum(-1).transpose(1, 2)
    got = fa.flash_attention_bwd_reference(q.detach(), k.detach(),
                                           v.detach(), do, lse.detach(),
                                           delta, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)
    assert float(got[0][:, NO_KEY].abs().max()) == 0.0


def test_the_library_is_built_from_every_kernel_source(monkeypatch):
    """The flash library's source list names the tensor-core backward, and
    every listed source exists: a forgotten source fails here, not only
    on the card."""
    seen = {}

    class _Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_load(name, sources):
        seen[name] = list(sources)
        return _Lib()

    monkeypatch.setattr(_build, "load_library", fake_load)
    monkeypatch.setattr(fa, "_lib", None)
    fa.load_kernel()
    assert seen == {"flash_attention": list(fa.SOURCES)}
    assert "flash_attention_bwd_sm90.cu" in fa.SOURCES
    for s in fa.SOURCES:
        assert (_build.CSRC_DIR / s).is_file(), s
    assert (_build.CSRC_DIR / "flash_attention.cuh").is_file()
    monkeypatch.setattr(fa, "_lib", None)


def test_bf16_backward_rejects_rows_it_cannot_copy():
    """The bf16 backward kernels copy rows 16 bytes at a time: the model's
    own layout (q/k/v views of one fused product) goes to them as it is,
    and an operand whose base or strides are off that grid is replaced by
    a contiguous copy with the same values before any launch."""
    B_, T, H_, D_ = 1, 8, 2, 32
    qkv = torch.randn(B_, T, 3 * H_ * D_).to(torch.bfloat16)
    q, k, v = (t.reshape(B_, T, H_, D_)
               for t in torch.split(qkv, H_ * D_, dim=-1))
    lse = torch.zeros(B_, H_, T)
    kw = dict(causal=True, scale=0.1, seg_q=None, seg_k=None, bias=None,
              window=None, q_offset=0)
    p = fa._bwd_params(q, k, v, q, lse, lse, **kw)
    assert (p.q, p.k, p.v, p.dout) == tuple(
        t.data_ptr() for t in (q, k, v, q))
    wide = torch.randn(B_, T, H_, D_ + 4).to(torch.bfloat16)
    off = wide[..., 4:]  # 8 bytes past the grid, strides off it too
    p = fa._bwd_params(off, k, v, off, lse, lse, **kw)
    copy = p.keep_alive[0]
    assert p.q == copy.data_ptr() != off.data_ptr()
    assert p.q % 16 == 0 and copy.is_contiguous()
    assert (p.q_sb, p.q_st, p.q_sh) == copy.stride()[:3]
    assert torch.equal(copy, off)
    assert p.k == k.data_ptr()


# ------------------------------------------------- the tile skip
#
# The segment-aware tile skip of the bf16 kernels (``_live_tiles``,
# the rule the CUDA kernels apply on the card): a (q tile, k tile) pair it
# marks dead holds no visible (query, key) pair, for packed documents and
# for unsorted segment ids alike, so skipping it changes no output or
# gradient.

def _tile_any(mask, tile):
    """[B, nq, nk]: does the tile hold a True entry (ragged tails padded
    with False)?"""
    B, Tq, Tk = mask.shape
    nq, nk = -(-Tq // tile), -(-Tk // tile)
    m = torch.zeros(B, nq * tile, nk * tile, dtype=torch.bool)
    m[:, :Tq, :Tk] = mask
    return m.reshape(B, nq, tile, nk, tile).any(4).any(2)


def _tile_segments(kind, seed, T):
    rs = np.random.RandomState(seed)
    if kind == "packed":
        _, seg = pack_documents(np.random.default_rng(seed), 3, T)
        return seg, seg
    # unsorted ids over a small alphabet, queries drawing from a larger one
    # (some rows then see no key)
    return (rs.randint(0, 5, (3, T)).astype(np.int32),
            rs.randint(0, 3, (3, T + 13)).astype(np.int32))


@pytest.mark.parametrize("kind,tile,T", [
    ("packed", 16, 256), ("packed", 64, 2048), ("packed", 16, 200),
    ("unsorted", 16, 200), ("unsorted", 8, 64)])
@pytest.mark.parametrize("seed", range(3))
def test_dead_tiles_are_fully_masked(kind, tile, T, seed):
    seg_q, seg_k = map(torch.tensor, _tile_segments(kind, seed, T))
    q = torch.zeros(seg_q.shape[0], seg_q.shape[1], 1, 1)
    k = torch.zeros(seg_k.shape[0], seg_k.shape[1], 1, 1)
    mask = fa._mask(q, k, seg_q, seg_k, False, None, 0)[:, 0]
    live = fa._live_tiles(seg_q, seg_k, tile)
    visible = _tile_any(mask, tile)
    assert live.shape == visible.shape
    assert not bool((visible & ~live).any())  # sound: dead => all masked
    if kind == "packed":
        # consecutive sorted ids: overlapping ranges share an id, so the
        # rule skips every all-masked tile, and (b)-like rows skip many
        assert torch.equal(live, visible)
        assert bool((~live).any())


# ------------------------------------------------- K1's tiled algorithm
#
# The bf16 tensor-core K1 (``csrc/flash_attention_fwd_sm90.cu``) runs an
# online softmax over the 64-key tiles of each 64-row q tile's band,
# skips the tiles that ``_live_tiles`` drops, keeps scores in base-2
# units and rounds P to V's dtype before P V. The emulation below does
# the same in torch ops, so the algorithm (the skip above all) is held
# against the plain version and the JAX kernel here, where the card
# is not.

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _band_tiles(q0, Tq, Tk, causal, window, q_offset, tile):
    """The key tiles [t0, t1) that query rows [q0, q0 + tile) can see
    (``key_tiles`` in ``csrc/flash_attention.cuh``)."""
    kbeg, kend = 0, Tk
    if causal:
        kend = min(Tk, min(q0 + tile, Tq) - 1 + q_offset + 1)
        if window is not None:
            kbeg = max(0, q0 + q_offset - window + 1)
    if kend <= kbeg:
        return 0, 0
    return kbeg // tile, -(-kend // tile)


def _k1_tiled(q, k, v, *, causal, scale, seg_q=None, seg_k=None,
              window=None, q_offset=0, tile=fa.TILE):
    """K1's algorithm, tile by tile: ``(O, LSE, (visited, skipped))``."""
    B, Tq, H, D = q.shape
    Tk, group = k.shape[1], H // k.shape[2]
    mask = fa._mask(q, k, seg_q, seg_k, causal, window, q_offset)
    if mask is None:
        mask = torch.ones(1, 1, Tq, Tk, dtype=torch.bool)
    mask = mask.expand(B, 1, Tq, Tk)[:, 0]
    nq, nk = -(-Tq // tile), -(-Tk // tile)
    live = (torch.ones(B, nq, nk, dtype=torch.bool) if seg_q is None
            else fa._live_tiles(seg_q, seg_k, tile))
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v, group, dim=2)
    out = torch.zeros(B, Tq, H, D)
    lse = torch.full((B, H, Tq), fa.NEG_INF)
    visited = skipped = 0
    for b in range(B):
        for qt in range(nq):
            rows = slice(qt * tile, min(qt * tile + tile, Tq))
            n = rows.stop - rows.start
            m = torch.full((H, n), fa.NEG_INF)
            l = torch.zeros(H, n)
            acc = torch.zeros(H, n, D)
            t0, t1 = _band_tiles(rows.start, Tq, Tk, causal, window,
                                 q_offset, tile)
            for t in range(t0, t1):
                if not live[b, qt, t]:
                    skipped += H
                    continue
                visited += H
                keys = slice(t * tile, min(t * tile + tile, Tk))
                s = torch.einsum("qhd,khd->hqk", q[b, rows].float(),
                                 kf[b, keys]) * (scale * LOG2E)
                ok = mask[b, rows, keys][None]
                s = torch.where(ok, s, torch.tensor(fa.NEG_INF))
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.where(ok, torch.exp2(s - mx[..., None]),
                                torch.tensor(0.0))
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "hqk,khd->hqd", p.to(v.dtype).float(),
                    vf[b, keys].float())
                m = mx
            alive = l > 0
            o = torch.where(alive[..., None], acc / l.clamp_min(1e-37)[
                ..., None], torch.tensor(0.0))
            out[b, rows] = o.transpose(0, 1)
            lse[b, :, rows] = torch.where(
                alive, m * LN2 + torch.log(l.clamp_min(1e-37)),
                torch.tensor(fa.NEG_INF))
    return out.to(q.dtype), lse, (visited, skipped)


def _k1_case(name):
    """(q, k, v, kwargs of the plain forward, JAX block sizes): B 2, 4 q
    heads over 2 kv heads, head dim 16, at T past two 64-row tiles."""
    rs = np.random.RandomState(sorted(K1_CASES).index(name))
    T, Tk, q_offset, window = 200, 200, 0, None
    seg_q = seg_k = None
    if name == "packed":
        _, seg_q = pack_documents(np.random.default_rng(5), B, T)
        seg_k = seg_q
    elif name == "unsorted":
        seg_q = seg_k = rs.randint(0, 3, (B, T)).astype(np.int32)
    elif name == "no-key-rows":  # the first 16 rows ask for a third id
        T, Tk, q_offset = 64, 192, 128
        seg_k = np.repeat((np.arange(Tk) >= Tk // 2)[None], B, 0)
        seg_k = seg_k.astype(np.int32)
        seg_q = np.ones((B, T), np.int32)
        seg_q[:, :16] = 7
    elif name == "window":
        window = 50
    elif name == "odd-T":
        T = Tk = 131
        _, seg_q = pack_documents(np.random.default_rng(6), B, T)
        seg_k = seg_q
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, Tk, 2, D).astype(np.float32)
    v = rs.randn(B, Tk, 2, D).astype(np.float32)
    kw = dict(causal=True, scale=D ** -0.5, window=window, q_offset=q_offset)
    seg = {} if seg_q is None else dict(seg_q=seg_q, seg_k=seg_k)
    return q, k, v, kw, seg


K1_CASES = ("packed", "unsorted", "no-key-rows", "window", "odd-T")


@pytest.mark.parametrize("name", K1_CASES)
def test_k1_tiled_algorithm_matches_plain_and_jax(name):
    """K1's tile loop with the skip equals the plain forward and the JAX
    kernel (interpret mode) at fp32, to ``FWD``."""
    q, k, v, kw, seg = _k1_case(name)
    tseg = {n: torch.tensor(s) for n, s in seg.items()}
    tq, tk, tv = map(torch.tensor, (q, k, v))
    out, lse, (visited, skipped) = _k1_tiled(tq, tk, tv, **kw, **tseg)
    want_o, want_lse = fa.flash_attention_fwd_reference(tq, tk, tv, **kw,
                                                        **tseg)
    torch.testing.assert_close(out, want_o, **FWD)
    torch.testing.assert_close(lse, want_lse, **FWD)
    jseg = ({} if not seg else dict(seg_q=jnp.asarray(seg["seg_q"]),
                                    seg_kv=jnp.asarray(seg["seg_k"])))
    jo, jlse = jax_block_fwd(*map(jnp.asarray, (q, k, v)), block_q=64,
                             block_k=64, interpret=True, **kw, **jseg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), **FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD)
    if name == "packed":
        assert skipped > 0  # the skip ran, and changed nothing
    if name == "no-key-rows":
        assert float(out[:, :16].abs().max()) == 0.0
        assert bool((lse[:, :, :16] == fa.NEG_INF).all())
        assert float(out[:, 16:].abs().max()) > 0.0


def test_k1_tiled_algorithm_in_bf16_stays_in_the_cards_tolerance():
    """In bf16, P rounded against the running max (the kernel) and
    against the row's max (the plain version) differ by a few bf16 ulps:
    inside the 2e-2 that ``chip_smoke.py`` holds the kernel to."""
    q, k, v, kw, seg = _k1_case("packed")
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    tseg = {n: torch.tensor(s) for n, s in seg.items()}
    out, lse, _ = _k1_tiled(tq, tk, tv, **kw, **tseg)
    want_o, want_lse = fa.flash_attention_fwd_reference(tq, tk, tv, **kw,
                                                        **tseg)
    assert out.dtype == want_o.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want_o.float(), rtol=0,
                               atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-2)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("name", K1_CASES)
def test_the_cards_per_entry_limit_holds_k1s_bf16_algorithm(name):
    """``chip_smoke.py`` also holds the card's bf16 O and LSE per entry
    (``ELEMENT_TOL`` at each entry's scale); K1's algorithm in bf16 stays
    inside it."""
    q, k, v, kw, seg = _k1_case(name)
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    tseg = {n: torch.tensor(s) for n, s in seg.items()}
    out, lse, _ = _k1_tiled(tq, tk, tv, **kw, **tseg)
    want = fa.flash_attention_fwd_reference(tq, tk, tv, **kw, **tseg)
    over = _smoke()._per_element_over_limit(out, lse, *want)
    assert all(x <= 1.0 for x in over.values()), over


@pytest.mark.parametrize("name", K1_CASES)
def test_the_cards_per_entry_limit_catches_a_softmax_scale_1pc_off(name):
    """A K1 whose softmax scale is 1% off stays inside 2e-2 x max(1,
    max |plain|) on O and LSE, and fails the per-entry limit."""
    q, k, v, kw, seg = _k1_case(name)
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    tseg = {n: torch.tensor(s) for n, s in seg.items()}
    out, lse, _ = _k1_tiled(tq, tk, tv, **dict(kw, scale=kw["scale"] * 1.01),
                            **tseg)
    ro, rl = fa.flash_attention_fwd_reference(tq, tk, tv, **kw, **tseg)
    for got, want in ((out, ro), (lse, rl)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, want.float().abs().max().item())
    over = _smoke()._per_element_over_limit(out, lse, ro, rl)
    assert max(over.values()) > 1.0, over


def test_tile_counts_reads_every_kernels_counters(monkeypatch):
    """``tile_counts()`` reads K1's counters (the forward's source) and
    K2's and K3's (the backward's) through their two C readers, each of
    which also resets its counters, and raises on a CUDA error."""
    calls = []

    class _Lib:
        @staticmethod
        def flash_fwd_tile_counts(out):
            calls.append("fwd")
            out[0], out[1] = 7, 3
            return 0

        @staticmethod
        def flash_bwd_tile_counts(out):
            calls.append("bwd")
            out[0], out[1], out[2], out[3] = 7, 3, 28, 12
            return 0

    monkeypatch.setattr(fa, "load_kernel", lambda: _Lib)
    assert fa.tile_counts() == {"fwd": (7, 3), "dq": (7, 3),
                                "dkv": (28, 12)}
    assert sorted(calls) == ["bwd", "fwd"]

    def failing(out):
        return 700

    monkeypatch.setattr(_Lib, "flash_fwd_tile_counts", staticmethod(failing))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa.tile_counts()


def test_the_library_lists_the_forward_kernels_source():
    """The flash library builds the bf16 forward's source too, every
    listed source and header exists, and the forward's source defines
    the kernel and the count reader the wrapper binds."""
    assert "flash_attention_fwd_sm90.cu" in fa.SOURCES
    assert len(set(fa.SOURCES)) == len(fa.SOURCES)
    for s in fa.SOURCES:
        assert (_build.CSRC_DIR / s).is_file(), s
    assert (_build.CSRC_DIR / "flash_attention_sm90.cuh").is_file()
    src = (_build.CSRC_DIR / "flash_attention_fwd_sm90.cu").read_text()
    for name in ("flash_fwd_mma_kernel", "flash_fwd_bf16",
                 'extern "C" int flash_fwd_tile_counts'):
        assert name in src, name


def test_bf16_forward_copies_rows_it_cannot_read():
    """The bf16 forward kernel copies rows 16 bytes at a time: the model's
    own layout (q/k/v views of one fused product) goes to it as it is,
    and an operand whose base or strides are off that grid is replaced by
    a contiguous copy with the same values before the launch."""
    B_, T, H_, D_ = 1, 8, 2, 32
    qkv = torch.randn(B_, T, 3 * H_ * D_).to(torch.bfloat16)
    q, k, v = (t.reshape(B_, T, H_, D_)
               for t in torch.split(qkv, H_ * D_, dim=-1))
    kw = dict(causal=True, scale=0.1, window=None, q_offset=0)
    p = fa._fwd_params(q, k, v, None, None, None, **kw)
    assert (p.q, p.k, p.v) == tuple(t.data_ptr() for t in (q, k, v))
    wide = torch.randn(B_, T, H_, D_ + 4).to(torch.bfloat16)
    off = wide[..., 4:]  # 8 bytes past the grid, strides off it too
    p = fa._fwd_params(q, off, off, None, None, None, **kw)
    copy_k, copy_v = p.keep_alive[1:3]
    for ptr, copy, strides in ((p.k, copy_k, (p.k_sb, p.k_st, p.k_sh)),
                               (p.v, copy_v, (p.v_sb, p.v_st, p.v_sh))):
        assert ptr == copy.data_ptr() != off.data_ptr()
        assert ptr % 16 == 0 and copy.is_contiguous()
        assert strides == copy.stride()[:3]
        assert torch.equal(copy, off)
    assert p.q == q.data_ptr()
    # fp32 goes to the CUDA-core K1, which reads any strides
    off32 = wide.float()[..., 4:]
    p = fa._fwd_params(off32, off32, off32, None, None, None, **kw)
    assert p.q == p.k == p.v == off32.data_ptr()
