"""The port's flash attention (plain versions of K1–K3, the autograd
function, the block entries) against the JAX package's Pallas kernels,
which run in interpret mode exactly as ``tests/test_ops.py`` runs them.

The same numpy inputs go to both sides at fp32. Tolerances are those of
``tests/test_ops.py``: 1e-5 on the forward (O, LSE), 1e-4 on gradients
(both relative and absolute), since the two sides sum in other orders and
the port's plain version takes one softmax pass where the kernels take
the online recurrence.

Two rules the bf16 CUDA backward relies on are held here on the CPU too:
a masked entry gives p = 0, so rows that see no key get exact zero
gradients; and the segment tile skip drops only fully masked tiles.
"""

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
# The segment-aware tile skip of the bf16 backward kernels (``_live_tiles``,
# the rule the CUDA kernels apply on the card): a (q tile, k tile) pair it
# marks dead holds no visible (query, key) pair, for packed documents and
# for unsorted segment ids alike, so skipping it changes no gradient.

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
