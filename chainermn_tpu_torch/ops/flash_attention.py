"""Flash attention, forward and backward (counterpart of
``chainermn_tpu/ops/flash_attention.py``).

Three hand-written Hopper kernels, built by ``nvcc`` at first use into
one library from :data:`SOURCES`:

- K1 ``fwd``: the forward (``_flash_fwd_bhtd``): online softmax, O and the
  per-row logsumexp (LSE);
- K2 ``dq``: the backward's dq (``_bwd_dq_body``), P re-derived from LSE;
- K3 ``dkv``: the backward's dk/dv (``_bwd_dkv_body``), with the optional
  full dbias.

The input dtype picks the kernel: fp32 runs all three on CUDA cores
(``csrc/flash_attention.cu``); bf16 runs all three on tensor cores with
a segment-aware tile skip, K1 from ``csrc/flash_attention_fwd_sm90.cu``
and K2/K3 from ``csrc/flash_attention_bwd_sm90.cu`` (the rule in
:func:`_live_tiles`; :func:`tile_counts` reads what the kernels visited
and skipped). A masked (query, key) entry gives ``p = 0`` in the forward
and the backward, also on a row that sees no key, so the answer does not
depend on which tiles a kernel visits.

Each kernel has a wrapper and a plain PyTorch version in this module. On
CUDA tensors a wrapper launches its kernel or raises; on CPU tensors, and
only there, it computes the plain version
(:func:`flash_attention_fwd_reference`,
:func:`flash_attention_bwd_reference`), which materialises the masked
score matrix with the same casts and zero-row rules. :data:`LAUNCHES`
counts each kernel's launches. :class:`_FlashCore` (the JAX
``custom_vjp``'s role) joins them for autograd.

Layout: BTHD at every public function, as in the JAX package. The
kernels address BTHD through strides, so nothing is transposed; LSE and
delta rows are ``[B, H, Tq]``.

Left for later: nothing of the JAX module's surface except ``interpret``,
which has no meaning here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chainermn_tpu_torch.ops.attention import NEG_INF, _acc_dtype

#: Launches of each CUDA kernel in this process (each wrapper adds one
#: per launch and nowhere else; callers reset them before a counted run).
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
#: Inputs the bf16 wrappers copied onto the kernels' 16-byte grid (a view
#: whose base or strides are off it, :func:`_on_16_bytes`)
OFF_GRID_COPIES = {"copies": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
#: the library's sources under ``csrc/``, compiled together
SOURCES = ("flash_attention.cu", "flash_attention_fwd_sm90.cu",
           "flash_attention_bwd_sm90.cu")
#: the kernels' tile: rows of a q tile and keys of a k tile
TILE = 64
_lib = None


class _Params(ctypes.Structure):
    """Mirror of ``FlashParams`` in ``csrc/flash_attention.cuh`` (same
    field order; pointers, then 64-bit strides, then ints, then the
    scale)."""

    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "dout", "seg_q", "seg_k", "bias", "lse", "delta",
        "out", "lse_out", "dq", "dk", "dv", "dbias")] + [
        (n, ctypes.c_int64) for n in (
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh", "v_sb", "v_st",
            "v_sh", "do_sb", "do_st", "do_sh", "segq_sb", "segk_sb",
            "bias_sb", "bias_sh", "bias_sq", "bias_sk")] + [
        (n, ctypes.c_int) for n in (
            "B", "Tq", "Tk", "H", "Hkv", "D", "causal", "window",
            "q_offset", "dtype")] + [("scale", ctypes.c_float)]


def load_kernel():
    """The library's C entry points (three launches and the two
    tile-count readers), built by ``nvcc`` and bound on first use (raises
    when the library cannot be built)."""
    global _lib
    if _lib is None:
        from chainermn_tpu_torch.ops._build import load_library

        lib = load_library("flash_attention", SOURCES)
        for name in ("flash_fwd_launch", "flash_dq_launch",
                     "flash_dkv_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("flash_fwd_tile_counts", "flash_bwd_tile_counts"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def tile_counts():
    """``{"fwd": (visited, skipped), "dq": ..., "dkv": ...}``: the
    (q tile, k tile, q head) triples of the causal/window band that the
    bf16 K1, K2 and K3 visited and skipped by segment ranges since the
    last call, as the kernels counted them on the current card; resets
    all three. Waits for the card."""
    lib = load_kernel()
    fwd = (ctypes.c_ulonglong * 2)()
    bwd = (ctypes.c_ulonglong * 4)()
    for reader, out in ((lib.flash_fwd_tile_counts, fwd),
                        (lib.flash_bwd_tile_counts, bwd)):
        err = reader(out)
        if err != 0:
            raise RuntimeError(f"reading the tile counts failed: CUDA "
                               f"error {err}")
    return {"fwd": (fwd[0], fwd[1]), "dq": (bwd[0], bwd[1]),
            "dkv": (bwd[2], bwd[3])}


# ---------------------------------------------------------------- checks

def _check(q, k, v, seg_q, seg_k, bias, causal, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, T, H, D]; got "
                         f"{tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, Tq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[{B}, Tk, Hkv, {D}]")
    if H % k.shape[2]:
        raise ValueError(f"q heads ({H}) must be a multiple of kv heads "
                         f"({k.shape[2]})")
    for name, s, T in (("seg_q", seg_q, Tq), ("seg_k", seg_k, k.shape[1])):
        if s is not None and tuple(s.shape) != (B, T):
            raise ValueError(f"{name} must be [{B}, {T}], got "
                             f"{tuple(s.shape)}")
    if (seg_q is None) != (seg_k is None):
        raise ValueError("pass both segment-id arrays or neither")
    if bias is not None and (
            bias.dim() != 4 or bias.shape[0] not in (1, B)
            or bias.shape[1] not in (1, H) or bias.shape[2] != Tq
            or bias.shape[3] != k.shape[1]):
        raise ValueError(f"bias must be [B|1, H|1, Tq, Tk] = [{B}|1, {H}|1, "
                         f"{Tq}, {k.shape[1]}], got {tuple(bias.shape)}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (the sliding "
                             "window is defined over past positions)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _mask(q, k, seg_q, seg_k, causal, window, q_offset):
    """``[B|1, 1, Tq, Tk]`` bool mask of visible (query, key) pairs, or
    None when every pair is visible."""
    Tq, Tk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        qp = q_offset + torch.arange(Tq, device=q.device)[:, None]
        kp = torch.arange(Tk, device=q.device)[None, :]
        mask = qp >= kp
        if window is not None:
            mask &= qp - kp < window
        mask = mask[None, None]
    if seg_q is not None:
        sm = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
        mask = sm if mask is None else mask & sm
    return mask


def _scores(q, k, scale, bias, mask):
    """fp32 (fp64 for fp64 inputs) masked scores ``[B, H, Tq, Tk]``, the
    q-head group sharing each kv head."""
    acc = _acc_dtype(q)
    group = q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k.to(acc), group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kf) * scale
    if bias is not None:
        s = s + bias.to(acc)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


# ---------------------------------------------------------------- plain

def flash_attention_fwd_reference(q, k, v, *, causal: bool, scale: float,
                                  seg_q=None, seg_k=None, bias=None,
                                  window: Optional[int] = None,
                                  q_offset: int = 0):
    """The plain version of K1: ``(O [B, Tq, H, D] in q's dtype, LSE
    [B, H, Tq] fp32)``. One softmax pass over the materialised masked
    scores, with the kernel's rules: masked scores NEG_INF, ``p = mask ?
    exp(s - m) : 0``, P rounded to V's dtype before PV, O = 0 and
    LSE = NEG_INF where the row sum is 0."""
    _check(q, k, v, seg_q, seg_k, bias, causal, window, q_offset)
    acc = _acc_dtype(q)
    mask = _mask(q, k, seg_q, seg_k, causal, window, q_offset)
    s = _scores(q, k, scale, bias, mask)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    group = q.shape[2] // k.shape[2]
    vf = torch.repeat_interleave(v, group, dim=2).to(acc)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc), vf)
    live = l > 0
    o = torch.where(live, o / l.clamp_min(1e-37), torch.zeros_like(o))
    lse = torch.where(live, m + torch.log(l.clamp_min(1e-37)),
                      torch.full_like(m, NEG_INF))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def flash_attention_bwd_reference(q, k, v, do, lse, delta, *, causal: bool,
                                  scale: float, seg_q=None, seg_k=None,
                                  bias=None, bias_grad: bool = False,
                                  window: Optional[int] = None,
                                  q_offset: int = 0):
    """The plain version of K2 and K3: ``(dq, dk, dv[, dbias])`` in fp32
    (fp64 for fp64 inputs), BTHD, dk/dv summed over each kv head's group;
    ``dbias`` reduced to the bias's broadcast shape.

    The kernels' rules: ``p = mask ? exp(s - lse) : 0`` from the saved
    LSE, so a masked entry contributes nothing, also on a row that saw no
    key (LSE = NEG_INF, where ``exp(s - lse)`` alone would be 1): such a
    row gets dq = 0 and adds nothing to dk, dv or dbias, the gradient of
    the forward's constant O = 0. ``ds = p * (dp - delta)``; dbias is
    ``ds`` before the scale; ``ds * scale`` is rounded to k's dtype for dq
    and to q's dtype for dk; ``dv = p^T dO`` from the fp32 p (the bf16
    tensor-core K3 rounds P to bf16 there, about 2^-9 per term)."""
    _check(q, k, v, seg_q, seg_k, bias, causal, window, q_offset)
    if bias_grad and bias is None:
        raise ValueError("bias_grad=True without a bias")
    acc = _acc_dtype(q)
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    mask = _mask(q, k, seg_q, seg_k, causal, window, q_offset)
    s = _scores(q, k, scale, bias, mask)
    p = torch.exp(s - lse.to(acc)[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dof = do.to(acc)
    vf = torch.repeat_interleave(v.to(acc), group, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds_un = p * (dp - delta.to(acc)[..., None])
    ds = ds_un * scale
    kf = torch.repeat_interleave(k.to(acc), group, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc), kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc), q.to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Tk, Hkv, group, D).sum(3)
    dv = dv.reshape(B, Tk, Hkv, group, D).sum(3)
    if not bias_grad:
        return dq, dk, dv
    dbias = ds_un
    if bias.shape[1] == 1:
        dbias = dbias.sum(1, keepdim=True)
    if bias.shape[0] == 1:
        dbias = dbias.sum(0, keepdim=True)
    return dq, dk, dv, dbias


def _live_tiles(seg_q, seg_k, tile: int = TILE):
    """``[B, nq, nk]`` bool: the (q tile, k tile) pairs whose segment-id
    ranges overlap, the rule by which the bf16 K1-K3 skip a tile pair
    before loading it (ragged tail tiles reduce over their in-range ids).
    A pair marked False holds no equal ids, so its mask is all False,
    whatever the ids' order. Not on the main path: tests check the rule
    with it, and ``chip_smoke.py`` holds the kernels' own counts
    (:func:`tile_counts`) against it."""

    def ranges(seg):
        B, T = seg.shape
        n = -(-T // tile)
        info = torch.iinfo(seg.dtype)
        pad = n * tile - T
        lo = torch.nn.functional.pad(seg, (0, pad), value=info.max)
        hi = torch.nn.functional.pad(seg, (0, pad), value=info.min)
        return (lo.reshape(B, n, tile).amin(-1),
                hi.reshape(B, n, tile).amax(-1))

    qlo, qhi = ranges(seg_q)
    klo, khi = ranges(seg_k)
    return ((qlo[:, :, None] <= khi[:, None, :])
            & (klo[:, None, :] <= qhi[:, :, None]))


# ---------------------------------------------------------------- kernels

def _params(q, k, v, seg_q, seg_k, bias, *, causal, scale, window,
            q_offset):
    """The kernel-call record for one shape; checks what the kernels
    take (device, dtypes, strides, head dim) and raises on the rest."""
    for name, t in (("k", k), ("v", v), ("seg_q", seg_q), ("seg_k", seg_k),
                    ("bias", bias)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k ({k.dtype}) and v ({v.dtype}) must match q's "
                        f"dtype {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit stride over head_dim")
    B, Tq, H, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    p = _Params()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.q_sb, p.q_st, p.q_sh = q.stride(0), q.stride(1), q.stride(2)
    p.k_sb, p.k_st, p.k_sh = k.stride(0), k.stride(1), k.stride(2)
    p.v_sb, p.v_st, p.v_sh = v.stride(0), v.stride(1), v.stride(2)
    if seg_q is not None:
        for name, s in (("seg_q", seg_q), ("seg_k", seg_k)):
            if s.dtype != torch.int32 or s.stride(1) != 1:
                raise TypeError(f"{name} must be int32 with unit stride "
                                "over T")
        p.seg_q, p.seg_k = seg_q.data_ptr(), seg_k.data_ptr()
        p.segq_sb, p.segk_sb = seg_q.stride(0), seg_k.stride(0)
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError("the kernels read a float32 bias")
        p.bias = bias.data_ptr()
        # size-1 batch/head dims broadcast through a zero stride
        p.bias_sb = 0 if bias.shape[0] == 1 else bias.stride(0)
        p.bias_sh = 0 if bias.shape[1] == 1 else bias.stride(1)
        p.bias_sq, p.bias_sk = bias.stride(2), bias.stride(3)
    p.B, p.Tq, p.Tk, p.H, p.Hkv, p.D = B, Tq, k.shape[1], H, k.shape[2], D
    p.causal = int(bool(causal))
    p.window = -1 if window is None else int(window)
    p.q_offset = int(q_offset)
    p.dtype = _DTYPE_CODES[q.dtype]
    p.scale = float(scale)
    return p


def _launch(name, p, device):
    if p.B * p.H * (p.Tk if name == "dkv" else p.Tq) == 0:
        return  # an empty grid: nothing to compute, no kernel launched
    err = getattr(load_kernel(), f"flash_{name}_launch")(
        ctypes.byref(p), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash-attention {name} kernel launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[name] += 1


def _device_kind(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got "
                         f"{q.device}")
    return q.device.type


def _f32(t):
    return None if t is None else t.to(torch.float32)


def flash_fwd(q, k, v, *, causal: bool, scale: float, seg_q=None,
              seg_k=None, bias=None, window: Optional[int] = None,
              q_offset: int = 0):
    """K1's wrapper: ``(O [B, Tq, H, D], LSE [B, H, Tq] fp32)``. CPU
    tensors take :func:`flash_attention_fwd_reference`; CUDA tensors
    launch the kernel or raise."""
    _check(q, k, v, seg_q, seg_k, bias, causal, window, q_offset)
    if _device_kind(q) == "cpu":
        return flash_attention_fwd_reference(
            q, k, v, causal=causal, scale=scale, seg_q=seg_q, seg_k=seg_k,
            bias=bias, window=window, q_offset=q_offset)
    p = _fwd_params(q, k, v, seg_q, seg_k, bias, causal=causal, scale=scale,
                    window=window, q_offset=q_offset)
    B, Tq, H, D = q.shape
    out = torch.empty(B, Tq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    p.out, p.lse_out = out.data_ptr(), lse.data_ptr()
    _launch("fwd", p, q.device)
    return out, lse


def _on_16_bytes(t):
    """``t``, or a contiguous copy of it where its base or its batch,
    token or head stride is off the 16-byte grid on which the bf16
    kernels copy rows (the model's own q/k/v views are on it); each copy
    adds one to ``OFF_GRID_COPIES``."""
    if t.data_ptr() % 16 or any(t.stride(i) * t.element_size() % 16
                                for i in range(3)):
        OFF_GRID_COPIES["copies"] += 1
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _fwd_params(q, k, v, seg_q, seg_k, bias, *, causal, scale, window,
                q_offset):
    """The kernel-call record of K1, checked; in bf16, q, k and v on the
    kernel's 16-byte grid."""
    if q.dtype == torch.bfloat16:
        q, k, v = map(_on_16_bytes, (q, k, v))
    bias = _f32(bias)
    p = _params(q, k, v, seg_q, seg_k, bias, causal=causal, scale=scale,
                window=window, q_offset=q_offset)
    # the converted inputs must outlive the launch that reads them
    p.keep_alive = (q, k, v, bias)
    return p


def _bwd_params(q, k, v, do, lse, delta, *, causal, scale, seg_q, seg_k,
                bias, window, q_offset):
    """The kernel-call record of K2/K3, checked; lse/delta as contiguous
    fp32; in bf16, q, k, v and dO on the kernels' 16-byte grid."""
    if q.dtype == torch.bfloat16:
        q, k, v, do = map(_on_16_bytes, (q, k, v, do))
    bias = _f32(bias)
    p = _params(q, k, v, seg_q, seg_k, bias, causal=causal, scale=scale,
                window=window, q_offset=q_offset)
    if do.dtype != q.dtype or do.stride(3) != 1 or do.device != q.device:
        raise TypeError("do must be on q's device, in q's dtype, with a unit "
                        "stride over head_dim")
    lse = lse.to(torch.float32).contiguous()
    delta = delta.to(torch.float32).contiguous()
    p.dout = do.data_ptr()
    p.do_sb, p.do_st, p.do_sh = do.stride(0), do.stride(1), do.stride(2)
    p.lse, p.delta = lse.data_ptr(), delta.data_ptr()
    # the converted inputs must outlive the launch that reads them
    p.keep_alive = (q, k, v, do, lse, delta, bias)
    return p


def _check_bwd(q, k, v, do, lse, delta, seg_q, seg_k, bias, bias_grad,
               causal, window, q_offset):
    _check(q, k, v, seg_q, seg_k, bias, causal, window, q_offset)
    if bias_grad and bias is None:
        raise ValueError("bias_grad=True without a bias")
    B, Tq, H, _ = q.shape
    if do.shape != q.shape or tuple(lse.shape) != (B, H, Tq) \
            or tuple(delta.shape) != (B, H, Tq):
        raise ValueError(f"do must be q's shape and lse/delta [{B}, {H}, "
                         f"{Tq}]; got {tuple(do.shape)} / "
                         f"{tuple(lse.shape)} / {tuple(delta.shape)}")
    return _device_kind(q)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                 seg_q=None, seg_k=None, bias=None,
                 window: Optional[int] = None, q_offset: int = 0):
    """K2's wrapper: dq fp32 ``[B, Tq, H, D]`` given the saved ``lse`` and
    ``delta = rowsum(dO * O)`` (both ``[B, H, Tq]``). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    kw = dict(causal=causal, scale=scale, seg_q=seg_q, seg_k=seg_k,
              bias=bias, window=window, q_offset=q_offset)
    if _check_bwd(q, k, v, do, lse, delta, seg_q, seg_k, bias, False, causal,
                  window, q_offset) == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             **kw)[0]
    p = _bwd_params(q, k, v, do, lse, delta, **kw)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    p.dq = dq.data_ptr()
    _launch("dq", p, q.device)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  seg_q=None, seg_k=None, bias=None, bias_grad: bool = False,
                  window: Optional[int] = None, q_offset: int = 0):
    """K3's wrapper: ``(dk, dv[, dbias])`` fp32, dk/dv ``[B, Tk, Hkv, D]``
    summed over each kv head's group, dbias reduced to the bias's
    broadcast shape. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    kw = dict(causal=causal, scale=scale, seg_q=seg_q, seg_k=seg_k,
              bias=bias, window=window, q_offset=q_offset)
    if _check_bwd(q, k, v, do, lse, delta, seg_q, seg_k, bias, bias_grad,
                  causal, window, q_offset) == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             bias_grad=bias_grad, **kw)[1:]
    p = _bwd_params(q, k, v, do, lse, delta, **kw)
    B, Tq, H, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, **f32)
    dv = torch.empty(v.shape, **f32)
    p.dk, p.dv = dk.data_ptr(), dv.data_ptr()
    if not bias_grad:
        _launch("dkv", p, q.device)
        return dk, dv
    # every (q, k) entry is written by K3: zeros on tiles no query of the
    # band reaches, as the TPU kernel writes them
    dbias = torch.empty(B, H, Tq, k.shape[1], **f32)
    p.dbias = dbias.data_ptr()
    _launch("dkv", p, q.device)
    if bias.shape[1] == 1:
        dbias = dbias.sum(1, keepdim=True)
    if bias.shape[0] == 1:
        dbias = dbias.sum(0, keepdim=True)
    return dk, dv, dbias


def flash_bwd(q, k, v, do, lse, delta, *, causal: bool, scale: float,
              seg_q=None, seg_k=None, bias=None, bias_grad: bool = False,
              window: Optional[int] = None, q_offset: int = 0):
    """The backward: ``(dq, dk, dv[, dbias])`` fp32, BTHD — K2 then K3 on
    CUDA tensors, :func:`flash_attention_bwd_reference` on CPU tensors."""
    kw = dict(causal=causal, scale=scale, seg_q=seg_q, seg_k=seg_k,
              bias=bias, window=window, q_offset=q_offset)
    if _check_bwd(q, k, v, do, lse, delta, seg_q, seg_k, bias, bias_grad,
                  causal, window, q_offset) == "cpu":
        return flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                             bias_grad=bias_grad, **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, bias_grad=bias_grad,
                               **kw))


# ---------------------------------------------------------------- autograd

class _FlashCore(torch.autograd.Function):
    """The JAX ``_flash_core`` custom_vjp: K1 forward; K2 + K3 backward
    from the saved (q, k, v, seg, bias, O, LSE). The bias gets a zero
    gradient unless ``bias_grad``; segment ids get none."""

    @staticmethod
    def forward(ctx, q, k, v, seg, bias, causal, scale, bias_grad, window):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale, seg_q=seg,
                             seg_k=seg, bias=bias, window=window)
        ctx.save_for_backward(q, k, v, seg, bias, out, lse)
        ctx.opts = (causal, scale, bias_grad, window)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg, bias, out, lse = ctx.saved_tensors
        causal, scale, bias_grad, window = ctx.opts
        g = g.to(q.dtype)
        # delta_i = sum_d dO_i * O_i: the rowwise correction term of the
        # flash backward, in fp32 from the output as stored (q's dtype).
        acc = _acc_dtype(q)
        delta = (g.to(acc) * out.to(acc)).sum(-1).transpose(1, 2)
        res = flash_bwd(q, k, v, g, lse, delta, causal=causal, scale=scale,
                        seg_q=seg, seg_k=seg, bias=bias, bias_grad=bias_grad,
                        window=window)
        dq, dk, dv = res[:3]
        dbias = None
        if bias is not None:
            dbias = (res[3].to(bias.dtype) if bias_grad
                     else torch.zeros_like(bias))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, dbias,
                None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, segment_ids=None,
                    bias=None, bias_grad: bool = False,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 1024):
    """Flash attention on ``[B, T, H, D]`` inputs, differentiable, the
    JAX signature and validation.

    ``k``/``v`` may carry fewer heads than ``q`` (GQA/MQA). ``segment_ids``
    (``[B, T]`` int) confines attention to equal ids (packed documents;
    composes with ``causal``). ``bias`` (``[B|1, H|1, Tq, Tk]``) is added
    after the scale and before the mask; it gets a zero gradient unless
    ``bias_grad=True``, which materialises the full fp32
    ``[B, H, Tq, Tk]`` gradient before reducing it to the bias's shape.
    ``window`` is a causal sliding window (``i - window < j <= i``).

    ``block_q``/``block_k`` are accepted for signature parity and not
    used: the card's tiles are the kernels' own (64 x 64), and ragged
    tails are masked, so any T runs.
    """
    del block_q, block_k
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias_grad and bias is None:
        raise ValueError("bias_grad=True without a bias")
    return _FlashCore.apply(q, k, v, _seg(segment_ids), bias, causal,
                            float(scale), bias_grad, window)


def _seg(s):
    """Segment ids as the kernels read them: contiguous int32."""
    return None if s is None else s.to(torch.int32).contiguous()


# ---------------------------------------------------------------- blocks

def flash_block_fwd(q, k_blk, v_blk, *, causal: bool, scale: float,
                    block_q: int = 512, block_k: int = 1024, seg_q=None,
                    seg_kv=None, window: Optional[int] = None,
                    q_offset: int = 0):
    """One ring step's forward: flash over the resident Q shard and ONE
    K/V block; BTHD output and ``[B, H, Tq]`` LSE (partials merge in log
    space). ``q_offset`` is the Q shard's global start against the block's
    key axis. ``block_q``/``block_k`` are accepted for parity."""
    del block_q, block_k
    return flash_fwd(q, k_blk, v_blk, causal=causal, scale=scale,
                     seg_q=_seg(seg_q), seg_k=_seg(seg_kv), window=window,
                     q_offset=q_offset)


def flash_block_bwd(q, k_blk, v_blk, do, lse, delta, *, causal: bool,
                    scale: float, block_q: int = 512, block_k: int = 1024,
                    seg_q=None, seg_kv=None, window: Optional[int] = None,
                    q_offset: int = 0):
    """One ring step's backward: ``(dq, dk_blk, dv_blk)`` fp32 BTHD for
    one K/V block, given ``lse``/``delta`` as ``[B, H, Tq]``."""
    del block_q, block_k
    return flash_bwd(q, k_blk, v_blk, do, lse, delta, causal=causal,
                     scale=scale, seg_q=_seg(seg_q), seg_k=_seg(seg_kv),
                     window=window, q_offset=q_offset)
