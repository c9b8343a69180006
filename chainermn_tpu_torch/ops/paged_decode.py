"""Paged flash decoding: attention of ``T >= 1`` fresh query rows per slot
against the paged KV pool, one pass over the live blocks, no dense view
(counterpart of ``chainermn_tpu/ops/paged_decode.py::paged_flash_decode``).

Two versions of one function:

- :func:`paged_flash_decode` — the wrapper. On CUDA tensors it launches
  the hand-written Hopper kernel (``csrc/paged_decode.cu``, built by
  ``nvcc`` at first use) or raises; on CPU tensors, and only there, it
  computes the plain version below. :data:`LAUNCHES` counts the kernel's
  launches, so a run can show that its main path went through the kernel.
- :func:`paged_flash_decode_reference` — the plain PyTorch version:
  gather ``pool[tables]``, the same masks, the same P-to-V-dtype cast and
  the same zero-row rule. The CPU tests hold it against the JAX kernel
  and ``chip_smoke.py`` holds the CUDA kernel against it.

Left for later: ``dense_flash_decode`` (the dense ring through the same
kernel) and 5-D tensor-parallel stacked pools.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chainermn_tpu_torch.ops.attention import NEG_INF

#: Launches of the CUDA kernel in this process (the wrapper adds one per
#: launch and nowhere else; callers reset it to 0 before a counted run).
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_launch_fn = None


def load_kernel():
    """The kernel's C entry point, built by ``nvcc`` and bound on first
    use (raises when the library cannot be built)."""
    global _launch_fn
    if _launch_fn is None:
        from chainermn_tpu_torch.ops._build import load_library

        fn = load_library("paged_decode",
                          ["paged_decode.cu"]).paged_flash_decode_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p,        # q k v tables pos out
                       i, i, i, i, i, i, i,     # B T Hq Hkv D bs M
                       i, ctypes.c_float, i, i,  # window scale scratch dt
                       p]                       # stream
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _check_shapes(q, k_pool, v_pool, block_tables, positions, window):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [B, T, Hq, D] and pools [num_blocks, bs, Hkv, D]; "
            f"got {tuple(q.shape)} / {tuple(k_pool.shape)} (5-D "
            "tensor-parallel pools are not ported yet)")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} differ")
    B, T, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    if k_pool.shape[3] != D:
        raise ValueError(f"head_dim mismatch: q {D}, pool {k_pool.shape[3]}")
    if Hq % Hkv:
        raise ValueError(
            f"q heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or tuple(positions.shape) != (B,)):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / positions "
            f"{tuple(positions.shape)} must lead with q's batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def paged_flash_decode(q, k_pool, v_pool, block_tables, positions, *,
                       window: Optional[int] = None,
                       scale: Optional[float] = None,
                       scratch_block: Optional[int] = 0):
    """Attention of ``T >= 1`` fresh query rows per slot against a paged
    KV pool, the JAX signature and layout.

    Args:
      q: ``[B, T, Hq, D]`` query rows; row ``(b, t)`` sits at absolute
        position ``positions[b] + t``. The caller has already written the
        matching K/V into the pool (:func:`~chainermn_tpu_torch.ops.
        paged_kv.paged_update`).
      k_pool / v_pool: ``[num_blocks, bs, Hkv, D]``, q's dtype.
      block_tables: ``[B, max_blocks]`` int32 logical -> physical map.
      positions: ``[B]`` int32 first-new-token position per row.
      window: optional causal sliding-window width
        (``qpos - window < kpos <= qpos``).
      scale: score scale (default ``D ** -0.5``).
      scratch_block: physical block whose table entries are fully masked
        (the serving pool's block 0); ``None`` disables the mask.

    Returns ``[B, T, Hq, D]`` in q's dtype; fp32 accumulation inside.
    On CPU tensors this is :func:`paged_flash_decode_reference`; on CUDA
    tensors the kernel runs (bf16 or fp32, ``D`` in 32/64/128) or the
    call raises — there is no fallback.
    """
    _check_shapes(q, k_pool, v_pool, block_tables, positions, window)
    if q.device.type == "cpu":
        return paged_flash_decode_reference(
            q, k_pool, v_pool, block_tables, positions, window=window,
            scale=scale, scratch_block=scratch_block)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cuda or cpu tensors, "
                         f"got {q.device}")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_tables": block_tables, "positions": positions}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}/{v_pool.dtype}) must match "
                        f"q's dtype {q.dtype}")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("block_tables and positions must be int32")
    B, T, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {D}")
    for name in ("k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads K/V rows as 16-byte vectors)")
    scale = float(D ** -0.5 if scale is None else scale)
    out = torch.empty_like(q)
    err = load_kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, T, Hq, Hkv, D, bs, block_tables.shape[1],
        -1 if window is None else int(window), scale,
        -1 if scratch_block is None else int(scratch_block),
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged_flash_decode kernel launch failed: CUDA "
                           f"error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def paged_flash_decode_reference(q, k_pool, v_pool, block_tables,
                                 positions, *, window: Optional[int] = None,
                                 scale: Optional[float] = None,
                                 scratch_block: Optional[int] = 0):
    """The plain PyTorch version of :func:`paged_flash_decode`: the same
    masks and numerics over the gathered ``pool[tables]`` view, in one
    softmax pass instead of the kernel's online recurrence."""
    _check_shapes(q, k_pool, v_pool, block_tables, positions, window)
    B, T, Hq, D = q.shape
    _, bs, Hkv, _ = k_pool.shape
    M = block_tables.shape[1]
    group = Hq // Hkv
    scale = float(D ** -0.5 if scale is None else scale)
    dev = q.device
    tables = block_tables.long()
    pos0 = positions.long()

    # Whole-block liveness, as the kernel walks it: inside the rows'
    # causal/window band and not the scratch block (never read).
    j = torch.arange(M, device=dev)
    live = j[None] * bs <= (pos0 + T - 1)[:, None]  # [B, M]
    if window is not None:
        live &= (j[None] + 1) * bs - 1 > (pos0 - window)[:, None]
    if scratch_block is not None:
        live &= tables != scratch_block
    live = live[:, :, None].expand(B, M, bs).reshape(B, M * bs)

    keys = k_pool[tables].reshape(B, M * bs, Hkv, D).float()
    vals = v_pool[tables].reshape(B, M * bs, Hkv, D)
    vals = torch.where(live[:, :, None, None], vals, torch.zeros_like(vals))

    kpos = torch.arange(M * bs, device=dev)
    qpos = pos0[:, None] + torch.arange(T, device=dev)[None]  # [B, T]
    mask = live[:, None, :] & (kpos[None, None] <= qpos[:, :, None])
    if window is not None:
        mask &= kpos[None, None] > qpos[:, :, None] - window
    mask = mask[:, :, None, None, :]  # [B, T, 1, 1, L]

    qg = q.float().reshape(B, T, Hkv, group, D)
    s = torch.einsum("btngd,blnd->btngl", qg, keys) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("btngl,blnd->btngd", p.to(vals.dtype).float(),
                       vals.float())
    out = torch.where(l > 0, acc / l.clamp_min(1e-37),
                      torch.zeros_like(acc))
    return out.reshape(B, T, Hq, D).to(q.dtype)
