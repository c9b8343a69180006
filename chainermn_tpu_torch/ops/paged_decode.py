"""Paged flash decoding: attention of ``T >= 1`` fresh query rows per slot
against the paged KV pool, one pass over the live blocks, no dense view
(counterpart of ``chainermn_tpu/ops/paged_decode.py::paged_flash_decode``).

Two versions of one function:

- :func:`paged_flash_decode` — the wrapper. On CUDA tensors it launches
  a hand-written Hopper kernel (the ``paged_decode`` library, built by
  ``nvcc`` from :data:`SOURCES` at first use) or raises; on CPU tensors,
  and only there, it computes the plain version below. The CUDA call
  takes one of three routes, chosen by dtype and shape alone
  (:func:`_route`):

  - ``"split"`` — bf16 with ``R = T * (Hq / Hkv) <= 16`` query rows per
    (slot, kv head), every decode tick of serving:
    ``paged_decode_split_kernel`` (split-K over the block table, a
    cp.async ring of bf16 tiles) and ``paged_decode_merge_kernel`` (the
    splits merged in a fixed order), ``csrc/paged_decode_sm90.cu``; the
    splits come from :func:`_split_plan`;
  - ``"mma"`` — bf16 with ``R > 16``, every prefill of serving:
    ``paged_prefill_mma_kernel``, ``csrc/paged_prefill_sm90.cu`` (64-row
    q tiles on the tensor cores, K/V tiles gathered through the block
    table); it counts the key tiles it visits on the card
    (:func:`paged_prefill_tile_counts`, the rule
    :func:`_prefill_live_tiles`);
  - ``"rows"`` — fp32: ``paged_decode_kernel``, ``csrc/paged_decode.cu``.

  :data:`LAUNCHES` counts the wrapper's calls on CUDA (one per call,
  whatever the route) and :data:`ROUTE_LAUNCHES` the calls of each
  route, so a run can show that its main path went through the kernels
  and which design served which calls.
- :func:`paged_flash_decode_reference` — the plain PyTorch version:
  gather ``pool[tables]``, the same masks, the same P-to-V-dtype cast and
  the same zero-row rule. The CPU tests hold it against the JAX kernel
  and ``chip_smoke.py`` holds the CUDA kernels against it.
- :func:`dense_flash_decode` — the dense slot cache ``[Bc, L, Hkv, D]``
  through the same kernels: a zero-copy view as ``L / bs`` blocks per
  row (``bs = _pick_block(128, L)``), an identity block table and no
  scratch block. :data:`DENSE_LAUNCHES` counts its calls on CUDA.
- The 5-D tensor-parallel stacked entry of both versions: pools ``[S,
  num_blocks, bs, Hkv_local, D]`` and ``q`` ``[S, B, T, Hq_local, D]``,
  the tables and positions shared across the stack — one 4-D call per
  shard into its slice of one output, as the JAX entry unrolls its
  per-shard calls. :data:`STACKED_LAUNCHES` counts its calls on CUDA;
  each shard's call is one of :data:`LAUNCHES`, on its route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from chainermn_tpu_torch.ops.attention import NEG_INF

#: Calls of the wrapper on CUDA tensors in this process: one per call,
#: whatever the route and however many kernels it runs (the wrapper adds
#: it where it launches and nowhere else; :func:`reset_launches` zeroes
#: it with :data:`ROUTE_LAUNCHES` before a counted run).
LAUNCHES = 0
#: the same calls by route (:func:`_route`)
ROUTE_LAUNCHES = {"split": 0, "mma": 0, "rows": 0}
#: calls of :func:`dense_flash_decode` on CUDA tensors (each is also one
#: of :data:`LAUNCHES`)
DENSE_LAUNCHES = 0
#: calls of the 5-D stacked entry on CUDA tensors (each adds one call per
#: shard to :data:`LAUNCHES`)
STACKED_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128)
#: the library's sources under ``csrc/``, compiled together
SOURCES = ("paged_decode.cu", "paged_decode_sm90.cu",
           "paged_prefill_sm90.cu")
#: query rows per (slot, kv head) up to which bf16 calls take the split
#: route (the split kernel's q tile: 1, 2, 4, 8 or 16 rows)
SPLIT_MAX_ROWS = 16
#: :func:`_split_plan`'s aim: this many CTAs over the card (about eight
#: per SM of an H100), with no split under this many keys
SPLIT_TARGET_CTAS = 1024
SPLIT_MIN_KEYS = 128
#: rows of the prefill kernel's q tile and keys of its K/V tile
PREFILL_TILE = 64
_lib = None


def reset_launches():
    """Zero :data:`LAUNCHES`, :data:`ROUTE_LAUNCHES`,
    :data:`DENSE_LAUNCHES` and :data:`STACKED_LAUNCHES`."""
    global LAUNCHES, DENSE_LAUNCHES, STACKED_LAUNCHES
    LAUNCHES = 0
    DENSE_LAUNCHES = 0
    STACKED_LAUNCHES = 0
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] = 0


def load_kernel():
    """The library's C entry points (``paged_flash_decode_launch``, the
    rows route, fp32 only; ``paged_flash_decode_split_launch``, the split
    route; ``paged_flash_prefill_launch``, the mma route, and its
    counters' reader ``paged_prefill_tile_counts``), built by ``nvcc``
    and bound on first use (raises when the library cannot be built)."""
    global _lib
    if _lib is None:
        from chainermn_tpu_torch.ops._build import load_library

        _lib = _bind(load_library("paged_decode", SOURCES))
    return _lib


def _bind(lib):
    """``lib`` with the C entry points' signatures set: the port's library,
    or a build of the same sources with other defines."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_flash_decode_launch.argtypes = [
        p, p, p, p, p, p,        # q k v tables pos out
        i, i, i, i, i, i, i,     # B T Hq Hkv D bs M
        i, f, i,                 # window scale scratch
        p]                       # stream
    lib.paged_flash_decode_split_launch.argtypes = [
        p, p, p, p, p, p, p,     # q k v tables pos out partials
        i, i, i, i, i, i, i,     # B T Hq Hkv D bs M
        i, i,                    # P n_splits
        i, f, i,                 # window scale scratch
        p]                       # stream
    lib.paged_flash_prefill_launch.argtypes = [
        p, p, p, p, p, p,        # q k v tables pos out
        i, i, i, i, i, i, i,     # B T Hq Hkv D bs M
        i, f, i,                 # window scale scratch
        p]                       # stream
    lib.paged_prefill_tile_counts.argtypes = [p]
    for fn in (lib.paged_flash_decode_launch,
               lib.paged_flash_decode_split_launch,
               lib.paged_flash_prefill_launch,
               lib.paged_prefill_tile_counts):
        fn.restype = ctypes.c_int
    return lib


def _route(dtype, T, Hq, Hkv) -> str:
    """``"rows"`` for fp32; for bf16, ``"split"`` for calls of at most
    :data:`SPLIT_MAX_ROWS` query rows per (slot, kv head) and ``"mma"``
    for more: dtype and shape decide, never a failure."""
    if dtype != torch.bfloat16:
        return "rows"
    return "split" if T * (Hq // Hkv) <= SPLIT_MAX_ROWS else "mma"


def _split_plan(B: int, Hkv: int, M: int, bs: int):
    """``(P, n_splits)``: split ``s`` covers logical blocks ``[s * P,
    (s + 1) * P)`` of a row's table, ``n_splits = ceil(M / P)``. The
    fewest splits that put :data:`SPLIT_TARGET_CTAS` CTAs (one per
    split, kv head and slot) on the card, with at least
    :data:`SPLIT_MIN_KEYS` keys a split where the table has them. Shapes
    only: the positions and tables stay on the card."""
    want = -(-SPLIT_TARGET_CTAS // max(1, B * Hkv))
    P = max(-(-SPLIT_MIN_KEYS // bs), -(-M // want))
    P = max(1, min(P, M))
    return P, -(-M // P)


def _prefill_live_tiles(T, Hq, Hkv, bs, M, positions, window=None):
    """``(visited, skipped)``: the (q tile, key tile, kv head) triples
    that ``paged_prefill_mma_kernel`` visits on these inputs, and the
    rest of the table's ``ceil(M * bs / 64)`` key tiles. The CTA of q
    tile ``[r0, r0 + 64)`` visits the 64-key tiles that meet ``[kmin,
    kmax]``: kmax the position of its last row below ``R`` (row ``r``
    at ``positions[b] + r // group``), clamped to ``M * bs - 1``; kmin
    its first row's position ``- window + 1``, or 0."""
    group = Hq // Hkv
    R = T * group
    n_keys = M * bs
    table_tiles = -(-n_keys // PREFILL_TILE)
    visited = total = 0
    for pos0 in (int(x) for x in positions):
        for r0 in range(0, R, PREFILL_TILE):
            last = min(r0 + PREFILL_TILE, R) - 1
            kmax = min(pos0 + last // group, n_keys - 1)
            kmin = max(0, pos0 + r0 // group - window + 1) if window else 0
            if kmax >= kmin:
                visited += kmax // PREFILL_TILE - kmin // PREFILL_TILE + 1
            total += table_tiles
    return Hkv * visited, Hkv * (total - visited)


def paged_prefill_tile_counts():
    """``(visited, skipped)``: the (q tile, key tile, kv head) triples
    that the mma route's kernel visited and skipped since the last call,
    as it counted them on the current card (:func:`_prefill_live_tiles`
    is the rule); resets them. Waits for the card."""
    out = (ctypes.c_ulonglong * 2)()
    err = load_kernel().paged_prefill_tile_counts(out)
    if err != 0:
        raise RuntimeError(f"reading the prefill tile counts failed: CUDA "
                           f"error {err}")
    return out[0], out[1]


def _check_shapes(q, k_pool, v_pool, block_tables, positions, window):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [B, T, Hq, D] and pools [num_blocks, bs, Hkv, D] "
            f"(or q [S, B, T, Hq, D] and pools [S, num_blocks, bs, Hkv, "
            f"D]); got {tuple(q.shape)} / {tuple(k_pool.shape)}")
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


def _stacked_shards(q, k_pool, v_pool):
    """The stack depth ``S`` of a 5-D call (raises on a malformed one)."""
    if (q.dim() != 5 or k_pool.dim() != 5 or v_pool.shape != k_pool.shape
            or q.shape[0] != k_pool.shape[0]):
        raise ValueError(
            f"a stacked call takes q [S, B, T, Hq, D] and pools [S, "
            f"num_blocks, bs, Hkv, D] with the same S; got "
            f"{tuple(q.shape)} / {tuple(k_pool.shape)} / "
            f"{tuple(v_pool.shape)}")
    return k_pool.shape[0]


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
      k_pool / v_pool: ``[num_blocks, bs, Hkv, D]``, q's dtype. Or the
        TP-stacked form: pools ``[S, num_blocks, bs, Hkv_local, D]`` with
        ``q`` ``[S, B, T, Hq_local, D]``, the tables and positions shared
        across the stack; shard ``s`` is the 4-D call on ``q[s]``,
        ``k_pool[s]``, ``v_pool[s]``, each on its route, and the result
        is ``[S, B, T, Hq_local, D]``.
      block_tables: ``[B, max_blocks]`` int32 logical -> physical map.
      positions: ``[B]`` int32 first-new-token position per row.
      window: optional causal sliding-window width
        (``qpos - window < kpos <= qpos``).
      scale: score scale (default ``D ** -0.5``).
      scratch_block: physical block whose table entries are fully masked
        (the serving pool's block 0); ``None`` disables the mask.

    Returns ``[B, T, Hq, D]`` in q's dtype; fp32 accumulation inside.
    On CPU tensors this is :func:`paged_flash_decode_reference`; on CUDA
    tensors the route's kernels run (bf16 or fp32, ``D`` in 32/64/128)
    or the call raises — there is no fallback to another route.
    """
    if k_pool.dim() == 5:
        S = _stacked_shards(q, k_pool, v_pool)
        if q.device.type == "cpu":
            return paged_flash_decode_reference(
                q, k_pool, v_pool, block_tables, positions, window=window,
                scale=scale, scratch_block=scratch_block)
        out = torch.empty_like(q)
        for s in range(S):
            _paged_flash_decode(q[s], k_pool[s], v_pool[s], block_tables,
                                positions, window, scale, scratch_block,
                                out=out[s])
        global STACKED_LAUNCHES
        STACKED_LAUNCHES += 1
        return out
    return _paged_flash_decode(q, k_pool, v_pool, block_tables, positions,
                               window, scale, scratch_block)


def _paged_flash_decode(q, k_pool, v_pool, block_tables, positions, window,
                        scale, scratch_block, out=None):
    """The 4-D call; on CUDA the kernels write into ``out`` (a contiguous
    tensor like ``q``) when it is given."""
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
    if q.dtype not in _DTYPES:
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
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "load K/V rows as 16-byte vectors)")
    scale = float(D ** -0.5 if scale is None else scale)
    window = -1 if window is None else int(window)
    scratch = -1 if scratch_block is None else int(scratch_block)
    M = block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if out is None:
        out = torch.empty_like(q)
    route = _route(q.dtype, T, Hq, Hkv)
    lib = load_kernel()
    if route != "rows" and q.data_ptr() % 16:
        q = q.clone()  # the bf16 kernels read q in 16-byte vectors
    if route == "split":
        P, n_splits = _split_plan(B, Hkv, M, bs)
        R = T * (Hq // Hkv)
        part = torch.empty(B * Hkv * n_splits * R * (D + 2),
                           dtype=torch.float32, device=q.device)
        err = lib.paged_flash_decode_split_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            part.data_ptr(), B, T, Hq, Hkv, D, bs, M, P, n_splits, window,
            scale, scratch, stream)
    elif route == "mma":
        err = lib.paged_flash_prefill_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, T, Hq, Hkv, D, bs, M, window, scale, scratch, stream)
    else:
        err = lib.paged_flash_decode_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, T, Hq, Hkv, D, bs, M, window, scale, scratch, stream)
    if err != 0:
        raise RuntimeError(f"paged_flash_decode {route} launch failed: "
                           f"CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    return out


def paged_flash_decode_reference(q, k_pool, v_pool, block_tables,
                                 positions, *, window: Optional[int] = None,
                                 scale: Optional[float] = None,
                                 scratch_block: Optional[int] = 0):
    """The plain PyTorch version of :func:`paged_flash_decode`: the same
    masks and numerics over the gathered ``pool[tables]`` view, in one
    softmax pass instead of the kernel's online recurrence (the 5-D
    stacked form: one such call per shard, stacked)."""
    if k_pool.dim() == 5:
        return torch.stack([paged_flash_decode_reference(
            q[s], k_pool[s], v_pool[s], block_tables, positions,
            window=window, scale=scale, scratch_block=scratch_block)
            for s in range(_stacked_shards(q, k_pool, v_pool))])
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


def _pick_block(requested: int, T: int) -> int:
    """Largest block <= ``requested`` that divides ``T``: halve until it
    fits (T 768 with 512 asked -> 256), else one block of the whole ``T``
    (the JAX package's ``ops/flash_attention.py::_pick_block``)."""
    b = min(requested, T)
    while T % b and b > 8:
        b //= 2
    return b if T % b == 0 else T


#: identity tables of dense views by (rows, blocks a row, device), built
#: once: the decode tick then launches K4 alone, and a prefill adds one
#: row gather (the JAX trace folds the table into a constant)
_IDENTITY_TABLES: dict = {}


def _identity_table(Bc: int, M: int, device):
    """``[Bc, M]`` int32: row ``r`` of the dense cache is blocks ``r * M +
    arange(M)`` of its view."""
    key = (Bc, M, str(device))
    table = _IDENTITY_TABLES.get(key)
    if table is None:
        table = (torch.arange(Bc, dtype=torch.int32, device=device)[:, None]
                 * M + torch.arange(M, dtype=torch.int32, device=device))
        _IDENTITY_TABLES[key] = table
    return table


def dense_flash_decode(q, cache_k, cache_v, positions, slots=None, *,
                       window: Optional[int] = None,
                       scale: Optional[float] = None):
    """Attention of ``T >= 1`` fresh query rows per slot against the dense
    slot cache, through :func:`paged_flash_decode`.

    ``cache_k``/``cache_v`` ``[Bc, L, Hkv, D]`` are viewed, without a
    copy, as ``Bc * M`` blocks of ``bs = _pick_block(128, L)`` keys (``M =
    L / bs``), and row ``b`` of ``q`` reads cache row ``rows[b]`` through
    the identity table ``rows[:, None] * M + arange(M)``: ``rows`` is
    ``slots`` (``[B]`` cache-row ids, a prefill of one slot) or
    ``arange(Bc)`` (the decode tick over every slot). There is no scratch
    block: every block belongs to its slot, and the causal mask alone
    bounds what a row reads. ``positions`` ``[B]``: row ``b``'s first new
    token's position.

    On CPU tensors this is the plain version; on CUDA tensors one of the
    routes' kernels runs with the scratch mask off, or the call raises.
    """
    Bc, L, Hkv, D = cache_k.shape
    bs = _pick_block(128, L)
    M = L // bs
    pool_k = cache_k.view(Bc * M, bs, Hkv, D)
    pool_v = cache_v.view(Bc * M, bs, Hkv, D)
    tables = _identity_table(Bc, M, q.device)
    if slots is not None:
        tables = tables.index_select(0, slots)
    out = paged_flash_decode(q, pool_k, pool_v, tables, positions,
                             window=window, scale=scale, scratch_block=None)
    if q.device.type == "cuda":
        global DENSE_LAUNCHES
        DENSE_LAUNCHES += 1
    return out
