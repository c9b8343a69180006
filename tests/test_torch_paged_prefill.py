"""The mma route of the port's paged flash decoding, on the CPU.

On CUDA, bf16 calls with more than 16 query rows per (slot, kv head)
run ``paged_prefill_mma_kernel`` (``csrc/paged_prefill_sm90.cu``): one
CTA per (64-row q tile, kv head, slot), rows ``r = t * group + g``, the
64-key K/V tiles that meet the tile's ``[kmin, kmax]`` gathered through
the block table (a key outside it, or in the scratch block, zero-filled
and masked), an online softmax in base 2 with P rounded to bf16 before
P V, and an unmasked path for the tiles that every row sees whole. Here,
without a card, ``_prefill_tiled`` below walks the same tiles in torch
ops and is held against the plain version
(``paged_flash_decode_reference``) and the JAX Pallas kernel in
interpret mode, at fp32 (2e-5: fp32 sums in another order) and bf16
(2e-2: P rounded against the running max of each key tile instead of
the row's final max, a few bf16 ulps of O(1) outputs). Its count of
visited tiles is the rule ``_prefill_live_tiles`` that ``chip_smoke.py``
holds the kernel's own count to on the card. The small cases walk
8- and 16-row tiles so that a few dozen rows cross several of them.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.paged_decode import fused_supported
from chainermn_tpu.ops.paged_decode import paged_flash_decode as jax_decode
from chainermn_tpu_torch.ops import paged_decode as pd
from chainermn_tpu_torch.ops.attention import NEG_INF
from torch_rank_workers import few_threads  # noqa: F401

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOG2E = 1.0 / math.log(2.0)
NEEDS_JAX_KERNEL = pytest.mark.skipif(
    not fused_supported(),
    reason="this jax's Pallas lacks scalar-prefetch grid specs (the JAX "
    "reference kernel cannot run in interpret mode)",
)


def _prefill_tiled(q, kp, vp, tables, positions, *, window=None, scale=None,
                   scratch=0, tile=pd.PREFILL_TILE):
    """The prefill kernel's walk in torch ops: ``(out, visited, skipped,
    unmasked)``, the tile triples it visits, those of the table it skips
    and the visited ones that took the unmasked path."""
    B, T, Hq, D = q.shape
    _, bs, Hkv, _ = kp.shape
    M = tables.shape[1]
    group, R = Hq // Hkv, T * (Hq // Hkv)
    n_keys = M * bs
    scale2 = (D ** -0.5 if scale is None else scale) * LOG2E
    qr = q.float().reshape(B, T, Hkv, group, D).transpose(1, 2)
    qr = qr.reshape(B, Hkv, R, D)
    out = torch.zeros(B, Hkv, R, D)
    visited = unmasked = 0
    neg = torch.tensor(NEG_INF)
    for b in range(B):
        pos0 = int(positions[b])
        for r0 in range(0, R, tile):
            rows = torch.arange(r0, min(r0 + tile, R))
            qpos = pos0 + rows // group
            q_first, q_last = int(qpos[0]), int(qpos[-1])
            kmax = min(q_last, n_keys - 1)
            kmin = max(0, q_first - window + 1) if window else 0
            tiles = range(kmin // tile, kmax // tile + 1) if kmax >= kmin \
                else range(0)
            visited += Hkv * len(tiles)
            m = torch.full((Hkv, len(rows)), NEG_INF)
            l = torch.zeros(Hkv, len(rows))
            acc = torch.zeros(Hkv, len(rows), D)
            for t in tiles:
                k0 = t * tile
                keys = torch.arange(k0, k0 + tile)
                copied = (keys >= kmin) & (keys <= kmax)
                ent = tables[b, keys.clamp(max=n_keys - 1) // bs].long()
                if scratch is not None:
                    copied &= ent != scratch
                ent = torch.where(copied, ent, 0)
                zero = torch.zeros((), dtype=kp.dtype)
                k = torch.where(copied[:, None, None], kp[ent, keys % bs],
                                zero)
                v = torch.where(copied[:, None, None], vp[ent, keys % bs],
                                zero)
                s = torch.einsum("nrd,knd->nrk", qr[b][:, rows],
                                 k.float()) * scale2
                full = (k0 + tile - 1 <= q_first
                        and (not window or q_last - k0 < window)
                        and bool(copied.all()))
                if full:
                    vis = torch.ones(len(rows), tile, dtype=torch.bool)
                    unmasked += Hkv
                else:
                    vis = copied[None] & (keys[None] <= qpos[:, None])
                    if window:
                        vis &= qpos[:, None] - keys[None] < window
                s = torch.where(vis, s, neg)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.where(vis, torch.exp2(s - m_new[..., None]),
                                torch.tensor(0.0))
                corr = torch.exp2(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "nrk,knd->nrd", p.to(vp.dtype).float(), v.float())
                m = m_new
            out[b][:, rows] = torch.where(
                (l > 0)[..., None], acc / l.clamp_min(1e-37)[..., None],
                torch.tensor(0.0))
    out = out.reshape(B, Hkv, T, group, D).transpose(1, 2)
    total = B * Hkv * -(-R // tile) * -(-n_keys // tile)
    return (out.reshape(B, T, Hq, D).to(q.dtype), visited, total - visited,
            unmasked)


def _case(rs, *, B, T, Hq, Hkv, D=8, bs=8, M=4, depths=None, poison=1e9):
    """A poisoned scratch block 0, each row owning the blocks of [0,
    depth + T), the rest of its table scratch."""
    nb = B * M + 1
    kp = rs.randn(nb, bs, Hkv, D).astype(np.float32)
    vp = rs.randn(nb, bs, Hkv, D).astype(np.float32)
    kp[0] = vp[0] = poison
    tables = np.zeros((B, M), np.int32)
    positions = np.zeros((B,), np.int32)
    free = list(rs.permutation(nb - 1) + 1)
    for b in range(B):
        depth = (int(rs.randint(0, M * bs - T + 1)) if depths is None
                 else depths[b])
        positions[b] = depth
        for j in range(min(M, (depth + T - 1) // bs + 1)):
            tables[b, j] = free.pop()
    q = rs.randn(B, T, Hq, D).astype(np.float32)
    return q, kp, vp, tables, positions


def _torch(case, dtype):
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in case)
    return [x.to(dtype) for x in (q, kp, vp)] + [tables, positions]


def _check(case, dtype, *, tile, window=None):
    """The emulation against the plain version and the JAX kernel."""
    args = _torch(case, dtype)
    got, visited, skipped, unmasked = _prefill_tiled(*args, window=window,
                                                     tile=tile)
    want = pd.paged_flash_decode_reference(*args, window=window)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_out = np.asarray(jax_decode(
        *(jnp.asarray(x.float().numpy(), jdt) for x in args[:3]),
        jnp.asarray(case[3]), jnp.asarray(case[4]),
        window=window).astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), jax_out, rtol=tol,
                               atol=tol)
    assert float(got.float().abs().max()) < 10.0  # no poison leaked
    return got, visited, unmasked


DTYPES = [torch.float32, torch.bfloat16]
IDS = ["fp32", "bf16"]

# (name, case kwargs, window, tile): R = T * Hq / Hkv > 16 rows per kv
# head in every case, as the mma route takes them
CASES = [
    ("gqa_group4", dict(B=2, T=12, Hq=8, Hkv=2, M=8), None, 16),
    ("mqa_group8", dict(B=2, T=6, Hq=8, Hkv=1, M=4), None, 16),
    ("window6", dict(B=2, T=16, Hq=4, Hkv=2, M=8, depths=[0, 37]), 6, 8),
    ("ragged_T13", dict(B=1, T=13, Hq=4, Hkv=2, M=4, depths=[0]), None, 8),
    ("past_position_0", dict(B=3, T=9, Hq=4, Hkv=2, M=6,
                             depths=[17, 30, 3]), None, 8),
    ("bs16", dict(B=2, T=20, Hq=2, Hkv=2, bs=16, M=4), None, 16),
    ("bs48_tile_64", dict(B=2, T=40, Hq=2, Hkv=1, bs=48, M=3), None, 64),
]


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("name,kw,window,tile", CASES,
                         ids=[c[0] for c in CASES])
def test_prefill_tiled_matches_plain_and_jax(dtype, name, kw, window, tile):
    rs = np.random.RandomState(sum(map(ord, name)))
    case = _case(rs, **kw)
    assert pd._route(torch.bfloat16, kw["T"], kw["Hq"], kw["Hkv"]) == "mma"
    _check(case, dtype, tile=tile, window=window)


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_scratch_inside_the_band_never_leaks(dtype):
    # row 1's second and third blocks are scratch inside its causal band
    # (a beyond-horizon redirect): those keys are not copied and the
    # 1e9 poison must not move any output
    rs = np.random.RandomState(21)
    case = _case(rs, B=2, T=8, Hq=8, Hkv=2, M=6, depths=[3, 30])
    case[3][1, 1:3] = 0
    for window in (None, 20):
        _check(case, dtype, tile=16, window=window)


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_a_released_all_scratch_row_is_exactly_zero(dtype):
    rs = np.random.RandomState(22)
    case = _case(rs, B=3, T=8, Hq=8, Hkv=2, M=4)
    case[3][1] = 0  # a released slot: every entry scratch, position 0
    case[4][1] = 0
    got, visited, _ = _check(case, dtype, tile=16)
    assert bool((got[1] == 0).all())
    assert visited > 0  # its tiles are walked, every key masked


# (T, Hq, Hkv, bs, M, positions, window) at the kernel's own 64-row tiles
RULE_CASES = [
    (200, 4, 2, 16, 20, [0, 0], None),         # 7 q tiles, 1-4 key tiles
    (64, 8, 8, 8, 40, [1000 % 320, 37], None),  # a tail past position 0
    (96, 4, 1, 48, 8, [0, 100], 70),           # MQA-like group, a window
    (33, 8, 2, 64, 3, [150, 0], None),         # clamped to the table
    (40, 2, 1, 16, 4, [70, 5], 9),             # positions past the table
]


@pytest.mark.parametrize("T,Hq,Hkv,bs,M,positions,window", RULE_CASES)
def test_live_tiles_rule_is_the_walks_count(T, Hq, Hkv, bs, M, positions,
                                            window):
    rs = np.random.RandomState(T + M)
    case = _case(rs, B=len(positions), T=T, Hq=Hq, Hkv=Hkv, bs=bs, M=M,
                 depths=[min(p, M * bs - 1) for p in positions])
    case[4][:] = positions  # rows may sit past their table's horizon
    args = _torch(case, torch.float32)
    got, visited, skipped, _ = _prefill_tiled(*args, window=window)
    assert pd._prefill_live_tiles(T, Hq, Hkv, bs, M, positions,
                                  window) == (visited, skipped)
    want = pd.paged_flash_decode_reference(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_a_long_prefill_takes_the_unmasked_path_in_the_band():
    # T 256 at group 1 from position 0: 4 q tiles; of the 10 key tiles
    # they visit per kv head, the 6 below the diagonal are whole
    rs = np.random.RandomState(23)
    case = _case(rs, B=1, T=256, Hq=2, Hkv=2, bs=64, M=4, depths=[0])
    args = _torch(case, torch.bfloat16)
    got, visited, skipped, unmasked = _prefill_tiled(*args)
    assert (visited, skipped) == (2 * 10, 2 * 16 - 2 * 10)
    assert unmasked == 2 * 6
    want = pd.paged_flash_decode_reference(*args)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_cpu_calls_of_the_mma_shape_launch_nothing():
    rs = np.random.RandomState(24)
    args = _torch(_case(rs, B=2, T=12, Hq=8, Hkv=2, M=8), torch.bfloat16)
    pd.reset_launches()
    got = pd.paged_flash_decode(*args)
    assert torch.equal(got, pd.paged_flash_decode_reference(*args))
    assert pd.LAUNCHES == 0
    assert pd.ROUTE_LAUNCHES == {"split": 0, "mma": 0, "rows": 0}
