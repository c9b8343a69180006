"""The split route of the port's paged flash decoding, on the CPU.

On CUDA, bf16 calls with at most 16 query rows per (slot, kv head) run
``paged_decode_split_kernel`` + ``paged_decode_merge_kernel``
(``csrc/paged_decode_sm90.cu``): split-K over the block table, 64-key
tiles, four warps per split each with its own online softmax over a
quarter of every tile, P rounded to bf16 per 16-key chunk, the warps and
then the splits merged in order. Here,
without a card, the route rule and the split plan are checked as the
pure functions they are, and ``_split_then_merge`` below does the
kernels' algorithm in torch ops — the same splits, the same band, the
same scratch and tile skips, the same empty partials and the same merge
— so the algorithm is held against the plain version
(``paged_flash_decode_reference``) and the JAX Pallas kernel in
interpret mode, at fp32 (2e-5: fp32 sums in another order) and bf16
(2e-2: P rounded against each warp's running max instead of the row's
final max, a few bf16 ulps of O(1) outputs). ``chip_smoke.py`` holds the
kernels themselves against the plain version on the card.
"""

import inspect
import re
from pathlib import Path

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
#: the split kernel's tile of keys (``kKeys``) and its warps
#: (``kThreads / 32``): each warp takes a quarter of every live tile with
#: its own online softmax, P rounded to bf16 against its running max
TILE_KEYS, WARPS = 64, 4
NEEDS_JAX_KERNEL = pytest.mark.skipif(
    not fused_supported(),
    reason="this jax's Pallas lacks scalar-prefetch grid specs (the JAX "
    "reference kernel cannot run in interpret mode)",
)


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("B,Hkv,M,bs", [
    (16, 8, 32, 64),   # the serving decode tick
    (16, 2, 32, 64),   # GQA
    (16, 1, 32, 64),   # MQA
    (1, 1, 1, 64), (3, 4, 4, 8), (2, 2, 37, 16), (64, 8, 32, 64),
    (1, 8, 512, 16), (5, 3, 7, 48), (300, 16, 2, 128),
])
def test_split_plan_covers_the_table_once(B, Hkv, M, bs):
    P, n = pd._split_plan(B, Hkv, M, bs)
    assert type(P) is int and type(n) is int and 1 <= P <= M
    covered = [j for s in range(n) for j in range(s * P, min((s + 1) * P, M))]
    assert covered == list(range(M))  # each block once, in order
    assert (n - 1) * P < M  # no split is empty by construction


def test_split_plan_takes_shapes_only():
    assert list(inspect.signature(pd._split_plan).parameters) == [
        "B", "Hkv", "M", "bs"]
    # the serving decode tick: 8 splits of 4 blocks, 1024 CTAs; GQA: 16
    # splits of 2 blocks (no split under SPLIT_MIN_KEYS keys)
    assert pd._split_plan(16, 8, 32, 64) == (4, 8)
    assert pd._split_plan(16, 2, 32, 64) == (2, 16)
    assert pd._split_plan(1, 1, 32, 64) == (2, 16)


# ------------------------------------------------------------ the route

@pytest.mark.parametrize("T,Hq,Hkv", [(1, 8, 8), (1, 8, 2), (4, 4, 4),
                                      (1, 16, 1), (4, 8, 2), (16, 8, 8)])
def test_bf16_rows_up_to_16_take_the_split_route(T, Hq, Hkv):
    assert T * (Hq // Hkv) <= 16
    assert pd._route(torch.bfloat16, T, Hq, Hkv) == "split"


@pytest.mark.parametrize("T,Hq,Hkv", [
    (17, 8, 8), (3, 12, 2), (128, 8, 8), (1, 32, 1),
    (17, 1, 1), (9, 2, 1), (5, 8, 2), (2048, 8, 8),
])
def test_bf16_prefill_takes_the_mma_route(T, Hq, Hkv):
    assert T * (Hq // Hkv) > pd.SPLIT_MAX_ROWS
    assert pd._route(torch.bfloat16, T, Hq, Hkv) == "mma"


@pytest.mark.parametrize("T,Hq,Hkv", [(1, 8, 8), (1, 16, 1), (4, 8, 2),
                                      (512, 8, 8)])
def test_fp32_takes_the_rows_route(T, Hq, Hkv):
    assert pd._route(torch.float32, T, Hq, Hkv) == "rows"


def test_the_library_builds_both_sources_with_no_atomics():
    # named when the library had two sources: it has three, the mma
    # route's among them
    csrc = Path(pd.__file__).resolve().parent.parent / "csrc"
    assert pd.SOURCES == ("paged_decode.cu", "paged_decode_sm90.cu",
                          "paged_prefill_sm90.cu")
    atomic = re.compile(r"\batomic\w*\s*\(|\b(atom|red)\.")
    text = (csrc / "paged_decode_sm90.cu").read_text()
    for name in ("paged_decode_split_kernel", "paged_decode_merge_kernel",
                 "cp.async.cg.shared.global", "cp.async.wait_group",
                 "paged_flash_decode_split_launch",
                 f"kKeys = {TILE_KEYS};", f"kThreads = {32 * WARPS};"):
        assert name in text
    # no atomic call or instruction: the merge order is fixed
    assert atomic.search(text) is None
    text = (csrc / "paged_prefill_sm90.cu").read_text()
    for name in ("paged_prefill_mma_kernel", "paged_flash_prefill_launch",
                 "paged_prefill_tile_counts", "wg_abt<D>", "wg_xb<D>",
                 "cp_async16", "softmax_step<D, false>",
                 "softmax_step<D, true>", "ex2"):
        assert name in text
    # its one atomic is the tile counter's (count_tiles, shared with K1's
    # header); the output is written once per row
    assert atomic.search(text) is None
    assert text.count("count_tiles(") == 1
    assert "count_tiles(g_prefill_tile_counts" in text
    # the clock probes build only where a tool defines K4_PREFILL_CLOCKS
    assert text.count("#ifdef K4_PREFILL_CLOCKS") == 2
    # the rows route is fp32 only: no bf16 type and no dtype argument
    text = (csrc / "paged_decode.cu").read_text()
    assert "paged_flash_decode_launch" in text and "bfloat16" not in text
    assert "int dtype" not in text


def test_cpu_calls_launch_nothing_and_reset_zeroes_every_count():
    rs = np.random.RandomState(1)
    args = [torch.from_numpy(a) for a in _case(rs, B=2, T=1, Hq=4, Hkv=1)]
    pd.LAUNCHES = 3
    pd.ROUTE_LAUNCHES["split"] = 2
    before = (pd.LAUNCHES, dict(pd.ROUTE_LAUNCHES))
    args = [a.bfloat16() if a.is_floating_point() else a for a in args]
    got = pd.paged_flash_decode(*args)
    assert torch.equal(got, pd.paged_flash_decode_reference(*args))
    assert (pd.LAUNCHES, pd.ROUTE_LAUNCHES) == before
    pd.reset_launches()
    assert pd.LAUNCHES == 0 and pd.ROUTE_LAUNCHES == {"split": 0, "mma": 0,
                                                      "rows": 0}


# ------------------------------------------------------------ the algorithm

def _merge(states, like):
    """``(m, l, acc)`` states merged in order, as the split kernel merges
    its warps and the merge kernel the splits: each rescaled by exp(m -
    m_max), a state with l = 0 (empty, or every key masked) adding
    nothing."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    lsum, a = torch.zeros_like(like[..., 0]), torch.zeros_like(like)
    for m, l, acc in states:
        f = torch.where(l > 0, torch.exp(m - mx), torch.tensor(0.0))
        lsum = lsum + l * f
        a = a + torch.where((l > 0)[..., None], acc * f[..., None],
                            torch.tensor(0.0))
    return mx, lsum, a


def _split_then_merge(q, kp, vp, tables, positions, *, P, window=None,
                      scale=None, scratch=0, tile=TILE_KEYS, warps=WARPS):
    """The split and merge kernels' algorithm in torch ops: ``(out, number
    of empty partials)``. A split keeps the 64-key tiles of its band that
    hold a live key; warp w of its CTA takes keys [w * 16, w * 16 + 16)
    of each, with its own online softmax (P rounded against the warp's
    running max); the warps merge, then the splits."""
    B, T, Hq, D = q.shape
    _, bs, Hkv, _ = kp.shape
    M = tables.shape[1]
    group, R = Hq // Hkv, T * (Hq // Hkv)
    n_splits = -(-M // P)
    wk = tile // warps
    scale = D ** -0.5 if scale is None else scale
    qr = q.float().reshape(B, T, Hkv, group, D).transpose(1, 2)
    qr = qr.reshape(B, Hkv, R, D)
    row_t = torch.arange(R) // group
    zero = torch.zeros(Hkv, R, D)
    out = torch.zeros(B, Hkv, R, D)
    empty = 0
    for b in range(B):
        pos0 = int(positions[b])
        kmax = min(pos0 + T - 1, M * bs - 1)
        kmin = max(0, pos0 - window + 1) if window else 0
        qpos = pos0 + row_t

        def chunk(t0, n):
            """Keys [t0, t0 + n): which are loaded, and their K and V."""
            keys = torch.arange(t0, t0 + n)
            band = (keys >= lo) & (keys <= hi)
            ent = torch.where(band, tables[b, keys.clamp(0, M * bs - 1)
                                           // bs].long(), -1)
            loaded = band if scratch is None else band & (ent != scratch)
            ent = ent.clamp(min=0)
            k = torch.where(loaded[:, None, None], kp[ent, keys % bs],
                            torch.zeros((), dtype=kp.dtype))
            v = torch.where(loaded[:, None, None], vp[ent, keys % bs],
                            torch.zeros((), dtype=vp.dtype))
            return keys, loaded, k, v

        parts = []
        for s in range(n_splits):
            split_lo = s * P * bs
            split_hi = min((s + 1) * P, M) * bs - 1
            lo, hi = max(split_lo, kmin), min(split_hi, kmax)
            key_base = split_lo + (lo - split_lo) // tile * tile
            live = [t0 for t0 in range(key_base, hi + 1, tile)
                    if bool(chunk(t0, tile)[1].any())]
            if not live:  # an empty partial
                empty += 1
                parts.append((torch.full((Hkv, R), NEG_INF),
                              torch.zeros(Hkv, R), zero))
                continue
            states = []
            for w in range(warps):
                m = torch.full((Hkv, R), NEG_INF)
                l = torch.zeros(Hkv, R)
                acc = zero
                for t0 in live:
                    keys, loaded, k, v = chunk(t0 + w * wk, wk)
                    vis = loaded[None] & (keys[None] <= qpos[:, None])
                    if window:
                        vis &= keys[None] > qpos[:, None] - window
                    sc = torch.einsum("nrd,knd->nrk", qr[b],
                                      k.float()) * scale
                    sc = torch.where(vis, sc, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.where(vis, torch.exp(sc - m_new[..., None]),
                                    torch.tensor(0.0))
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "nrk,knd->nrd", p.to(vp.dtype).float(), v.float())
                    m = m_new
                states.append((m, l, acc))
            parts.append(_merge(states, zero))
        _, lsum, a = _merge(parts, zero)
        out[b] = torch.where((lsum > 0)[..., None],
                             a / lsum.clamp_min(1e-37)[..., None],
                             torch.tensor(0.0))
    out = out.reshape(B, Hkv, T, group, D).transpose(1, 2)
    return out.reshape(B, T, Hq, D).to(q.dtype), empty


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


def _check(case, dtype, *, P, window=None, expect_empty=None):
    """The emulation against the plain version and the JAX kernel."""
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in case)
    q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
    got, empty = _split_then_merge(q, kp, vp, tables, positions, P=P,
                                   window=window)
    want = pd.paged_flash_decode_reference(q, kp, vp, tables, positions,
                                           window=window)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jax_out = np.asarray(jax_decode(
        *(jnp.asarray(x.float().numpy(), jdt) for x in (q, kp, vp)),
        jnp.asarray(tables.numpy()), jnp.asarray(positions.numpy()),
        window=window).astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), jax_out, rtol=tol,
                               atol=tol)
    if expect_empty is not None:
        assert empty == expect_empty
    return got, empty


DTYPES = [torch.float32, torch.bfloat16]
IDS = ["fp32", "bf16"]


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_splits_all_scratch_or_beyond_the_horizon(dtype):
    rs = np.random.RandomState(11)
    # row 0 sees block 0 only: its later splits lie beyond its horizon;
    # row 1 is deep but blocks 1 and 2 of its table are scratch, so at P
    # 1 splits 1 and 2 hold no live block; row 2 is deep and whole
    case = _case(rs, B=3, T=1, Hq=4, Hkv=2, depths=[5, 30, 27])
    case[3][1, 1:3] = 0
    _check(case, dtype, P=1, expect_empty=3 + 2)
    _check(case, dtype, P=2, expect_empty=1)


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_a_window_empties_the_leading_splits(dtype):
    rs = np.random.RandomState(12)
    case = _case(rs, B=2, T=2, Hq=4, Hkv=2, M=8, depths=[60, 41])
    # window 6 at depths 60 and 41: only blocks 6-7 and 4-5 are in band
    _check(case, dtype, P=1, window=6, expect_empty=6 + 6)
    _check(case, dtype, P=3, window=6)


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("T,Hq,Hkv", [(1, 8, 2), (2, 8, 2), (4, 8, 2)],
                         ids=["R4", "R8", "R16"])
def test_gqa_group_4(dtype, T, Hq, Hkv):
    rs = np.random.RandomState(13 + T)
    case = _case(rs, B=3, T=T, Hq=Hq, Hkv=Hkv, M=6)
    for P in (1, 2, 4):
        _check(case, dtype, P=P)


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_mqa_group_16_the_last_split_row_count(dtype):
    rs = np.random.RandomState(14)
    case = _case(rs, B=3, T=1, Hq=16, Hkv=1, M=5)
    assert pd._route(torch.bfloat16, 1, 16, 1) == "split"
    for P in (1, 2, 5):
        _check(case, dtype, P=P)


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_a_released_all_scratch_row_is_exactly_zero(dtype):
    rs = np.random.RandomState(15)
    case = _case(rs, B=3, T=1, Hq=4, Hkv=1)
    case[3][1] = 0  # released slot: every entry scratch, position 0
    case[4][1] = 0
    got, empty = _check(case, dtype, P=1)
    assert bool((got[1] == 0).all())
    assert empty >= 4  # all four of the released row's splits


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("P", [1, 3])
def test_poison_in_scratch_never_leaks_at_any_depth(dtype, P):
    # one row at every depth the table can hold, partial last blocks,
    # GQA and a window: the 1e9 scratch block must not move any output
    rs = np.random.RandomState(16)
    M, bs, T = 4, 8, 2
    depths = list(range(M * bs - T + 1))
    case = _case(rs, B=len(depths), T=T, Hq=4, Hkv=2, M=M, bs=bs,
                 depths=depths)
    for window in (None, 5):
        got, _ = _check(case, dtype, P=P, window=window)
        assert float(got.float().abs().max()) < 10.0


@NEEDS_JAX_KERNEL
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_tiles_narrower_than_a_split_and_the_plan_itself(dtype):
    # 16-key blocks, 2 blocks a split, 8-key tiles of 2-key warp chunks:
    # several tiles per split; then 64-key tiles over 16-key blocks (a
    # tile spans blocks), and the plan's own P
    rs = np.random.RandomState(17)
    case = _case(rs, B=4, T=1, Hq=8, Hkv=2, bs=16, M=6)
    q, kp, vp, tables, positions = (torch.from_numpy(a) for a in case)
    q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
    want = pd.paged_flash_decode_reference(q, kp, vp, tables, positions)
    for P, tile in ((2, 8), (1, 64), (pd._split_plan(4, 2, 6, 16)[0], 64)):
        got, _ = _split_then_merge(q, kp, vp, tables, positions, P=P,
                                   tile=tile)
        np.testing.assert_allclose(got.float().numpy(),
                                   want.float().numpy(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    _check(case, dtype, P=2)
