"""Paged flash decoding in the PyTorch port against the JAX Pallas kernel.

The port's plain version (``paged_flash_decode_reference``, what the
wrapper computes on CPU tensors) is held against the JAX package's
``paged_flash_decode`` run in Pallas interpret mode, exactly as
tests/test_paged_decode.py runs it, at that file's fp32 tolerance
(2e-5): the kernel-contract shapes, a POISONED scratch block (1e9, so a
masking leak is loud), beyond-horizon rows and an all-scratch released
row. The CUDA kernel itself is held against the same plain version on
the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.paged_decode import fused_supported
from chainermn_tpu.ops.paged_decode import paged_flash_decode as jax_decode
from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.ops import paged_decode as pd
from torch_rank_workers import few_threads  # noqa: F401

pytestmark = pytest.mark.skipif(
    not fused_supported(),
    reason="this jax's Pallas lacks scalar-prefetch grid specs (the JAX "
    "reference kernel cannot run in interpret mode)",
)

TOL = dict(rtol=2e-5, atol=2e-5)  # fp32 accumulation on both sides


def _pool_case(rs, B=3, T=1, Hq=4, Hkv=4, D=8, nb=14, bs=8, M=4,
               poison=1e9):
    """tests/test_paged_decode.py's case: poisoned scratch block 0 and
    per-row tables mixing live blocks with scratch past the live span."""
    kp = rs.randn(nb, bs, Hkv, D).astype(np.float32)
    vp = rs.randn(nb, bs, Hkv, D).astype(np.float32)
    kp[0] = poison
    vp[0] = poison
    tables = np.zeros((B, M), np.int32)
    free = list(range(1, nb))
    positions = np.zeros((B,), np.int32)
    for b in range(B):
        depth = int(rs.randint(0, M * bs - T))
        positions[b] = depth
        for j in range(depth // bs + 1):
            tables[b, j] = free.pop(0)
    q = rs.randn(B, T, Hq, D).astype(np.float32)
    return q, kp, vp, tables, positions


def _both(q, kp, vp, tables, positions, window=None, dtype=np.float32):
    want = np.asarray(jax_decode(
        jnp.asarray(q, dtype), jnp.asarray(kp, dtype),
        jnp.asarray(vp, dtype), jnp.asarray(tables),
        jnp.asarray(positions), window=window,
    ).astype(jnp.float32))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = pd.paged_flash_decode_reference(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(positions), window=window,
    ).float().numpy()
    return want, got


@pytest.mark.parametrize("T,Hq,Hkv,window", [
    (1, 4, 4, None),      # plain decode tick
    (3, 4, 4, None),      # multi-row span
    (1, 4, 2, None),      # GQA
    (4, 4, 1, None),      # MQA, chunk-width span
    (2, 4, 2, 6),         # GQA + sliding window
])
def test_plain_version_matches_jax_kernel(T, Hq, Hkv, window):
    rs = np.random.RandomState(100 + 10 * T + Hkv)
    case = _pool_case(rs, T=T, Hq=Hq, Hkv=Hkv)
    want, got = _both(*case, window=window)
    np.testing.assert_allclose(got, want, **TOL)


def test_beyond_horizon_rows_stay_finite_and_match():
    rs = np.random.RandomState(3)
    T, bs, M = 4, 8, 4
    q, kp, vp, tables, positions = _pool_case(rs, T=T)
    positions[0] = M * bs - 2  # rows 2..3 of slot 0 overhang the horizon
    tables[0] = [1, 2, 3, 4]
    want, got = _both(q, kp, vp, tables, positions)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_all_scratch_released_row_emits_exact_zero():
    rs = np.random.RandomState(4)
    q, kp, vp, tables, positions = _pool_case(rs, B=2)
    tables[1] = 0
    positions[1] = 0
    want, got = _both(q, kp, vp, tables, positions)
    assert np.all(got[1] == 0.0)
    np.testing.assert_allclose(got, want, **TOL)


def test_poison_in_scratch_never_leaks_at_any_depth():
    # Every row at a different depth, partial last blocks, GQA + window:
    # the 1e9 scratch block must not move any output.
    rs = np.random.RandomState(7)
    q, kp, vp, tables, positions = _pool_case(rs, B=4, T=2, Hq=4, Hkv=2,
                                              nb=20, M=4)
    want, got = _both(q, kp, vp, tables, positions, window=5)
    assert np.abs(got).max() < 10.0
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_matches_jax_kernel_at_bf16_tolerance():
    # bf16 inputs and output, P rounded to bf16 before the PV product on
    # both sides; the two round at different points (online vs one-pass
    # softmax), so the bound is a few bf16 ulps of O(1) outputs.
    rs = np.random.RandomState(8)
    case = _pool_case(rs, T=3, Hq=4, Hkv=2, poison=3.0)
    want, got = _both(*case, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_wrapper_on_cpu_tensors_is_the_plain_version_and_not_a_launch():
    rs = np.random.RandomState(9)
    args = [torch.from_numpy(a) for a in _pool_case(rs, T=2, Hq=4, Hkv=2)]
    before = pd.LAUNCHES
    got = pd.paged_flash_decode(*args, window=3)
    want = pd.paged_flash_decode_reference(*args, window=3)
    assert torch.equal(got, want)
    assert pd.LAUNCHES == before


def test_wrapper_rejects_a_device_it_has_no_kernel_for():
    q = torch.zeros(1, 1, 2, 32, device="meta")
    pool = torch.zeros(3, 4, 2, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_flash_decode(q, pool, pool,
                              torch.zeros(1, 2, dtype=torch.int32,
                                          device="meta"),
                              torch.zeros(1, dtype=torch.int32,
                                          device="meta"))


def test_wrapper_validates_shapes_before_dispatch():
    q = torch.zeros(2, 1, 4, 8)
    pool = torch.zeros(5, 4, 3, 8)  # 4 q heads over 3 kv heads
    with pytest.raises(ValueError, match="multiple of kv heads"):
        pd.paged_flash_decode(q, pool, pool,
                              torch.zeros(2, 2, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32))


def test_building_the_cuda_library_without_nvcc_raises(monkeypatch,
                                                       tmp_path):
    # No nvcc on PATH, under $CUDA_HOME or the default toolkit path: the
    # build must fail loudly rather than hand back some other
    # implementation.
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("paged_decode", ["paged_decode.cu"])
