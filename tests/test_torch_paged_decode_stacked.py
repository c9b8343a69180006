"""K4's 5-D tensor-parallel stacked entry in the PyTorch port against the
JAX package's (``chainermn_tpu/ops/paged_decode.py:204-215``).

Pools ``[S, num_blocks, bs, Hkv_local, D]`` and ``q`` ``[S, B, T,
Hq_local, D]`` with the tables and positions shared across the stack:
the port's plain version (what the wrapper computes on CPU tensors) is
held against the JAX ``paged_flash_decode`` run in Pallas interpret mode
on ``tests/test_paged_decode.py::test_stacked_tp_pools_share_the_program``'s
case (stacks ``[q, 2q]``, ``[kp, 0.5 kp]``, ``[vp, -vp]``, a poisoned
scratch block) and on prefill and window variants, at that file's fp32
tolerance (2e-5), and against its own per-shard 4-D calls bit for bit.
The CUDA kernels' 5-D entry is held the same way on the card by
``chip_smoke.py`` phase 14 (a).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.paged_decode import fused_supported
from chainermn_tpu.ops.paged_decode import paged_flash_decode as jax_decode
from chainermn_tpu_torch.ops import paged_decode as pd
from test_torch_paged_decode import TOL, _pool_case
from torch_rank_workers import few_threads  # noqa: F401

pytestmark = pytest.mark.skipif(
    not fused_supported(),
    reason="this jax's Pallas lacks scalar-prefetch grid specs (the JAX "
    "reference kernel cannot run in interpret mode)",
)


def _stacked_case(seed, **kw):
    q, kp, vp, tables, positions = _pool_case(np.random.RandomState(seed),
                                              **kw)
    return (np.stack([q, 2 * q]), np.stack([kp, 0.5 * kp]),
            np.stack([vp, -vp]), tables, positions)


CASES = {
    # the JAX test's case: decode, GQA 4 over 2
    "jax_test_decode": (6, dict(Hq=4, Hkv=2), None),
    "prefill_T5": (7, dict(T=5, Hq=4, Hkv=2), None),
    "window9_mha": (8, dict(T=3, Hq=2, Hkv=2), 9),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_entry_matches_jax(name):
    seed, kw, window = CASES[name]
    qs, kps, vps, tables, positions = _stacked_case(seed, **kw)
    want = np.asarray(jax_decode(
        jnp.asarray(qs), jnp.asarray(kps), jnp.asarray(vps),
        jnp.asarray(tables), jnp.asarray(positions), window=window))
    args = [torch.from_numpy(a) for a in (qs, kps, vps, tables, positions)]
    for fn in (pd.paged_flash_decode_reference, pd.paged_flash_decode):
        got = fn(*args, window=window)
        assert got.shape == qs.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stacked_entry_is_its_per_shard_calls_bit_for_bit(name):
    seed, kw, window = CASES[name]
    qs, kps, vps, tables, positions = (
        torch.from_numpy(a) for a in _stacked_case(seed, **kw))
    before = pd.STACKED_LAUNCHES
    got = pd.paged_flash_decode(qs, kps, vps, tables, positions,
                                window=window)
    for s in range(qs.shape[0]):
        one = pd.paged_flash_decode(qs[s], kps[s], vps[s], tables,
                                    positions, window=window)
        assert torch.equal(got[s], one)
        assert torch.equal(got[s], pd.paged_flash_decode_reference(
            qs[s], kps[s], vps[s], tables, positions, window=window))
    assert pd.STACKED_LAUNCHES == before  # counted on CUDA tensors only


def test_malformed_stacks_are_refused():
    qs, kps, vps, tables, positions = (
        torch.from_numpy(a) for a in _stacked_case(6, Hq=4, Hkv=2))
    for bad in ((qs[0], kps, vps), (qs, kps, vps[:1]), (qs[:1], kps, vps)):
        for fn in (pd.paged_flash_decode, pd.paged_flash_decode_reference):
            with pytest.raises(ValueError, match="stacked call"):
                fn(*bad, tables, positions)
    with pytest.raises(ValueError, match="must be"):
        pd.paged_flash_decode(qs, kps[0], vps[0], tables, positions)
