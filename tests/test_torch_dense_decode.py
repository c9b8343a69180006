"""K4's dense entry in the PyTorch port against the JAX package's.

``dense_flash_decode`` views the dense slot cache ``[Bc, L, Hkv, D]`` as
``L / bs`` blocks a row (``bs = _pick_block(128, L)``) with an identity
table and no scratch block, then calls the paged kernel. On CPU tensors
the port computes its plain version; it is held against the JAX
``dense_flash_decode`` run in Pallas interpret mode, as
tests/test_paged_decode.py runs the kernel, at fp32 ``2e-5`` (fp32
accumulation on both sides, sums in another order) and bf16 ``2e-2``
(P rounded to bf16 at other points of the online vs the one-pass
softmax: a few bf16 ulps of values of order 1). Shapes: ``slots`` None
(the decode tick) and given (a prefill of one slot), a window, GQA, and
L giving bs 128 (L 512), bs 16 (L 400) and one block of the whole L (L
2047). The CUDA routes are held against the same plain version on the
card by ``chip_smoke.py`` (phase 13).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.flash_attention import _pick_block as jax_pick_block
from chainermn_tpu.ops.paged_decode import dense_flash_decode as jax_dense
from chainermn_tpu.ops.paged_decode import fused_supported
from chainermn_tpu_torch.ops import paged_decode as pd
from torch_rank_workers import few_threads  # noqa: F401

pytestmark = pytest.mark.skipif(
    not fused_supported(),
    reason="this jax's Pallas lacks scalar-prefetch grid specs (the JAX "
    "reference kernel cannot run in interpret mode)",
)

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def test_pick_block_matches_jax_for_every_length_to_4096():
    got = [pd._pick_block(128, L) for L in range(1, 4097)]
    want = [jax_pick_block(128, L) for L in range(1, 4097)]
    assert got == want
    assert (pd._pick_block(128, 2048), pd._pick_block(128, 400),
            pd._pick_block(128, 2047)) == (128, 16, 2047)


def _case(rs, *, Bc, L, T, Hq, Hkv, D, n_rows):
    ck = rs.randn(Bc, L, Hkv, D).astype(np.float32)
    cv = rs.randn(Bc, L, Hkv, D).astype(np.float32)
    q = rs.randn(n_rows, T, Hq, D).astype(np.float32)
    return q, ck, cv


def _both(q, ck, cv, positions, slots, window, dtype):
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    want = np.asarray(jax_dense(
        jnp.asarray(q, jdt), jnp.asarray(ck, jdt), jnp.asarray(cv, jdt),
        jnp.asarray(positions, jnp.int32),
        None if slots is None else jnp.asarray(slots, jnp.int32),
        window=window, interpret=True).astype(jnp.float32))
    got = pd.dense_flash_decode(
        torch.from_numpy(q).to(tdt), torch.from_numpy(ck).to(tdt),
        torch.from_numpy(cv).to(tdt),
        torch.tensor(positions, dtype=torch.int32),
        None if slots is None else torch.tensor(slots, dtype=torch.int32),
        window=window).float().numpy()
    return got, want


CASES = {
    # decode tick over every slot, bs 128 (L 512); slot 0 at depth 200
    "decode_bs128": dict(Bc=4, L=512, T=1, Hq=4, Hkv=4, D=16, slots=None,
                         positions=[200, 0, 511, 37], window=None),
    "decode_gqa_window_bs16": dict(Bc=3, L=400, T=1, Hq=4, Hkv=2, D=16,
                                   slots=None, positions=[399, 17, 250],
                                   window=40),
    # a prefill of one slot through slots=[s]
    "prefill_slot2_bs128": dict(Bc=4, L=256, T=24, Hq=4, Hkv=2, D=16,
                                slots=[2], positions=[0], window=None),
    "prefill_tail_slot1_bs16": dict(Bc=3, L=400, T=12, Hq=4, Hkv=4, D=16,
                                    slots=[1], positions=[130], window=9),
    # no power of two >= 8 divides 2047: one block of the whole ring
    "decode_one_block_L2047": dict(Bc=2, L=2047, T=1, Hq=2, Hkv=1, D=16,
                                   slots=None, positions=[2046, 5],
                                   window=None),
    "prefill_one_block_L2047": dict(Bc=2, L=2047, T=8, Hq=2, Hkv=2, D=16,
                                    slots=[0], positions=[1000],
                                    window=None),
}


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_flash_decode_matches_jax(name, dtype):
    c = dict(CASES[name])
    rs = np.random.RandomState(sorted(CASES).index(name))
    slots, positions, window = c.pop("slots"), c.pop("positions"), \
        c.pop("window")
    n_rows = c["Bc"] if slots is None else len(slots)
    q, ck, cv = _case(rs, n_rows=n_rows, **c)
    got, want = _both(q, ck, cv, positions, slots, window, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_slot_zero_reads_its_first_block():
    """Slot 0's first block is physical block 0 of the view: with no
    scratch block its keys are live. The port equals a plain softmax over
    the dense row, and moving one key of block 0 moves the output."""
    rs = np.random.RandomState(5)
    Bc, L, Hkv, D = 2, 256, 2, 16  # bs 128: block 0 = slot 0, keys 0-127
    q = torch.from_numpy(rs.randn(Bc, 1, 2, D).astype(np.float32))
    ck = torch.from_numpy(rs.randn(Bc, L, Hkv, D).astype(np.float32))
    cv = torch.from_numpy(rs.randn(Bc, L, Hkv, D).astype(np.float32))
    pos = torch.tensor([40, 200], dtype=torch.int32)
    got = pd.dense_flash_decode(q, ck, cv, pos)
    s = torch.einsum("bhd,blhd->bhl", q[:, 0], ck) * D ** -0.5
    live = torch.arange(L)[None, None] <= pos.long()[:, None, None]
    w = torch.softmax(s.masked_fill(~live, float("-inf")), dim=-1)
    want = torch.einsum("bhl,blhd->bhd", w, cv)
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    cv2 = cv.clone()
    cv2[0, 3] += 10.0
    moved = pd.dense_flash_decode(q, ck, cv2, pos)
    assert not torch.allclose(moved[0], got[0])
    assert torch.equal(moved[1], got[1])


def test_dense_entry_counts_nothing_on_the_cpu():
    pd.reset_launches()
    q = torch.zeros(1, 1, 2, 8)
    c = torch.zeros(1, 16, 2, 8)
    pd.dense_flash_decode(q, c, c, torch.zeros(1, dtype=torch.int32))
    assert pd.DENSE_LAUNCHES == 0 and pd.LAUNCHES == 0
