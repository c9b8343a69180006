"""Paged KV primitives of the PyTorch port against the JAX package.

Same numpy inputs through ``chainermn_tpu.ops.paged_kv`` and
``chainermn_tpu_torch.ops.paged_kv``: the scatter and the gather are
pure data movement, so they must agree BITWISE — including ``T > 1``
spans and the beyond-horizon redirect to the scratch block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import paged_kv as jax_kv
from chainermn_tpu_torch.ops import paged_kv as torch_kv
from torch_rank_workers import few_threads  # noqa: F401


def _case(rs, B=3, nb=12, bs=4, M=3, H=2, D=8, T=1):
    pool = rs.randn(nb, bs, H, D).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    ids = rs.permutation(np.arange(1, nb))
    k = 0
    for b in range(B):
        n = int(rs.randint(1, M + 1))
        tables[b, :n] = ids[k:k + n]
        k += n
    positions = rs.randint(0, M * bs - T + 1, size=B).astype(np.int32)
    new = rs.randn(B, T, H, D).astype(np.float32)
    return pool, tables, positions, new


def _both_updates(pool, tables, positions, new):
    want = np.asarray(jax_kv.paged_update(
        jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(positions),
        jnp.asarray(new)))
    got = torch_kv.paged_update(
        torch.from_numpy(pool.copy()), torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(new)).numpy()
    return want, got


@pytest.mark.parametrize("T", [1, 3, 6])
def test_paged_update_bitwise(T):
    rs = np.random.RandomState(10 + T)
    pool, tables, positions, new = _case(rs, T=T)
    want, got = _both_updates(pool, tables, positions, new)
    # Live blocks bitwise; the scratch block may take colliding writes
    # (several rows redirected to one scratch row) in any order.
    np.testing.assert_array_equal(got[1:], want[1:])


def test_paged_update_bitwise_including_scratch_without_collisions():
    rs = np.random.RandomState(3)
    pool, tables, positions, new = _case(rs, B=2, T=2)
    tables[:] = [[1, 2, 3], [4, 5, 6]]
    want, got = _both_updates(pool, tables, positions, new)
    np.testing.assert_array_equal(got, want)


def test_beyond_horizon_span_redirects_to_scratch():
    # A span overhanging max_blocks * bs must not clamp into the row's
    # last (live) block: both packages send it to scratch block 0.
    rs = np.random.RandomState(5)
    pool, tables, positions, new = _case(rs, B=1, T=4, M=3, bs=4)
    tables[0] = [7, 8, 9]
    positions[0] = 10  # positions 10, 11 in block 2; 12, 13 beyond
    want, got = _both_updates(pool, tables, positions, new)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[9, 2:], new[0, :2])
    np.testing.assert_array_equal(got[0, :2], new[0, 2:])
    np.testing.assert_array_equal(got[9, :2], pool[9, :2])


def test_paged_update_writes_in_place():
    rs = np.random.RandomState(6)
    pool, tables, positions, new = _case(rs)
    t = torch.from_numpy(pool.copy())
    out = torch_kv.paged_update(t, torch.from_numpy(tables),
                                torch.from_numpy(positions),
                                torch.from_numpy(new))
    assert out.data_ptr() == t.data_ptr()


@pytest.mark.parametrize("B,M", [(1, 1), (3, 3), (2, 5)])
def test_paged_lookup_bitwise(B, M):
    rs = np.random.RandomState(B * 10 + M)
    pool, tables, _, _ = _case(rs, B=B, M=M, nb=B * M + 2)
    want = np.asarray(jax_kv.paged_lookup(jnp.asarray(pool),
                                          jnp.asarray(tables)))
    got = torch_kv.paged_lookup(torch.from_numpy(pool),
                                torch.from_numpy(tables)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
