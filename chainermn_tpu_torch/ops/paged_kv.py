"""Paged KV-cache primitives: a preallocated block pool plus per-slot
block tables (counterpart of ``chainermn_tpu/ops/paged_kv.py``).

Layout contract (shared with :mod:`chainermn_tpu_torch.serving.kv_blocks`):

- ``pool``: ``[num_blocks, block_size, kv_heads, head_dim]``; physical
  block 0 is the SCRATCH block — never handed to a slot, the write
  target for rows whose table has no block (inactive/released slots),
  so a scatter is always in bounds and collisions only ever trash
  scratch.
- ``block_tables``: ``[B, max_blocks]`` int32 physical ids; logical
  block ``j`` of row ``b`` lives at ``pool[block_tables[b, j]]``.

Both functions are plain tensor ops: XLA generated them for the JAX
package, and no hand-written kernel stood behind them.
"""

from __future__ import annotations

import torch


def _write_index(block_tables, positions, T: int, block_size: int):
    """Physical ``(block, offset)`` of each of the ``T`` consecutive
    positions per row starting at ``positions[b]``; positions beyond the
    table horizon map to the scratch block."""
    max_blocks = block_tables.shape[1]
    pos = (positions.long()[:, None]
           + torch.arange(T, device=positions.device)[None])
    logical = pos // block_size
    offset = pos % block_size
    phys = torch.gather(block_tables, 1,
                        logical.clamp(max=max_blocks - 1)).long()
    phys = torch.where(logical < max_blocks, phys, torch.zeros_like(phys))
    return phys.reshape(-1), offset.reshape(-1)


def paged_update(pool, block_tables, positions, new):
    """Scatter ``new`` token K/V rows into ``pool`` IN PLACE and return it.

    The JAX version returns a new pool (the engine donated the old one
    through its jit); here the write goes straight into the pool tensor
    with ``index_put_``, so the engine's cache never reallocates.

    Args:
      pool: ``[num_blocks, block_size, kv_heads, head_dim]``.
      block_tables: ``[B, max_blocks]`` int32.
      positions: ``[B]`` integer — position of row ``b``'s FIRST new token.
      new: ``[B, T, kv_heads, head_dim]`` — ``T`` consecutive tokens per
        row (``T=1`` decode, ``T=bucket`` prefill).

    Rows whose table entries are 0 write into the scratch block.
    Positions BEYOND the table horizon are redirected to scratch
    explicitly: a clamped gather would land them in the row's LAST table
    entry, which may be a live block.
    """
    B, T = new.shape[:2]
    phys, offset = _write_index(block_tables, positions, T, pool.shape[1])
    pool.index_put_((phys, offset),
                    new.reshape(B * T, *new.shape[2:]).to(pool.dtype))
    return pool


def paged_lookup(pool, block_tables):
    """Gather each row's blocks into a contiguous dense view
    ``[B, max_blocks * block_size, kv_heads, head_dim]`` — the same
    layout the dense cache stores directly. Unallocated table entries
    gather the scratch block; position masking excludes them."""
    g = pool[block_tables.long()]  # [B, M, bs, kvh, dh]
    B, M, bs = g.shape[:3]
    return g.reshape(B, M * bs, *g.shape[3:])
