"""Host-side paged-KV bookkeeping: the block allocator and cache init
(counterpart of ``chainermn_tpu/serving/kv_blocks.py``).

- :class:`BlockAllocator` — a free-list over physical pool blocks and
  the per-slot block tables, with the JAX package's refcount and
  ``version`` semantics, so the same ensure/release sequence yields the
  same tables. Pure numpy: join/leave/growth never touch the device
  except through the engine's cached table upload.
- :func:`init_serving_cache` — allocate the per-layer K/V caches
  directly on the device: the paged pools ``[num_blocks, block_size,
  kv_heads, head_dim]``, or the dense rows ``[num_slots, L, kv_heads,
  head_dim]``.

Layout contract (shared with :mod:`chainermn_tpu_torch.ops.paged_kv`):
physical block 0 is SCRATCH — never owned by a slot; released or
never-grown table entries point at it, so stale writes land in a garbage
block instead of a block that may since belong to another request.

The radix-trie ``PrefixCache`` (cross-request prefix sharing) is not
ported yet; the allocator keeps its refcount and reclaim hooks, which
the trie drives.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class BlockAllocator:
    """Free-list allocator over a paged KV pool.

    ``num_blocks`` counts the WHOLE pool including scratch, matching
    the device pool's leading dimension; ``num_blocks - 1`` blocks are
    allocatable. Allocation failure returns False (the scheduler defers
    admission) — never raises mid-stream.
    """

    SCRATCH = 0

    def __init__(self, num_blocks: int, block_size: int, num_slots: int,
                 max_len: int) -> None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is scratch), got "
                f"{num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_slots = int(num_slots)
        self.max_blocks = math.ceil(max_len / block_size)
        # LIFO free list: recently released blocks are reused first
        # (warm HBM lines on chip; deterministic tables in tests).
        self._free = list(range(self.num_blocks - 1, self.SCRATCH, -1))
        self.tables = np.full((num_slots, self.max_blocks), self.SCRATCH,
                              np.int32)
        self._owned: list[list[int]] = [[] for _ in range(num_slots)]
        #: per-block slot-table reference counts (scratch stays 0).
        #: A block may appear in several slots' tables (prefix sharing);
        #: it returns to the free list only at refcount 0 AND not
        #: trie-cached.
        self.refcounts = np.zeros(self.num_blocks, np.int32)
        #: blocks held by the prefix trie's cache — kept out of the free
        #: list at refcount 0 until evicted (best-effort cache).
        self._cached: set[int] = set()
        #: reclaim hook (set by the prefix trie): called with the
        #: block shortfall when ``ensure`` would fail; returns how many
        #: blocks it freed. Live slots can therefore never be starved by
        #: cached-but-unreferenced blocks.
        self.reclaimer: Optional[Callable[[int], int]] = None
        #: capacity twin of the reclaim hook (set by the prefix trie
        #: alongside it): how many blocks the hook could free RIGHT NOW.
        #: Strictly less than :meth:`blocks_cached` when a live slot
        #: references a cached chain's descendant — those ancestors never
        #: become evictable leaves.
        self.reclaim_capacity: Optional[Callable[[], int]] = None
        #: bumped on every table mutation — the engine keys its cached
        #: device copy of ``tables`` on it, so the steady-state decode
        #: loop re-uploads only when an admit/grow/release actually
        #: changed a row.
        self.version = 0

    # ------------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by at least one slot's table (cached-but-
        unreferenced trie blocks are NOT in use — they are reclaimable,
        counted by :meth:`blocks_cached`)."""
        return int((self.refcounts > 0).sum())

    def blocks_cached(self) -> int:
        """Trie-cached blocks no slot references. An upper bound on what
        eviction can free — a cached ancestor whose descendant a live
        slot references is counted here but pinned; the deliverable
        number is the ``reclaim_capacity`` hook."""
        return sum(1 for b in self._cached if self.refcounts[b] == 0)

    def blocks_shared(self) -> int:
        """Blocks referenced by MORE than one slot's table."""
        return int((self.refcounts > 1).sum())

    def utilization(self) -> float:
        """Fraction of the allocatable pool currently owned by slots."""
        denom = self.num_blocks - 1
        return self.blocks_in_use / denom if denom else 0.0

    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to cover positions ``[0, n_positions)``."""
        return math.ceil(n_positions / self.block_size)

    def can_cover(self, slot: int, n_positions: int) -> bool:
        """Whether :meth:`ensure` for ``n_positions`` would succeed right
        now. Counts only blocks the reclaim hook could ACTUALLY free —
        not every cached refcount-0 block: a cached ancestor whose
        descendant is referenced by a live slot never becomes an
        evictable leaf, so it must not be promised here."""
        need = self.blocks_for(n_positions) - len(self._owned[slot])
        spare = len(self._free)
        if self.reclaim_capacity is not None:
            spare += self.reclaim_capacity()
        return need <= spare

    def owned_blocks(self, slot: int) -> list[int]:
        """``slot``'s physical blocks in table order (a copy)."""
        return list(self._owned[slot])

    def _take_free(self, need: int) -> bool:
        """Whether the free list can supply ``need`` blocks, reclaiming
        cached-but-unreferenced trie blocks (leaf-first LRU, via the
        hook) before giving up. A HOPELESS request — more than free +
        reclaimable — evicts nothing: flushing the hot cache for an
        admission that defers anyway would regress every follower."""
        if need > len(self._free) and self.reclaimer is not None:
            if self.reclaim_capacity is not None:
                if need > len(self._free) + self.reclaim_capacity():
                    return False
            self.reclaimer(need - len(self._free))
        return need <= len(self._free)

    def _unref(self, blk: int) -> None:
        """Drop one slot-table reference; the block returns to the free
        list only when nothing references it and the trie does not
        cache it."""
        self.refcounts[blk] -= 1
        if self.refcounts[blk] < 0:  # pragma: no cover - internal guard
            raise AssertionError(f"block {blk} refcount underflow")
        if self.refcounts[blk] == 0 and blk not in self._cached:
            self._free.append(blk)

    def ensure(self, slot: int, n_positions: int) -> bool:
        """Grow ``slot``'s table to cover positions ``[0, n_positions)``.

        Returns False (state unchanged) when the pool cannot supply the
        missing blocks — all-or-nothing, so a deferred admission leaves
        no half-grown table behind. Before deferring, cached-but-
        unreferenced prefix-trie blocks are reclaimed through the
        allocator's hook (leaf-first LRU), so the best-effort cache can
        never starve a live slot.
        """
        if n_positions > self.max_blocks * self.block_size:
            raise ValueError(
                f"slot {slot}: {n_positions} positions exceed the table "
                f"horizon {self.max_blocks * self.block_size}"
            )
        owned = self._owned[slot]
        need = self.blocks_for(n_positions) - len(owned)
        if need > 0 and not self._take_free(need):
            return False
        if need > 0:
            self.version += 1
        for _ in range(max(0, need)):
            blk = self._free.pop()
            self.refcounts[blk] = 1
            self.tables[slot, len(owned)] = blk
            owned.append(blk)
        return True

    def adopt(self, slot: int, blocks: Sequence[int]) -> None:
        """Append already-filled ``blocks`` to ``slot``'s table (the
        prefix-trie hit path): each gains one reference — nothing is
        popped from the free list, nothing is copied. Callers adopt
        BEFORE :meth:`ensure`-ing the tail, so the table stays
        position-ordered."""
        if not blocks:
            return
        owned = self._owned[slot]
        if len(owned) + len(blocks) > self.max_blocks:
            raise ValueError(
                f"slot {slot}: adopting {len(blocks)} blocks over "
                f"{len(owned)} owned exceeds the table horizon"
            )
        self.version += 1
        for blk in blocks:
            if blk == self.SCRATCH:
                raise ValueError("cannot adopt the scratch block")
            self.refcounts[blk] += 1
            self.tables[slot, len(owned)] = blk
            owned.append(blk)

    def shared_for_write(self, blk: int) -> bool:
        """Whether a device-plane write to ``blk`` must copy first:
        another slot references it, or the prefix trie caches it (a
        write would corrupt the trie's pristine copy for future
        adopters)."""
        return bool(self.refcounts[blk] > 1 or blk in self._cached)

    def alloc_block(self) -> Optional[int]:
        """Pop one free block (refcount 1, unattached to any table) —
        the copy-on-write destination. None on genuine exhaustion
        (after the reclaim hook ran)."""
        if not self._take_free(1):
            return None
        blk = self._free.pop()
        self.refcounts[blk] = 1
        return blk

    def cow_replace(self, slot: int, index: int, new_blk: int) -> int:
        """Repoint table entry ``index`` of ``slot`` at ``new_blk`` (a
        block from :meth:`alloc_block`, already holding the copied
        contents) and drop the old block's reference. Host rewrite for
        the WRITING slot only — every other reader of the old block,
        and the trie's cached copy, are untouched. Returns the old
        physical block id."""
        old = self._owned[slot][index]
        self.version += 1
        self._owned[slot][index] = int(new_blk)
        self.tables[slot, index] = new_blk
        self._unref(old)
        return old

    # ---- trie-cache bookkeeping (driven by PrefixCache) --------------

    def mark_cached(self, blk: int) -> None:
        self._cached.add(int(blk))

    def uncache(self, blk: int) -> None:
        """Drop the trie's hold on ``blk`` (eviction); frees it when no
        slot references it."""
        blk = int(blk)
        self._cached.discard(blk)
        if self.refcounts[blk] == 0:
            self._free.append(blk)

    def trim(self, slot: int, n_positions: int) -> None:
        """Shrink ``slot``'s table to cover no more than positions
        ``[0, n_positions)`` — :meth:`ensure`'s inverse for the tail.
        Freed blocks return to the pool and their table entries point
        back at scratch, so any stale writes they hold become
        unreachable (the :meth:`release` guarantee, per block). The
        engine uses this to make speculative span reservations per-tick
        LEASES: trimming to the committed frontier each tick returns an
        earlier tick's unused extension before it can starve another
        slot. Trimming below the committed history would lose data —
        callers trim to the frontier, never below."""
        owned = self._owned[slot]
        keep = self.blocks_for(n_positions)
        if keep >= len(owned):
            return
        self.version += 1
        while len(owned) > keep:
            blk = owned.pop()
            self.tables[slot, len(owned)] = self.SCRATCH
            self._unref(blk)

    def release(self, slot: int) -> None:
        """Drop ``slot``'s references and point its table back at
        scratch (stale in-flight writes become harmless). Blocks still
        referenced by other slots, or cached by the prefix trie, stay
        out of the free list (the refcount contract); a second release
        of an already-released slot is a no-op (idempotent — no version
        churn)."""
        if self._owned[slot]:
            self.version += 1
        for blk in reversed(self._owned[slot]):
            self._unref(blk)
        self._owned[slot] = []
        self.tables[slot] = self.SCRATCH


def default_num_blocks(num_slots: int, block_size: int, max_len: int) -> int:
    """Worst-case pool: every slot at ``max_len`` simultaneously, plus
    scratch. Oversubscribe deliberately (smaller ``num_blocks``) when the
    expected resident-token sum is below the worst case — admission then
    defers on pool exhaustion instead of OOMing."""
    return num_slots * math.ceil(max_len / block_size) + 1


def init_serving_cache(model, *, num_blocks: Optional[int] = None,
                       block_size: Optional[int] = None,
                       num_slots: Optional[int] = None, device=None) -> list:
    """Zero-initialised caches for the slot-decode path, one dict per
    layer in the model's compute dtype on ``device`` (default: the
    model's device), by the model's ``kv_layout``:

    - ``'paged'``: ``{"pool_key", "pool_value"}`` of ``[num_blocks,
      block_size, kv_heads, head_dim]`` (block 0 is scratch);
    - ``'dense'``: ``{"cached_key", "cached_value"}`` of ``[num_slots,
      decode_cache_len or max_len, kv_heads, head_dim]``, one row per
      slot.

    The engine threads this list through every forward; the model writes
    into it in place."""
    if device is None:
        device = next(model.parameters()).device
    if model.kv_layout == "dense":
        if num_slots is None or num_slots < 1:
            raise ValueError(f"the dense layout needs num_slots >= 1, got "
                             f"{num_slots}")
        shape = (num_slots, model.decode_cache_len or model.max_len,
                 model.kv_heads, model.head_dim)
        names = ("cached_key", "cached_value")
    else:
        if num_blocks is None or num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is "
                             f"scratch), got {num_blocks}")
        shape = (num_blocks, block_size, model.kv_heads, model.head_dim)
        names = ("pool_key", "pool_value")
    return [
        {name: torch.zeros(shape, dtype=model.compute_dtype, device=device)
         for name in names}
        for _ in range(model.num_layers)
    ]
