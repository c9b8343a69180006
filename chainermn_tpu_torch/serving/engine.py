"""Continuous-batching serving engine: one decode step over a fixed slot
array on a paged KV pool (counterpart of
``chainermn_tpu/serving/engine.py::ServingEngine``).

- **Slot array.** ``num_slots`` requests decode in one forward per tick.
  Join/leave mutate HOST-side metadata only (positions, free list, block
  tables); the device holds the per-layer K/V pools and the model.
- **Prefill/decode split.** A prompt runs through one bucketed prefill
  forward (``datasets/bucketing.py`` ladder) that writes its whole KV
  and samples the first token.
- **Paged KV cache.** One shared block pool per layer with per-slot
  tables (:mod:`chainermn_tpu_torch.ops.paged_kv`,
  :mod:`chainermn_tpu_torch.serving.kv_blocks`); the model writes into
  the pools in place, so occupancy changes never reallocate.
- **Attention.** ``decode_attend_impl='fused'`` (the default here) runs
  both the prefill's and every decode tick's attention through the paged
  flash-decoding CUDA kernel (:mod:`chainermn_tpu_torch.ops.
  paged_decode`); ``'xla'`` gathers the dense view and attends with
  torch ops.

Token-stream guarantee, as in the JAX package: at temperature 0 a
request's stream equals the sequential stream for the same prompt,
whatever other requests share the slot array (per-row attention never
mixes rows).

Options of the JAX engine that this port does not serve yet raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.datasets.bucketing import (
    DEFAULT_BUCKETS,
    bucket_length,
)
from chainermn_tpu_torch.models.transformer import (
    DECODE_ATTEND_IMPLS,
    TransformerLM,
)
from chainermn_tpu_torch.serving.kv_blocks import (
    BlockAllocator,
    default_num_blocks,
    init_serving_cache,
)


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP queue 1, serving items left "
        f"out of the first slice: {item})")


class ServingEngine:
    """Fixed-slot continuous-batching decode over a ``TransformerLM``.

    Args:
      model: the :class:`~chainermn_tpu_torch.models.transformer.
        TransformerLM` to serve (its weights stay where they are; the
        engine serves through a clone carrying ``decode_attend_impl``).
      num_slots: concurrent requests per decode step.
      max_len: serving horizon (prompt + generated) per request; defaults
        to ``model.max_len``. Block tables are sized to it.
      decode_impl: ``'paged'`` only.
      decode_attend_impl: ``'fused'`` (CUDA kernel; plain version on the
        CPU) or ``'xla'`` (gather + torch ops).
      kv_block_size: tokens per pool block (default 64).
      num_blocks: pool capacity in blocks including scratch block 0;
        default is the no-oversubscription worst case
        (:func:`~chainermn_tpu_torch.serving.kv_blocks.default_num_blocks`).
      prefill_buckets: prompt-length ladder of the prefill.
      temperature: 0 (greedy) only.
      pad_id: prompt right-padding token for the bucketed prefill.
      device: where the pools live; ``None`` means the CUDA card and
        raises without one. Must be the model's device.

    The other JAX options (``mesh``, ``spec_tokens``, ``prefix_cache``,
    ``prefill_chunk``, ``prefill_seq_parallel``, ``adapter_bank``,
    sampling, ``'auto'`` registry resolution, the dense layout) raise
    ``NotImplementedError`` when set.
    """

    def __init__(self, model, *, num_slots: int,
                 max_len: Optional[int] = None,
                 decode_impl: str = "paged",
                 decode_attend_impl: str = "fused",
                 kv_block_size=64,
                 num_blocks: Optional[int] = None,
                 prefill_buckets: Sequence[int] = DEFAULT_BUCKETS,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 pad_id: int = 0, mesh=None, spec_tokens=0,
                 prefix_cache="off", prefill_chunk=0,
                 prefill_seq_parallel="off", adapter_bank=None,
                 device=None) -> None:
        if not isinstance(model, TransformerLM):
            raise TypeError(f"ServingEngine serves TransformerLM, got "
                            f"{type(model).__name__}")
        if decode_impl != "paged":
            raise _not_ported(f"decode_impl={decode_impl!r}",
                              "the dense slot layout and the registry's "
                              "'auto' resolution")
        if decode_attend_impl == "auto" or kv_block_size == "auto":
            raise _not_ported("'auto' decode_attend_impl/kv_block_size",
                              "the tuning registry's 'auto' knobs")
        if decode_attend_impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(f"decode_attend_impl must be one of "
                             f"{DECODE_ATTEND_IMPLS}, got "
                             f"{decode_attend_impl!r}")
        if temperature != 0.0 or top_k is not None or top_p is not None:
            raise _not_ported("sampling (temperature > 0, top_k, top_p)",
                              "sampling with a counter-based key")
        if mesh is not None:
            raise _not_ported("mesh=", "tensor-parallel serving")
        if spec_tokens != 0:
            raise _not_ported(f"spec_tokens={spec_tokens!r}",
                              "speculative decoding")
        if prefix_cache != "off":
            raise _not_ported(f"prefix_cache={prefix_cache!r}",
                              "the prefix cache with copy-on-write")
        if prefill_chunk != 0:
            raise _not_ported(f"prefill_chunk={prefill_chunk!r}",
                              "chunked prefill")
        if prefill_seq_parallel != "off":
            raise _not_ported(
                f"prefill_seq_parallel={prefill_seq_parallel!r}",
                "sequence-parallel prefill")
        if adapter_bank is not None:
            raise _not_ported("adapter_bank=", "multi-tenant adapters")
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        max_len = int(max_len or model.max_len)
        if max_len > model.max_len:
            raise ValueError(f"max_len={max_len} exceeds the model context "
                             f"{model.max_len}")
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device.type != self.device.type or (
                self.device.index is not None
                and model_device.index != self.device.index):
            raise ValueError(f"the model lives on {model_device}, the engine "
                             f"was asked for {self.device}")

        self.num_slots = int(num_slots)
        self.max_len = max_len
        self.pad_id = int(pad_id)
        self.decode_attend_impl = decode_attend_impl
        self.kv_block_size = int(kv_block_size)
        self._buckets = tuple(
            b for b in sorted(set(prefill_buckets)) if b <= max_len
        ) or (max_len,)
        if self._buckets[-1] < max_len:
            # the ladder must be able to carry a full-horizon prompt
            self._buckets = self._buckets + (max_len,)

        num_blocks = num_blocks or default_num_blocks(
            num_slots, self.kv_block_size, max_len)
        self._alloc = BlockAllocator(num_blocks, self.kv_block_size,
                                     num_slots, max_len)
        self._decode_model = model.clone(
            decode_attend_impl=decode_attend_impl)
        self._cache = init_serving_cache(
            model, num_blocks=num_blocks, block_size=self.kv_block_size,
            device=self.device)
        self._positions = np.zeros(num_slots, np.int64)
        self._last_tok = np.zeros(num_slots, np.int64)
        self._active = np.zeros(num_slots, bool)
        self._free = list(range(num_slots - 1, -1, -1))
        self._tables_dev = None  # device copy of the block tables...
        self._tables_ver = -1    # ...valid while allocator.version holds
        #: most pool blocks slots held at once (scratch excluded).
        self.peak_blocks_in_use = 0

    # ------------------------------------------------------------------

    def _tables_device(self):
        """The block tables as a CACHED device tensor, re-uploaded only
        when the allocator actually mutated a row — the steady-state
        decode loop pays no table upload per step."""
        if self._tables_dev is None or self._tables_ver != self._alloc.version:
            self._tables_dev = torch.tensor(self._alloc.tables,
                                            dtype=torch.int32,
                                            device=self.device)
            self._tables_ver = self._alloc.version
        return self._tables_dev

    def _pool_exhausted_error(self) -> RuntimeError:
        return RuntimeError(
            "paged KV pool exhausted mid-stream: "
            f"{self._alloc.blocks_in_use}/{self._alloc.num_blocks - 1} "
            "blocks in use — size num_blocks for the resident-token worst "
            "case or admit fewer concurrent requests")

    def _note_pool(self) -> None:
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self._alloc.blocks_in_use)

    # ------------------------------------------------------------------
    # serving surface

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def free_slot_count(self) -> int:
        return len(self._free)

    @property
    def num_blocks(self) -> int:
        return self._alloc.num_blocks

    @property
    def blocks_in_use(self) -> int:
        return self._alloc.blocks_in_use

    def occupancy(self) -> float:
        return self.n_active / self.num_slots

    def pool_utilization(self) -> float:
        return self._alloc.utilization()

    def _admit_common(self, prompt):
        """Validate the prompt and reserve a slot plus the pool blocks
        for the whole prompt and the first decode write. Returns
        ``(slot, prompt, P_len)`` with the slot POPPED from the free
        list, or None to defer (host state untouched — the scheduler
        retries)."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        P_len = int(prompt.shape[0])
        if P_len < 1:
            raise ValueError("empty prompt")
        if P_len >= self.max_len:
            raise ValueError(
                f"prompt of {P_len} tokens leaves no room to generate "
                f"within max_len={self.max_len}")
        if not self._free:
            return None
        slot = self._free[-1]  # peek; commit only after alloc succeeds
        # Reserve only the REAL tokens plus the first decode write (not
        # the padded bucket: pad writes beyond the reservation land in
        # the scratch block). A deferral restores the exact prior table,
        # so it restores the version too (no needless table re-upload).
        v0 = self._alloc.version
        if not self._alloc.ensure(slot, P_len + 1):
            self._alloc.release(slot)
            self._alloc.version = v0
            return None
        self._free.pop()
        return slot, prompt, P_len

    @torch.no_grad()
    def prefill_join(self, prompt):
        """Admit one request: claim a slot, run the bucketed prefill and
        return ``(slot, first_token, bucket)`` — or None when no slot (or
        not enough pool blocks) is free right now."""
        res = self._admit_common(prompt)
        if res is None:
            return None
        slot, prompt, P_len = res
        bucket = bucket_length(P_len, self._buckets)
        padded = np.full((1, bucket), self.pad_id, np.int64)
        padded[0, :P_len] = prompt
        logits = self._decode_model(
            torch.tensor(padded, device=self.device), decode=True,
            decode_positions=torch.zeros(1, dtype=torch.int32,
                                         device=self.device),
            block_tables=self._tables_device()[slot:slot + 1],
            cache=self._cache,
        )
        tok = int(torch.argmax(logits[0, P_len - 1]))
        self._positions[slot] = P_len
        self._last_tok[slot] = tok
        self._active[slot] = True
        self._note_pool()
        return slot, tok, bucket

    @torch.no_grad()
    def decode_step(self):
        """One decode step over ALL slots. Returns ``(tokens, dur_s)`` —
        ``tokens[s]`` is slot ``s``'s next token (garbage for inactive
        slots; callers consult their own active set). Host metadata for
        active slots advances by one position."""
        active = np.flatnonzero(self._active)
        for s in active:
            p = int(self._positions[s])
            if p + 1 > self.max_len:
                raise RuntimeError(
                    f"slot {int(s)} ran past the serving horizon "
                    f"max_len={self.max_len}; bound max_new_tokens")
            if not self._alloc.ensure(int(s), p + 1):
                raise self._pool_exhausted_error()
        self._note_pool()
        t0 = time.perf_counter()
        logits = self._decode_model(
            torch.tensor(self._last_tok[:, None], device=self.device),
            decode=True,
            decode_positions=torch.tensor(self._positions,
                                          dtype=torch.int32,
                                          device=self.device),
            block_tables=self._tables_device(), cache=self._cache,
        )
        # the host read is the device sync: honest per-step latency
        toks = logits[:, 0].argmax(dim=-1).cpu().numpy()
        dur = time.perf_counter() - t0
        self._last_tok[active] = toks[active]
        self._positions[active] += 1
        return toks, dur

    def leave(self, slot: int) -> None:
        """Release a slot (host metadata + pool blocks only; stale writes
        land in the slot's own rows or the scratch block)."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._active[slot] = False
        self._free.append(int(slot))
        self._alloc.release(int(slot))
