"""Continuous-batching serving engine: one decode step over a fixed slot
array (counterpart of ``chainermn_tpu/serving/engine.py::ServingEngine``).

- **Slot array.** ``num_slots`` requests decode in one forward per tick.
  Join/leave mutate HOST-side metadata only (positions, free list, block
  tables, sampling seeds); the device holds the per-layer K/V caches and
  the model.
- **Prefill/decode split.** A prompt runs through one bucketed prefill
  forward (``datasets/bucketing.py`` ladder) that writes its whole KV
  and samples the first token.
- **KV layouts** (``decode_impl``): ``'paged'``, one shared block pool per
  layer with per-slot tables (:mod:`chainermn_tpu_torch.ops.paged_kv`,
  :mod:`chainermn_tpu_torch.serving.kv_blocks`), or ``'dense'``, one
  ``[num_slots, max_len]`` row per slot and no allocator (a prefill
  writes its slot's row through ``decode_slots``). The model writes into
  the caches in place, so occupancy changes never reallocate.
- **Attention.** ``decode_attend_impl='fused'`` (the default here) runs
  both the prefill's and every decode tick's attention through K4's
  CUDA kernels (:mod:`chainermn_tpu_torch.ops.paged_decode`:
  ``paged_flash_decode``, or ``dense_flash_decode`` for the dense
  layout); ``'xla'`` reads the dense view and attends with torch ops.
- **Sampling** (``temperature``, ``top_k``, ``top_p``): counter-keyed,
  as in :func:`~chainermn_tpu_torch.models.transformer.generate` — the
  token at absolute position ``i`` of a request with seed ``s`` draws
  with ``fold_in(fold_in(base_key, s), i)``.

- **Tensor parallelism** (``mesh=``, a process group or communicator of
  ``n`` ranks, one process per rank): every rank builds an engine over
  the same full model; each holds its shard (:func:`shard_lm_params`,
  rank ``r`` loads ``[r]``) in a local decode model of ``Hq / n`` query
  heads, ``Hkv / n`` kv heads and ``d_ff / n``, its own cache of those
  kv heads, and attends through K4's 4-D entry on its own heads. Every
  forward makes two all-reduces per layer and no other collective; the
  logits after the last reduce are the same on every rank, and so are
  the schedulers' decisions and the streams, provided every rank is
  handed the same requests in the same order. An MoE model
  (``n_experts > 0``) keeps the full ``d_ff``; its experts live on the
  TP ranks (rank ``r`` owns experts ``[r E/n, (r+1) E/n)``), each rank
  routes its slice of the rows to their owners (two all-to-alls a layer)
  and the MoE combine's all-reduce takes the place of ``ff_down``'s.

Token-stream guarantee, as in the JAX package: a request's stream equals
the sequential :func:`~chainermn_tpu_torch.models.transformer.generate`
stream for the same prompt (and, sampled, the same seed), whatever other
requests share the slot array (per-row attention never mixes rows).

Options of the JAX engine that this port does not serve yet raise
``NotImplementedError`` naming their ROADMAP item; none is ignored.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.datasets.bucketing import (
    DEFAULT_BUCKETS,
    bucket_length,
)
from chainermn_tpu_torch.models.transformer import (
    DECODE_ATTEND_IMPLS,
    TransformerLM,
    _tempered_filtered,
    _validate_filters,
    stream_sample_keys,
)
from chainermn_tpu_torch.parallel.collectives import as_group
from chainermn_tpu_torch.parallel.tensor import (
    shard_qkv_columns,
    stack_tp_params,
)
from chainermn_tpu_torch.serving.kv_blocks import (
    BlockAllocator,
    default_num_blocks,
    init_serving_cache,
)
from chainermn_tpu_torch.utils import prng

DECODE_IMPLS = ("dense", "paged")
PREFIX_CACHE = ("on", "off")


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP queue 1, serving items left "
        f"out of the first slice: {item})")


# ---------------------------------------------------------------------------
# tensor-parallel weights

_ROW_SHARDED = ("proj", "ff_down")  # the JAX kernel's rows: columns here


def _tp_layer(name: str):
    """``(layer, leaf)`` of a block leaf (``blocks.{i}.{layer}.{leaf}``),
    ``(leaf, None)`` of an MoE leaf (``blocks.{i}.moe_*``), or None for
    the replicated leaves outside the blocks."""
    parts = name.split(".")
    if len(parts) == 4 and parts[0] == "blocks":
        return parts[2], parts[3]
    if len(parts) == 3 and parts[0] == "blocks" and parts[2].startswith(
            "moe_"):
        return parts[2], None
    return None


def _expert_leaf(layer) -> bool:
    """An expert-stacked MoE leaf (sliced by expert; the router is not)."""
    return bool(layer) and layer.startswith("moe_") and layer != "moe_router"


def _stack_leaf(name: str, leaf, n: int, heads: int, kv_heads: int,
                head_dim: int):
    """The ``[n, ...]`` per-rank shards of one leaf of the port's LM
    state: ``qkv`` by heads, ``ff_up`` by its output rows, ``proj`` and
    ``ff_down`` by their input columns (``nn.Linear.weight`` is ``[out,
    in]``, the flax kernel ``[in, out]``), ``ff_down``'s bias divided by
    ``n``, the MoE expert leaves by their leading expert dim, every other
    leaf (the MoE router too) tiled."""
    layer, kind = _tp_layer(name) or (None, None)
    if _expert_leaf(layer):
        if leaf.shape[0] % n:
            raise ValueError(f"n_experts={leaf.shape[0]} must divide the "
                             f"model-axis size {n} (leaf {name})")
        return stack_tp_params(leaf, n, 0)
    if layer == "qkv" and kind == "weight":
        return shard_qkv_columns(leaf.t(), heads, kv_heads, head_dim,
                                 n).transpose(1, 2)
    if layer in _ROW_SHARDED and kind == "weight":
        return stack_tp_params(leaf, n, 1)
    if layer == "ff_up":
        return stack_tp_params(leaf, n, 0)
    if layer == "ff_down" and kind == "bias":
        leaf = leaf / n
    return torch.stack([leaf] * n)


def _tp_check(model, n: int) -> None:
    """The JAX engine's divisibility check of a tensor-parallel mesh: the
    heads and kv heads, and ``d_ff`` unless the model is MoE (its experts
    shard by expert, so ``n_experts`` must divide instead)."""
    moe = model.n_experts > 0
    if model.num_heads % n or model.kv_heads % n or (
            not moe and model.d_ff % n):
        raise ValueError(
            f"heads={model.num_heads}/kv={model.kv_heads}/d_ff={model.d_ff} "
            f"must divide the model-axis size {n}")
    if moe and model.n_experts % n:
        raise ValueError(
            f"n_experts={model.n_experts} must divide the model-axis size "
            f"{n} — expert shards live on the TP mesh")


def shard_lm_params(model, state, n: int) -> dict:
    """Stack a :class:`~chainermn_tpu_torch.models.transformer.
    TransformerLM` state dict (``model.state_dict()``, or the names that
    :func:`~chainermn_tpu_torch.convert.lm_state_from_flax` gives) into
    ``[n, ...]`` per-rank shards for tensor-parallel decode; rank ``r``
    of the group loads ``[r]`` (:func:`tp_local_model` does).

    The JAX ``shard_lm_params`` map in the port's layout: the ``qkv``
    weight head-sharded (each rank's ``Hq / n`` query heads, then its
    ``Hkv / n`` key and value heads, as :func:`~chainermn_tpu_torch.
    parallel.tensor.shard_qkv_columns` cuts the flax kernel), ``proj``
    and ``ff_down`` weights split along their input dim (the kernel's
    rows), ``ff_up``'s weight and bias along the output dim, ``ff_down``'s
    bias stored as ``bias / n`` so the row-parallel all-reduce
    reassembles it (exactly, for ``n`` a power of two), the MoE expert
    leaves (``moe_w_up``, ``moe_b_up``, ``moe_w_down``, ``moe_b_down``)
    sliced on their leading ``E`` dim (shard ``i`` owns experts ``[i E/n,
    (i+1) E/n)``), and every other leaf (embeddings, norms, learned
    positions, the MoE router) tiled. ``model`` gives the full widths."""
    heads, kv, hd = model.num_heads, model.kv_heads, model.head_dim
    return {name: _stack_leaf(name, leaf, n, heads, kv, hd).contiguous()
            for name, leaf in state.items()}


def unshard_lm_params(model, stacked) -> dict:
    """Inverse of :func:`shard_lm_params`: the full state dict from its
    ``[n, ...]`` stacks. ``ff_down``'s bias, stored divided by ``n``, is
    the sum of its shards."""
    heads, kv, hd = model.num_heads, model.kv_heads, model.head_dim
    out = {}
    for name, leaf in stacked.items():
        n = leaf.shape[0]
        layer, kind = _tp_layer(name) or (None, None)
        if _expert_leaf(layer):  # [n, E/n, ...] -> [E, ...]
            out[name] = leaf.reshape(-1, *leaf.shape[2:])
        elif layer == "qkv" and kind == "weight":
            ql, kl = heads // n * hd, kv // n * hd
            out[name] = torch.cat(
                [leaf[:, :ql].reshape(-1, leaf.shape[-1]),
                 leaf[:, ql:ql + kl].reshape(-1, leaf.shape[-1]),
                 leaf[:, ql + kl:].reshape(-1, leaf.shape[-1])], dim=0)
        elif layer in _ROW_SHARDED and kind == "weight":
            out[name] = torch.cat(list(leaf), dim=1)
        elif layer == "ff_up":
            out[name] = torch.cat(list(leaf), dim=0)
        elif layer == "ff_down" and kind == "bias":
            out[name] = leaf.sum(0)
        else:
            out[name] = leaf[0]
    return out


def tp_local_model(model, group, **clone_kw):
    """This rank's shard of ``model`` for tensor parallelism over
    ``group`` (a process group or communicator): a clone at ``Hq / n``
    heads, ``Hkv / n`` kv heads and ``d_ff / n`` with ``tp_group=group``
    and this rank's weights loaded, sharing ``model``'s replicated
    leaves. An MoE model keeps the full ``d_ff`` and holds this rank's
    ``E / n`` experts, with ``expert_axis=group`` (the ownership-split
    form). ``clone_kw`` are more :meth:`TransformerLM.clone` fields.
    Raises the JAX engine's ``ValueError`` when a width does not divide
    the group size."""
    g = as_group(group)
    n, r = dist.get_world_size(g), dist.get_rank(g)
    _tp_check(model, n)
    moe = model.n_experts > 0
    if moe:
        clone_kw = dict(expert_axis=group,
                        moe_experts_local=model.n_experts // n, **clone_kw)
    local = model.clone(num_heads=model.num_heads // n,
                        num_kv_heads=model.kv_heads // n,
                        d_ff=model.d_ff if moe else model.d_ff // n,
                        head_dim=model.head_dim, tp_group=group, **clone_kw)
    heads, kv, hd = model.num_heads, model.kv_heads, model.head_dim
    mine = local.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, leaf in model.state_dict(keep_vars=True).items():
            if mine[name] is not leaf:  # the clone's own sharded layers
                mine[name].copy_(_stack_leaf(name, leaf, n, heads, kv,
                                             hd)[r])
    return local


#: engines built with an NCCL mesh in this process (the device check's
#: store keys must differ from one engine to the next)
_NCCL_CHECKS = itertools.count()


def _check_nccl_devices(group, device) -> None:
    """Refuse an NCCL group whose ranks share a card (NCCL refuses two
    ranks on one device; the engine does not switch backend for it):
    every rank posts its card's UUID in the group's store, before any
    NCCL collective."""
    n = dist.get_world_size(group)
    if n == 1 or dist.get_backend(group) != "nccl":
        return
    from torch.distributed.distributed_c10d import (
        _get_process_group_store,
    )

    store = _get_process_group_store(group)
    prefix = f"cmt_tp_devices/{next(_NCCL_CHECKS)}/"
    store.set(prefix + str(dist.get_rank(group)),
              str(torch.cuda.get_device_properties(device).uuid))
    keys = [prefix + str(r) for r in range(n)]
    store.wait(keys)
    uuids = [store.get(k).decode() for k in keys]
    if len(set(uuids)) < n:
        raise ValueError(
            f"mesh= is an NCCL group of {n} ranks on {len(set(uuids))} "
            "device(s): NCCL needs one card per rank (a tensor-parallel "
            "group on one card must be gloo over CUDA tensors)")


class ServingEngine:
    """Fixed-slot continuous-batching decode over a ``TransformerLM``.

    Args:
      model: the :class:`~chainermn_tpu_torch.models.transformer.
        TransformerLM` to serve (its weights stay where they are; the
        engine serves through a clone carrying ``decode_attend_impl``).
      num_slots: concurrent requests per decode step.
      max_len: serving horizon (prompt + generated) per request; defaults
        to ``model.max_len``. Block tables are sized to it.
      decode_impl: ``'paged'`` or ``'dense'`` (no allocator: the pool
        accessors return None).
      decode_attend_impl: ``'fused'`` (CUDA kernel; plain version on the
        CPU) or ``'xla'`` (gather + torch ops).
      kv_block_size: tokens per pool block (default 64; paged only).
      num_blocks: pool capacity in blocks including scratch block 0;
        default is the no-oversubscription worst case
        (:func:`~chainermn_tpu_torch.serving.kv_blocks.default_num_blocks`).
      prefill_buckets: prompt-length ladder of the prefill.
      temperature / top_k / top_p: sampling, shared with ``generate``
        (temperature 0 = greedy argmax).
      base_seed: the sampling base key is ``PRNGKey(base_seed)``.
      rng: an explicit base key (``[2]`` uint32 key words) in place of
        ``base_seed``; passing both is refused.
      pad_id: prompt right-padding token for the bucketed prefill.
      prefix_cache: ``'off'``; under ``'dense'`` any valid value is
        forced off (dense rows are slot-private).
      mesh: a process group or communicator (the JAX ``'model'`` axis):
        tensor-parallel decode over its ranks, each serving through its
        shard of ``model`` (:func:`tp_local_model`). Every rank builds the
        engine over the same weights and serves the same requests. Heads,
        kv heads and ``d_ff`` must divide its size (an MoE model: heads,
        kv heads and ``n_experts``, whose experts live on its ranks, with
        ``moe_dispatch_impl`` ``'sort'`` or ``'einsum'``); an NCCL group
        must hold one card per rank.
      device: where the caches live; ``None`` means the CUDA card and
        raises without one. Must be the model's device.

    The other JAX options (``spec_tokens``, the prefix cache,
    ``prefill_chunk``, ``prefill_seq_parallel``, ``adapter_bank``,
    ``'auto'`` registry resolution) raise ``NotImplementedError`` when
    set.
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
                 base_seed: int = 0, rng=None,
                 pad_id: int = 0, mesh=None, spec_tokens=0,
                 prefix_cache="off", prefill_chunk=0,
                 prefill_seq_parallel="off", adapter_bank=None,
                 device=None) -> None:
        if not isinstance(model, TransformerLM):
            raise TypeError(f"ServingEngine serves TransformerLM, got "
                            f"{type(model).__name__}")
        if decode_impl == "auto":
            raise _not_ported("decode_impl='auto'",
                              "item 8, the tuning registry's 'auto' knobs")
        if decode_impl not in DECODE_IMPLS:
            raise ValueError(f"decode_impl must be one of "
                             f"{DECODE_IMPLS + ('auto',)}, got "
                             f"{decode_impl!r}")
        dense = decode_impl == "dense"
        if decode_attend_impl == "auto" or (
                kv_block_size == "auto" and not dense):
            raise _not_ported("'auto' decode_attend_impl/kv_block_size",
                              "the tuning registry's 'auto' knobs")
        if decode_attend_impl not in DECODE_ATTEND_IMPLS:
            raise ValueError(f"decode_attend_impl must be one of "
                             f"{DECODE_ATTEND_IMPLS}, got "
                             f"{decode_attend_impl!r}")
        if mesh is not None and prefill_seq_parallel != "off":
            raise _not_ported(
                f"prefill_seq_parallel={prefill_seq_parallel!r} with mesh=",
                "sequence-parallel prefill, item 7")
        if spec_tokens != 0:
            raise _not_ported(f"spec_tokens={spec_tokens!r}",
                              "speculative decoding")
        if prefix_cache != "auto" and prefix_cache not in PREFIX_CACHE:
            raise ValueError(f"prefix_cache must be one of "
                             f"{PREFIX_CACHE + ('auto',)}, got "
                             f"{prefix_cache!r}")
        if dense:
            prefix_cache = "off"  # dense rows are slot-private
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
        if rng is not None and base_seed:
            raise ValueError(
                "pass base_seed= (an integer) OR rng= (an explicit base "
                "key), not both — they name the same randomness source")
        _validate_filters(model.vocab_size, temperature, top_k, top_p)
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
        self.decode_impl = decode_impl
        self.decode_attend_impl = decode_attend_impl
        self.prefix_cache_enabled = False
        self.temperature = float(temperature)
        self.top_k, self.top_p = top_k, top_p
        # Counter-based sampling: one base key and a per-slot request
        # seed row; token i of the request in slot s draws with
        # fold_in(fold_in(_base_key, _seeds[s]), i).
        self.base_seed = int(base_seed)
        self._base_key = (prng.PRNGKey(self.base_seed) if rng is None
                          else prng._as_key(rng)).to(self.device)
        self._seeds = np.zeros(num_slots, np.int64)
        self._seeds_dev = None  # device copy of the seeds...
        self._seeds_ver = 0     # ...valid while the version holds
        self._seeds_dev_ver = -1
        self._buckets = tuple(
            b for b in sorted(set(prefill_buckets)) if b <= max_len
        ) or (max_len,)
        if self._buckets[-1] < max_len:
            # the ladder must be able to carry a full-horizon prompt
            self._buckets = self._buckets + (max_len,)

        clone_kw = dict(decode_attend_impl=decode_attend_impl,
                        kv_layout=decode_impl, decode_cache_len=max_len)
        #: the tensor-parallel group (None without ``mesh=``) and its size
        self.mesh = None if mesh is None else as_group(mesh)
        self.tp_size = 1
        if mesh is None:
            self._decode_model = model.clone(**clone_kw)
        else:
            self.tp_size = dist.get_world_size(self.mesh)
            _tp_check(model, self.tp_size)
            if model.n_experts > 0:  # the ownership-split form dispatches
                from chainermn_tpu_torch.parallel.moe import (
                    resolve_dispatch_impl,
                )

                resolve_dispatch_impl(-(-num_slots // self.tp_size),
                                      model.n_experts, model.d_model,
                                      model.compute_dtype,
                                      model.moe_dispatch_impl)
            _check_nccl_devices(self.mesh, self.device)
            self._decode_model = tp_local_model(model, mesh, **clone_kw)
        if dense:
            self.kv_block_size = None
            self._alloc = None
            self._cache = init_serving_cache(
                self._decode_model, num_slots=num_slots, device=self.device)
        else:
            self.kv_block_size = int(kv_block_size)
            num_blocks = num_blocks or default_num_blocks(
                num_slots, self.kv_block_size, max_len)
            self._alloc = BlockAllocator(num_blocks, self.kv_block_size,
                                         num_slots, max_len)
            self._cache = init_serving_cache(
                self._decode_model, num_blocks=num_blocks,
                block_size=self.kv_block_size, device=self.device)
        self._positions = np.zeros(num_slots, np.int64)
        self._last_tok = np.zeros(num_slots, np.int64)
        self._active = np.zeros(num_slots, bool)
        self._free = list(range(num_slots - 1, -1, -1))
        self._tables_dev = None  # device copy of the block tables...
        self._tables_ver = -1    # ...valid while allocator.version holds
        #: most pool blocks slots held at once (scratch excluded; 0 under
        #: the dense layout).
        self.peak_blocks_in_use = 0

    # ------------------------------------------------------------------

    def _tables_device(self):
        """The block tables as a CACHED device tensor, re-uploaded only
        when the allocator actually mutated a row — the steady-state
        decode loop pays no table upload per step. None under the dense
        layout."""
        if self._alloc is None:
            return None
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
        if self._alloc is not None:
            self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                          self._alloc.blocks_in_use)

    def _seeds_device(self):
        """The per-slot request seeds as a CACHED device tensor,
        re-uploaded only when an admission or release changed one."""
        if self._seeds_dev is None or self._seeds_dev_ver != self._seeds_ver:
            self._seeds_dev = torch.tensor(self._seeds, device=self.device)
            self._seeds_dev_ver = self._seeds_ver
        return self._seeds_dev

    def _set_slot_seed(self, slot: int, seed) -> None:
        """Commit a slot's request seed (its 32-bit word), bumping the
        upload version only on an actual change."""
        seed = 0 if seed is None else int(seed) & 0xFFFFFFFF
        if self._seeds[slot] != seed:
            self._seeds[slot] = seed
            self._seeds_ver += 1

    def _sample(self, logits, fed, slot=None):
        """The sampling tail of every forward, over ``logits`` ``[B, V]``
        of the tokens fed at positions ``fed`` (``[B]``, or an int):
        greedy argmax at temperature 0, else one counter-keyed
        categorical draw per row, the row of ``slot`` (all slots when
        None), with counter ``fed + 1``, the position of the token drawn.
        A token thus depends only on its request's seed, its absolute
        position and its logits."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        seeds = self._seeds_device()
        if slot is not None:
            seeds = seeds[slot:slot + 1]
        keys = stream_sample_keys(self._base_key, seeds, fed + 1)
        return prng.categorical(keys, _tempered_filtered(
            logits, self.temperature, self.top_k, self.top_p))

    # ------------------------------------------------------------------
    # serving surface

    @property
    def n_active(self) -> int:
        return int(self._active.sum())

    @property
    def free_slot_count(self) -> int:
        return len(self._free)

    @property
    def num_blocks(self) -> Optional[int]:
        """Pool capacity in blocks, scratch included (None under dense)."""
        return self._alloc.num_blocks if self._alloc is not None else None

    @property
    def blocks_in_use(self) -> Optional[int]:
        """Pool blocks slots hold now (None under dense)."""
        return (self._alloc.blocks_in_use if self._alloc is not None
                else None)

    def occupancy(self) -> float:
        return self.n_active / self.num_slots

    def pool_utilization(self) -> Optional[float]:
        return self._alloc.utilization() if self._alloc is not None else None

    def kv_blocks_free(self) -> Optional[int]:
        """Free paged-pool blocks (None under dense)."""
        return self._alloc.free_blocks if self._alloc is not None else None

    def kv_signature(self) -> tuple:
        """Layout fingerprint two engines must share for KV to be portable
        between them: decode impl, paged block size, horizon, and every
        cache tensor's shape without its block (paged) or slot (dense)
        axis, with its dtype."""
        axis_sig = tuple(
            (tuple(t.shape[1:]), str(t.dtype).replace("torch.", ""))
            for layer in self._cache for _, t in sorted(layer.items()))
        return (self.decode_impl,
                self._alloc.block_size if self._alloc is not None else None,
                self.max_len, axis_sig)

    def expert_signature(self) -> Optional[tuple]:
        """MoE residency signature: None for a dense model, else
        ``(n_experts, experts_per_shard)`` with the experts this engine's
        mesh hosts on each rank (all of them without a mesh)."""
        n_experts = self._decode_model.n_experts
        if n_experts <= 0:
            return None
        return (n_experts, n_experts // self.tp_size)

    def _admit_common(self, prompt, seed=None):
        """Validate the prompt and reserve a slot (paged: plus the pool
        blocks for the whole prompt and the first decode write), and
        commit the slot's sampling seed. Returns ``(slot, prompt,
        P_len)`` with the slot POPPED from the free list, or None to
        defer (host state untouched — the scheduler retries)."""
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
        if self._alloc is not None:
            # Reserve only the REAL tokens plus the first decode write
            # (not the padded bucket: pad writes beyond the reservation
            # land in the scratch block). A deferral restores the exact
            # prior table, so it restores the version too (no needless
            # table re-upload).
            v0 = self._alloc.version
            if not self._alloc.ensure(slot, P_len + 1):
                self._alloc.release(slot)
                self._alloc.version = v0
                return None
        self._free.pop()
        self._set_slot_seed(slot, seed)
        return slot, prompt, P_len

    @torch.no_grad()
    def prefill_join(self, prompt, seed: Optional[int] = None):
        """Admit one request: claim a slot, run the bucketed prefill and
        return ``(slot, first_token, bucket)`` — or None when no slot (or
        not enough pool blocks) is free right now. ``seed`` is the
        request's sampling-stream seed (None = stream 0; ignored at
        temperature 0); the first token, at position ``P_len``, draws
        with counter ``P_len``."""
        res = self._admit_common(prompt, seed)
        if res is None:
            return None
        slot, prompt, P_len = res
        bucket = bucket_length(P_len, self._buckets)
        padded = np.full((1, bucket), self.pad_id, np.int64)
        padded[0, :P_len] = prompt
        dev = self.device
        if self._alloc is None:
            where = dict(decode_slots=torch.tensor([slot], device=dev))
        else:
            where = dict(block_tables=self._tables_device()[slot:slot + 1])
        logits = self._decode_model(
            torch.tensor(padded, device=dev), decode=True,
            decode_positions=torch.zeros(1, dtype=torch.int32, device=dev),
            cache=self._cache, **where)
        tok = int(self._sample(logits[0, P_len - 1][None], P_len - 1,
                               slot)[0])
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
            if self._alloc is not None and not self._alloc.ensure(int(s),
                                                                   p + 1):
                raise self._pool_exhausted_error()
        self._note_pool()
        t0 = time.perf_counter()
        positions = torch.tensor(self._positions, dtype=torch.int32,
                                 device=self.device)
        logits = self._decode_model(
            torch.tensor(self._last_tok[:, None], device=self.device),
            decode=True, decode_positions=positions,
            block_tables=self._tables_device(), cache=self._cache,
        )
        # the host read is the device sync: honest per-step latency
        toks = self._sample(logits[:, 0], positions).cpu().numpy()
        dur = time.perf_counter() - t0
        self._last_tok[active] = toks[active]
        self._positions[active] += 1
        return toks, dur

    def leave(self, slot: int) -> None:
        """Release a slot (host metadata, its seed and, paged, its pool
        blocks; stale writes land in the slot's own rows or the scratch
        block)."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self._active[slot] = False
        self._free.append(int(slot))
        if self._alloc is not None:
            self._alloc.release(int(slot))
        # a reused slot must never sample on a departed request's stream
        self._set_slot_seed(slot, 0)
