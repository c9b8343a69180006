"""Interchangeable gradient-reduction schedules (counterpart of
``chainermn_tpu/parallel/reduction_schedule.py``).

The gradient reduction is the one collective every data-parallel step
shares, and the right algorithm for it depends on the topology. The
named schedules:

- ``'flat'``: float leaves packed into ~64 MB flat buckets (the
  reference's ``_memory_utility.pack_params`` discipline), one
  all-reduce mean per bucket over the merged axes (``ar(all)``);
- ``'two_level'``: per bucket, a reduce-scatter over the last (fast,
  intra) axis, an all-reduce of the 1/n shard over the others, an
  all-gather back (``rs(intra) > ar(inter) > ag(intra)``; the reference's
  ``TwoDimensionalCommunicator`` pipeline, on a flat mesh the pinned
  reduce-scatter/all-gather decomposition);
- ``'zero'``: reduce-scatter, the update on this rank's 1/n chunk, and
  an all-gather: structural, run by
  :class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` through
  :class:`~chainermn_tpu_torch.parallel.zero.ZeroShardOptimizer`.

Each rank is a process here, and an axis a process group:
:func:`reduce_tree` takes this rank's gradients (a list of tensors) and
returns their means, bucket by bucket, on the fp32, bf16 (fp16) or int8
wire, written over :mod:`~chainermn_tpu_torch.parallel.collectives`'
staged primitives. The int8 wire is a wire, not a schedule: its flat
rendering is the two-phase quantized all-reduce, its two-level one
quantizes only the shard crossing the inter axes.

:class:`OverlappedBucketReducer` is the eager double-buffered driver:
``dispatch`` starts each bucket's all-reduce without waiting, ``collect``
waits for them (the staleness-1 loop, overlapping step N's reduction
with step N+1's backward).

Left for later, each raising with its ROADMAP item: ``'auto'`` and
:func:`resolve_schedule` (queue 8, the tuning registry); composition
signature strings, ``Composition`` objects and their sliced spellings,
``resolve_comp_slices`` and ``MeasuredComposedReducer`` (queue 6.7,
``composition.py``); the trace ``pack``/``wire`` events (queue 8, the
recorder).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from chainermn_tpu_torch.parallel import collectives as C

#: the named strategies
SCHEDULES = ("flat", "two_level", "zero")

#: ~64 MB: the bucket size when none is given (the JAX table default of
#: ``allreduce_bucket_mb``; the tuned size is ROADMAP queue 8's)
DEFAULT_BUCKET_BYTES = 64 << 20


def check_schedule(schedule) -> None:
    """Raise unless ``schedule`` is None or a named schedule: ``'auto'``
    names ROADMAP queue 8, a composition (a signature string or object)
    queue 6.7, anything else is a ``ValueError``."""
    if schedule is None or schedule in SCHEDULES:
        return
    if schedule == "auto":
        raise NotImplementedError(
            "reduction_schedule='auto' is not ported yet (ROADMAP queue 8, "
            "tuning: the schedule resolved through the registry)")
    if not isinstance(schedule, str) or ">" in schedule or "(" in schedule:
        raise NotImplementedError(
            f"composed reduction schedule {schedule!r} is not ported yet "
            "(ROADMAP queue 6.7, composition.py)")
    raise ValueError(f"reduction_schedule must be one of "
                     f"{(None,) + SCHEDULES}, got {schedule!r}")


def bucket_partition(idxs: Sequence[int], sizes: Sequence[int],
                     itemsize: int = 4,
                     bucket_bytes: Optional[int] = None) -> list:
    """Deterministic greedy ~``bucket_bytes`` partition of the entries
    ``idxs`` (element counts in ``sizes``): the one bucket layout every
    schedule, the error-feedback residual and the overlapped reducer
    share.

    Edge contract: zero-size entries are skipped (their callers reduce
    them on the exact per-leaf path); a payload smaller than one bucket
    is exactly one bucket; an entry larger than the bucket gets its own
    bucket, unsplit; no bucket is empty."""
    if bucket_bytes is None:
        bucket_bytes = DEFAULT_BUCKET_BYTES
    buckets: list = []
    cur: list = []
    cur_bytes = 0
    for i in idxs:
        nbytes = sizes[i] * itemsize
        if nbytes == 0:
            continue
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def resolve_schedule(device_kind, payload_bytes, world_shape, *,
                     candidates=None, slices=None):
    """The ``reduction_schedule='auto'`` resolution. Not ported yet: it
    is a decision of the tuning registry (ROADMAP queue 8), whose
    entries the port measures on the H100 itself."""
    raise NotImplementedError(
        "resolve_schedule is not ported yet (ROADMAP queue 8, tuning: "
        "the 'auto' schedule)")


def _is_float(dt: torch.dtype) -> bool:
    return dt.is_floating_point


def _wire_of(dt: torch.dtype, compress_dtype) -> torch.dtype:
    """The dtype a leaf of ``dt`` packs in: the compressed dtype for a
    float leaf (fp32 for the int8 wire, which quantizes per bucket
    inside the wire), else its own."""
    if compress_dtype is None or not _is_float(dt):
        return dt
    return torch.float32 if compress_dtype == torch.int8 else compress_dtype


def _mean_flat(flat: torch.Tensor, names: tuple) -> torch.Tensor:
    """``ar(all)``: the sum over the merged axes, divided by their size,
    in the bucket's dtype."""
    return C.staged_allreduce(flat, names) / C.axes_size(names)


def _mean_two_level(flat: torch.Tensor, names: tuple) -> torch.Tensor:
    """``rs(fast) > ar(rest) > ag(fast)``, divided where the reduction
    completes (after the all-reduce; after the scatter on one axis)."""
    fast, rest = names[-1:], names[:-1]
    shard = C.staged_reduce_scatter(flat, fast)
    if rest:
        shard = C.staged_allreduce(shard, rest)
    shard = shard / C.axes_size(names)
    return C.staged_allgather(shard, fast, flat.numel())


def reduce_tree(grads: Sequence[torch.Tensor], *, schedule, axes,
                compress_dtype=None,
                bucket_bytes: Optional[int] = None) -> list:
    """The bucketed, schedule-pinned MEAN of this rank's gradients over
    the merged ``axes`` (a group or a sequence of groups): a new list of
    tensors shaped and typed as ``grads``.

    Leaves are grouped by wire dtype (``compress_dtype``: None, a float
    dtype, or ``torch.int8``) and packed into ~``bucket_bytes`` flat
    buffers (:func:`bucket_partition`); each bucket crosses the wire as
    ``schedule`` says (``'flat'`` or ``'two_level'``). On the int8 wire
    the buckets pack in fp32 and the flat schedule runs
    :func:`~chainermn_tpu_torch.parallel.collectives.int8_allreduce_mean`,
    the two-level one :func:`~chainermn_tpu_torch.parallel.collectives.
    int8_decomposed_allreduce_mean`.
    Zero-size leaves take the exact per-leaf path."""
    check_schedule(schedule)
    if schedule is None or schedule == "zero":
        raise ValueError(
            f"reduce_tree runs the pure reduction schedules ('flat', "
            f"'two_level'), got {schedule!r}: the 'zero' schedule's sharded "
            "update is structural (MultiNodeOptimizer)")
    names = C._axes(axes)
    int8 = compress_dtype == torch.int8
    leaves = list(grads)
    out: list = [None] * len(leaves)
    groups: dict = {}
    for i, g in enumerate(leaves):
        groups.setdefault(_wire_of(g.dtype, compress_dtype), []).append(i)
    sizes = [g.numel() for g in leaves]
    with torch.no_grad():
        for dt, idxs in groups.items():
            buckets = bucket_partition(idxs, sizes, dt.itemsize,
                                       bucket_bytes)
            bucketed = {i for b in buckets for i in b}
            for i in idxs:
                if i not in bucketed:  # zero-size: its own mean
                    out[i] = leaves[i].clone()
            for bidx in buckets:
                flat = torch.cat([leaves[i].detach().to(dt).reshape(-1)
                                  for i in bidx])
                if int8 and _is_float(dt):
                    red = (C.int8_allreduce_mean(flat, names)
                           if schedule == "flat"
                           else C.int8_decomposed_allreduce_mean(flat, names))
                elif schedule == "flat":
                    red = _mean_flat(flat, names)
                else:
                    red = _mean_two_level(flat, names)
                off = 0
                for i in bidx:
                    n = sizes[i]
                    out[i] = (red[off:off + n].reshape(leaves[i].shape)
                              .to(leaves[i].dtype))
                    off += n
    return out


def _effective_slices(slices: int, n_elems: int) -> int:
    """``min(slices, n_elems)``, at least 1 (a bucket smaller than the
    slice count cuts into fewer slices)."""
    return max(1, min(int(slices), int(n_elems)))


def _slice_bounds(n_elems: int, n_slices: int) -> list:
    """Balanced contiguous ``[start, end)`` bounds (the first ``n %
    S`` slices one element longer)."""
    base, rem = divmod(int(n_elems), int(n_slices))
    out, lo = [], 0
    for i in range(int(n_slices)):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


class OverlappedBucketReducer:
    """Eager double-buffered per-bucket gradient reduction over a
    communicator's group::

        red = OverlappedBucketReducer(comm)
        red.dispatch(grads_t)           # every bucket's all-reduce starts
        ...step t+1's backward...       # overlaps the wire
        mean_t = red.collect()          # waits for what is left

    ``dispatch`` packs this rank's gradients into fp32 buckets of
    ``bucket_bytes`` (:func:`bucket_partition`), cuts each into
    ``min(slices, elements)`` contiguous slices, and starts one
    all-reduce per slice with ``async_op=True``; ``collect`` waits for
    each, divides by the group's size and unpacks the means into tensors
    shaped and typed as the gradients (zero-size ones as they are). On a
    gloo group a CUDA bucket is reduced through a host copy."""

    def __init__(self, comm, *, bucket_bytes: Optional[int] = None,
                 slices: int = 1) -> None:
        self.comm = comm
        self.bucket_bytes = (DEFAULT_BUCKET_BYTES if bucket_bytes is None
                             else int(bucket_bytes))
        if int(slices) < 1:
            raise ValueError(f"slices must be >= 1, got {slices}")
        self.slices = int(slices)
        self._inflight: list = []
        self._layout = None

    @property
    def in_flight(self) -> bool:
        return bool(self._inflight)

    def dispatch(self, grads: Sequence[torch.Tensor]) -> int:
        """Start this step's per-bucket all-reduces; returns the bucket
        count. The previous step's must have been collected."""
        if self._inflight:
            raise RuntimeError(
                "a bucketed reduction is already in flight: collect() the "
                "previous step before dispatching the next")
        group = C._norm(self.comm)
        leaves = [g.detach() for g in grads]
        sizes = [g.numel() for g in leaves]
        buckets = bucket_partition(list(range(len(leaves))), sizes, 4,
                                   self.bucket_bytes)
        self._layout = (leaves, buckets)
        for b_i, bidx in enumerate(buckets):
            flat = torch.cat([leaves[i].float().reshape(-1) for i in bidx])
            s_eff = _effective_slices(self.slices, flat.numel())
            for lo, hi in _slice_bounds(flat.numel(), s_eff):
                part = flat[lo:hi]
                home = part.device
                if C._stage_through_host(part, group):
                    part = part.cpu()
                part = part.clone()
                work = dist.all_reduce(part, group=group, async_op=True)
                self._inflight.append((b_i, lo, part, work, home))
        return len(buckets)

    def collect(self) -> list:
        """Wait for the in-flight buckets; the means, as tensors shaped
        and typed as the dispatched gradients."""
        if not self._inflight:
            raise RuntimeError("collect() with no dispatched reduction")
        leaves, buckets = self._layout
        n = dist.get_world_size(C._norm(self.comm))
        rows: dict = {}
        for b_i, lo, part, work, home in self._inflight:
            work.wait()
            rows.setdefault(b_i, []).append((lo, part.to(home) / n))
        out = [g.clone() for g in leaves]  # zero-size leaves stay
        for b_i, bidx in enumerate(buckets):
            parts = sorted(rows[b_i], key=lambda t: t[0])
            row = torch.cat([p for _, p in parts])
            off = 0
            for i in bidx:
                k = leaves[i].numel()
                out[i] = (row[off:off + k].reshape(leaves[i].shape)
                          .to(leaves[i].dtype))
                off += k
        self._inflight = []
        self._layout = None
        return out


__all__ = ["DEFAULT_BUCKET_BYTES", "OverlappedBucketReducer", "SCHEDULES",
           "bucket_partition", "check_schedule", "reduce_tree",
           "resolve_schedule"]
