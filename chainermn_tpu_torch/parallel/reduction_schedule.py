"""Interchangeable gradient-reduction schedules (counterpart of
``chainermn_tpu/parallel/reduction_schedule.py``).

The gradient reduction is the one collective every data-parallel step
shares, and the right algorithm for it depends on the topology. Every
spelling of a schedule compiles to a validated composition
(:func:`~chainermn_tpu_torch.parallel.composition.compile_schedule`) and
runs through its one executor
(:func:`~chainermn_tpu_torch.parallel.composition.reduce_composed`):

- ``'flat'``: float leaves packed into ~64 MB flat buckets (the
  reference's ``_memory_utility.pack_params`` discipline), one
  all-reduce mean per bucket over the merged axes (``ar(all)``);
- ``'two_level'``: per bucket, a reduce-scatter over the last (fast,
  intra) axis, an all-reduce of the 1/n shard over the others, an
  all-gather back (``rs(intra) > ar(inter) > ag(intra)``; the reference's
  ``TwoDimensionalCommunicator`` pipeline, on a flat mesh the pinned
  reduce-scatter/all-gather decomposition);
- a composition signature (``'rs(intra)>rs(inter)>ag(inter)>ag(intra)'``,
  sliced ``'rs(data)[s0..3]>ag(data)'``) or a ``Composition`` over the
  communicator's axis names, validated against them;
- ``'zero'``: reduce-scatter, the update on this rank's 1/n chunk, and
  an all-gather (``zero_composition(axes)``): structural, run by
  :class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` through
  :class:`~chainermn_tpu_torch.parallel.zero.ZeroShardOptimizer` over
  the composition's groups (the scatter over the last axis, the others'
  all-reduce after it).

Each rank is a process here, and an axis a process group:
:func:`reduce_tree` takes this rank's gradients (a list of tensors) and
returns their means, bucket by bucket, on the fp32, bf16 (fp16) or int8
wire. The int8 wire is a wire, not a schedule: its flat rendering is the
two-phase quantized all-reduce, its two-level one quantizes only the
shard crossing the inter axes, and their sliced spellings run one wire
a slice; any other composition is refused on it.

:class:`OverlappedBucketReducer` is the eager double-buffered driver:
``dispatch`` starts each bucket's all-reduce without waiting, ``collect``
waits for them (the staleness-1 loop, overlapping step N's reduction
with step N+1's backward). :class:`MeasuredComposedReducer` runs a
composition stage by stage, waiting for each, and times every stage.

Left for later, each raising with its ROADMAP item: ``'auto'``,
:func:`resolve_schedule` and :func:`resolve_comp_slices` (queue 8, the
tuning registry); the trace ``pack``/``wire`` events (queue 8, the
recorder).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel import composition as K

#: the named strategies
SCHEDULES = ("flat", "two_level", "zero")

#: ~64 MB: the bucket size when none is given (the JAX table default of
#: ``allreduce_bucket_mb``; the tuned size is ROADMAP queue 8's)
DEFAULT_BUCKET_BYTES = 64 << 20


def _names(axes) -> tuple:
    """Axis names: ``axes`` itself when it is a sequence of names, else
    the names of its :func:`~chainermn_tpu_torch.parallel.collectives.
    axis_groups_of` binding."""
    if isinstance(axes, (tuple, list)) and axes and all(
            isinstance(a, str) for a in axes):
        return tuple(axes)
    return C.axis_groups_of(axes).names


def check_schedule(schedule, axes=None):
    """``schedule`` validated. None and ``'zero'`` (structural) come back
    as they are. With ``axes`` (axis names, a communicator or an
    ``AxisGroups``) every other spelling — ``'flat'``, ``'two_level'``,
    a signature, a ``Composition`` — comes back compiled into a
    ``Composition`` bound to their names and validated; without them a
    signature is only parsed and a name returned as it is. ``'auto'``
    raises ``NotImplementedError`` naming ROADMAP queue 8; anything else
    a ``ValueError`` naming the menu."""
    if schedule is None or schedule == "zero":
        return schedule
    if schedule == "auto":
        raise NotImplementedError(
            "reduction_schedule='auto' is not ported yet (ROADMAP queue 8, "
            "tuning: the schedule resolved through the registry)")
    menu = (None, "auto") + SCHEDULES
    is_sig = isinstance(schedule, str) and (">" in schedule
                                            or "(" in schedule)
    if not (is_sig or schedule in SCHEDULES
            or isinstance(schedule, K.Composition)):
        raise ValueError(f"unknown schedule {schedule!r}: "
                         f"reduction_schedule must be one of {menu}, a "
                         f"composition signature, or a Composition")
    try:
        if axes is None:
            return K.parse_signature(schedule) if is_sig else schedule
        return K.compile_schedule(schedule, _names(axes))
    except K.CompositionError as e:
        raise ValueError(f"reduction_schedule must be one of {menu}, a "
                         f"composition signature, or a Composition; got "
                         f"{schedule!r} ({e})") from None


def int8_rendering(comp: K.Composition, axes: C.AxisGroups):
    """The int8 wire's rendering of ``comp`` over ``axes``: for ``flat``
    and its sliced spellings ``fn(x)`` =
    :func:`~chainermn_tpu_torch.parallel.collectives.int8_allreduce_mean`
    over every axis merged, for ``two_level`` and its
    :func:`~chainermn_tpu_torch.parallel.collectives.
    int8_two_level_allreduce_mean` with the last axis as intra and the
    others merged as inter (one axis: the flat wire). Any other
    composition raises ``ValueError``."""
    names = axes.names
    base = dataclasses.replace(K.compact_slices(comp), slices=1,
                               slice_layout="contiguous").signature()
    flat = base == K.flat_composition(names).signature()
    if not flat and base != K.two_level_composition(names).signature():
        raise ValueError(
            f"the int8 two-phase wire has flat and two-level renderings "
            f"only (sliced spellings of those included) — composition "
            f"{comp.signature()!r} cannot ride it; use the bf16/f32 wire "
            "for composed schedules")
    if flat or len(names) == 1:
        return lambda x: C.int8_allreduce_mean(x, axes.merged(names))
    return lambda x: C.int8_two_level_allreduce_mean(
        x, axes.merged(names[-1:]), axes.merged(names[:-1]))


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


def resolve_comp_slices(device_kind, payload_bytes, world_shape):
    """The ``comp_slices`` decision (how many slices a composed
    reduction cuts its buckets into). Not ported yet: a decision of the
    tuning registry (ROADMAP queue 8), measured on the H100."""
    raise NotImplementedError(
        "resolve_comp_slices is not ported yet (ROADMAP queue 8, tuning: "
        "the comp_slices decision)")


def _is_float(dt: torch.dtype) -> bool:
    return dt.is_floating_point


def _wire_of(dt: torch.dtype, compress_dtype) -> torch.dtype:
    """The dtype a leaf of ``dt`` packs in: the compressed dtype for a
    float leaf (fp32 for the int8 wire, which quantizes per bucket
    inside the wire), else its own."""
    if compress_dtype is None or not _is_float(dt):
        return dt
    return torch.float32 if compress_dtype == torch.int8 else compress_dtype


def reduce_tree(grads: Sequence[torch.Tensor], *, schedule, axes,
                compress_dtype=None,
                bucket_bytes: Optional[int] = None) -> list:
    """The bucketed, schedule-pinned MEAN of this rank's gradients over
    ``axes`` (a communicator, an ``AxisGroups``, or a group or sequence
    of groups named ``a0, a1, ...`` by position): a new list of tensors
    shaped and typed as ``grads``.

    ``schedule`` is compiled against the axes' names
    (:func:`check_schedule`): ``'flat'``, ``'two_level'``, a signature or
    a ``Composition`` without a sharded update. Leaves are grouped by
    wire dtype (``compress_dtype``: None, a float dtype, or
    ``torch.int8``) and packed into ~``bucket_bytes`` flat buffers
    (:func:`bucket_partition`); each bucket runs through
    :func:`~chainermn_tpu_torch.parallel.composition.reduce_composed`.
    On the int8 wire the buckets pack in fp32 and run
    :func:`int8_rendering`'s wire, one a slice for a sliced spelling
    (each slice quantized against its own max-abs). Zero-size leaves take
    the exact per-leaf path."""
    ag = C.axis_groups_of(axes)
    comp = check_schedule(schedule, ag)
    if comp is None or comp == "zero" or comp.has_update:
        valid = tuple(s for s in SCHEDULES if s != "zero")
        raise ValueError(
            f"reduce_tree runs the pure reduction schedules {valid} (or "
            f"any validated composition without a sharded_update stage), "
            f"got {schedule!r} — the sharded update is structural, see "
            "MultiNodeOptimizer's 'zero' schedule")
    int8 = compress_dtype == torch.int8
    wire_fn = int8_rendering(comp, ag) if int8 else None
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
                    red = _int8_sliced(flat, comp, wire_fn)
                else:
                    red = K.reduce_composed(flat, comp, ag)
                off = 0
                for i in bidx:
                    n = sizes[i]
                    out[i] = (red[off:off + n].reshape(leaves[i].shape)
                              .to(leaves[i].dtype))
                    off += n
    return out


def _int8_sliced(flat, comp, fn):
    """The int8 wire ``fn`` once a slice of ``comp``'s cut (the whole
    bucket unsliced)."""
    zigzag = comp.slice_layout == "zigzag"
    parts = K._cut(flat, K.effective_slices(comp.slices, flat.numel()),
                   zigzag)
    return K._join([fn(p) for p in parts], zigzag)


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
            s_eff = K.effective_slices(self.slices, flat.numel())
            for lo, hi in K.slice_bounds(flat.numel(), s_eff):
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


class MeasuredComposedReducer:
    """Eager per-STAGE composed reduction, timed stage by stage::

        red = MeasuredComposedReducer(comm, schedule="two_level")
        means = red.reduce(grads)   # this rank's tensors -> their means
        red.stages                  # one row a stage: signature, call,
                                    # bytes, seconds

    ``reduce`` packs this rank's gradients into ONE flat fp32 buffer,
    runs the composition on it as a sum (a sliced one slice by slice, in
    :func:`~chainermn_tpu_torch.parallel.composition.expand_slices`
    order), waits for each stage before the next (the card synchronised,
    so a stage's wall clock is its own), divides by the ranks at the end
    and unpacks the means. A stage's row carries its bytes by
    :func:`~chainermn_tpu_torch.parallel.composition.stage_wire_layout`
    and ``dur_s``; the trace ``wire`` events they feed in the JAX package
    wait for the recorder (ROADMAP queue 8). Pure reductions only: a
    ``sharded_update`` stage is refused (its fuse point is the
    optimizer's ``'zero'`` schedule)."""

    def __init__(self, comm, schedule="two_level", *,
                 slices: int = 1) -> None:
        self.comm = comm
        self.axes = C.axis_groups_of(comm)
        self.comp = K.compile_schedule(schedule, self.axes.names)
        if self.comp.has_update:
            raise K.CompositionError(
                f"{self.comp.signature()!r} carries a sharded_update "
                "stage — the eager measured reducer runs pure "
                "reductions (the update fuse point is "
                "MultiNodeOptimizer's 'zero' schedule)")
        if int(slices) > 1:
            self.comp = K.sliced_composition(self.comp, int(slices))
        #: the last reduce's stages: dicts of ``stage``, ``op``,
        #: ``nbytes``, ``dur_s`` (and ``slice``/``n_slices`` when sliced)
        self.stages: list = []

    def reduce(self, grads: Sequence[torch.Tensor]) -> list:
        """The means of this rank's ``grads`` over the communicator's
        axes, shaped and typed as they are; records :attr:`stages`."""
        leaves = [g.detach() for g in grads]
        device = leaves[0].device if leaves else torch.device("cpu")
        flat = (torch.cat([g.float().reshape(-1) for g in leaves])
                if leaves else torch.zeros(0, device=device))

        def sync():
            if flat.is_cuda:
                torch.cuda.synchronize(flat.device)

        total, self.stages = K.run_stages_measured(flat, self.comp,
                                                   self.axes, sync=sync)
        mean = total / self.axes.size(self.axes.names)
        out, off = [], 0
        for g in leaves:
            k = g.numel()
            out.append(mean[off:off + k].reshape(g.shape).to(g.dtype))
            off += k
        return out


__all__ = ["DEFAULT_BUCKET_BYTES", "MeasuredComposedReducer",
           "OverlappedBucketReducer", "SCHEDULES", "bucket_partition",
           "check_schedule", "int8_rendering", "reduce_tree",
           "resolve_comp_slices", "resolve_schedule"]
