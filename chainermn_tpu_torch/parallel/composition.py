"""Topology-composed collective schedules: the composition DSL
(counterpart of ``chainermn_tpu/parallel/composition.py``).

A :class:`Composition` is an ordered tuple of :class:`Stage` s, each a
primitive over a merged group of mesh axes: ``reduce_scatter``,
``allreduce``, ``allgather``, ``sharded_update`` (the ZeRO fuse point)
and ``broadcast`` (a multicast tree). Each prints as a stable signature
(``"rs(a2)>ar(a0+a1)>ag(a2)"``), the spelling a schedule is named by.
Three pieces, pure Python and the same as the JAX package's:

- :func:`validate_composition` proves a composition is a correct
  mean-allreduce before anything runs (every axis reduced exactly once,
  every scatter conjugated by a gather, LIFO, the sharded update at the
  fully reduced shard), raising :class:`CompositionError` naming the
  broken invariant;
- :func:`derive_compositions` enumerates the ``2^k`` legal reductions of
  a ``k``-axis mesh (per-level ladders, merged groups); the menu's
  ``flat``, ``two_level`` and ``zero`` are derived instances;
- bucket slicing: a composition with ``slices=S`` cuts each bucket into
  ``S`` slices (contiguous runs, or the ``zigzag`` stride) and issues the
  per-slice stages in a skewed order (:func:`expand_slices`), ``S`` times
  the calls at ``1/S`` payload each.

Mesh-axis convention: names in MESH ORDER, slow first, fast last.

The executor (:func:`reduce_composed`, :func:`run_reduce_prefix`,
:func:`run_gather_suffix`, :func:`reduce_composed_tree`) runs on this
rank's tensor over the process groups an
:class:`~chainermn_tpu_torch.parallel.collectives.AxisGroups` binds to
the names (a communicator's ``axis_groups``: one group a name, the
product group of every set of names, made with the mesh), through the
staged primitives of :mod:`~chainermn_tpu_torch.parallel.collectives`.
Each stage is one ``torch.distributed`` call (:data:`STAGE_CALLS`; a
broadcast stage one ``batch_isend_irecv`` a sub-send of its tree), so
the calls a composition makes are :func:`predicted_collectives` exactly:
nothing merges them in eager mode, as XLA's compiler may merge HLO ops.
The stages run blocking, in :func:`expand_slices` order, the same order
on every rank; overlapping a sliced composition's slices with
``async_op`` handles is a later performance change that wants several
cards to measure. A merged stage written out of mesh order
(``rs(a1+a0)``) addresses its shards as ``psum_scatter`` over that
order does in JAX: its rows are permuted around the mesh-ordered
product group.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from chainermn_tpu_torch.parallel import collectives as C

#: Stage primitives. ``sharded_update`` is the ZeRO fuse point: the
#: caller's update function runs on the fully-reduced 1/n shard;
#: ``broadcast`` is the one-to-many multicast tree.
PRIMITIVES = ("reduce_scatter", "allreduce", "allgather", "sharded_update",
              "broadcast")

_SHORT = {"reduce_scatter": "rs", "allreduce": "ar", "allgather": "ag",
          "sharded_update": "su", "broadcast": "bc"}
_LONG = {v: k for k, v in _SHORT.items()}

#: The ``torch.distributed`` call each stage issues (the vocabulary the
#: port's tests count; ``sharded_update`` owes the wire nothing). A
#: ``broadcast`` stage issues one ``batch_isend_irecv`` a sub-send of its
#: tree in which this rank sends or receives (``tree_sends(n, radix)`` on
#: the root, which sends in every one); :func:`predicted_collectives`
#: multiplies them in.
STAGE_CALLS = {"reduce_scatter": "reduce_scatter_tensor",
               "allreduce": "all_reduce", "allgather": "all_gather",
               "broadcast": "batch_isend_irecv"}

#: Default multicast-tree radix (binary tree: doubling rounds).
DEFAULT_RADIX = 2


def tree_depth(n: int, radix: int = DEFAULT_RADIX) -> int:
    """Rounds a radix-``radix`` multicast tree needs to cover ``n``
    members from one root: ``ceil(log_radix(n))``, by the holder-doubling
    walk the executor runs."""
    n, r = int(n), int(radix)
    if r < 2:
        raise CompositionError(f"multicast radix must be >= 2, got {radix}")
    d, holders = 0, 1
    while holders < n:
        holders *= r
        d += 1
    return d


def tree_sends(n: int, radix: int = DEFAULT_RADIX) -> int:
    """Sub-sends a radix-``radix`` multicast over ``n`` members takes:
    each holder-doubling round is up to ``radix - 1`` of them (holder
    ``s`` -> ``s + j*holders``, one a ``j``); at radix 2 this equals
    :func:`tree_depth`. The root sends in every one of them."""
    n, r = int(n), int(radix)
    if r < 2:
        raise CompositionError(f"multicast radix must be >= 2, got {radix}")
    sends, holders = 0, 1
    while holders < n:
        for j in range(1, r):
            if j * holders < n:  # sub-send j has at least sender s=0
                sends += 1
        holders *= r
    return sends


class CompositionError(ValueError):
    """A composition failed validation; the message names the broken
    invariant."""


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: ``primitive`` over the merged axis group
    ``axes`` (empty only for ``sharded_update``).

    ``slice`` addresses the stage at ONE slice of the bucket: ``(index,
    n_slices)``, printed ``rs(a2)[s1:4]`` (the expanded rendering of a
    sliced composition, :func:`expand_slices`; ``None`` is the whole
    bucket). ``radix`` is a ``broadcast`` stage's tree fan-out (``None``
    = :data:`DEFAULT_RADIX`), printed only when not the default
    (``bc(a0+a1)@4``)."""

    primitive: str
    axes: tuple = ()
    slice: Optional[tuple] = None
    radix: Optional[int] = None

    def signature(self) -> str:
        tag = f"[s{self.slice[0]}:{self.slice[1]}]" if self.slice else ""
        if self.primitive == "sharded_update":
            return f"su{tag}"
        rad = (f"@{self.radix}"
               if self.radix is not None and self.radix != DEFAULT_RADIX
               else "")
        return f"{_SHORT[self.primitive]}({'+'.join(self.axes)}){rad}{tag}"


@dataclasses.dataclass(frozen=True)
class Composition:
    """An ordered stage list; build it with :func:`parse_signature`,
    :func:`compile_schedule` or :func:`derive_compositions`, and prove it
    with :func:`validate_composition` before running it.

    ``slices``: the count of slices the executor cuts each bucket into
    (1: the whole bucket), spelled on the FIRST stage as a range:
    ``rs(a2)[s0..3]>ar(a0+a1)>ag(a2)``. ``slice_layout``: ``'contiguous'``
    runs, or ``'zigzag'`` (slice i takes elements ``i, i+S, i+2S, ...``;
    spelled ``[z0..3]``), with the same per-slice element counts, so the
    wire layout and the call counts do not move."""

    stages: tuple
    slices: int = 1
    slice_layout: str = "contiguous"

    def signature(self) -> str:
        sigs = [s.signature() for s in self.stages]
        if self.slices > 1 and sigs:
            letter = "z" if self.slice_layout == "zigzag" else "s"
            sigs[0] = f"{sigs[0]}[{letter}0..{self.slices - 1}]"
        return ">".join(sigs)

    @property
    def has_update(self) -> bool:
        return any(s.primitive == "sharded_update" for s in self.stages)

    def split_update(self) -> tuple:
        """``(reduce_prefix, gather_suffix)`` around the
        ``sharded_update`` stage: the seam the ZeRO executors use (the
        inner optimizer runs between them, once, on every chunk)."""
        for i, s in enumerate(self.stages):
            if s.primitive == "sharded_update":
                return self.stages[:i], self.stages[i + 1:]
        raise CompositionError(
            f"composition {self.signature()!r} has no sharded_update "
            "stage to split at")

    def __str__(self) -> str:
        return self.signature()


_STAGE_RE = re.compile(
    r"^(rs|ar|ag|su|bc)(?:\(([^()]*)\))?(?:@(\d+))?"
    r"(?:\[([sz])(\d+)(?:\.\.(\d+)|:(\d+))?\])?$"
)


def parse_signature(sig: str) -> Composition:
    """Parse ``"rs(a2)>ar(a0+a1)>ag(a2)"`` back into a
    :class:`Composition`. A range ``rs(a2)[s0..3]>...`` slices the whole
    composition (S = the range's length, starting at s0; annotations on
    several stages must agree), ``[z0..3]`` in the zigzag layout;
    ``rs(a2)[s1:4]`` addresses one expanded stage at slice 1 of 4.
    ``bc(a0+a1)@4`` is a radix-4 broadcast stage (``@2``, the default, is
    never printed)."""
    stages = []
    slices: Optional[int] = None
    layout: Optional[str] = None
    for part in str(sig).split(">"):
        m = _STAGE_RE.match(part.strip())
        if not m:
            raise CompositionError(
                f"unparseable composition stage {part!r} in {sig!r} "
                "(expected e.g. 'rs(intra)', 'ar(a0+a1)', 'su', "
                "'bc(a0)@4', 'rs(a2)[s0..3]', 'rs(a2)[z0..3]', "
                "'rs(a2)[s1:4]')")
        short, axes, radix, letter, s_lo, s_hi, s_tot = m.groups()
        if radix is not None and short != "bc":
            raise CompositionError(
                f"stage {part!r}: only broadcast (bc) stages carry a "
                "multicast radix")
        stage_slice: Optional[tuple] = None
        if s_lo is not None:
            if s_tot is not None:  # [sI:S]: one expanded stage
                if letter == "z":
                    raise CompositionError(
                        f"stage {part!r}: zigzag is a composition-level "
                        "slice layout — expanded stages address slices "
                        "with [sI:S]")
                idx, tot = int(s_lo), int(s_tot)
                if not 0 <= idx < tot:
                    raise CompositionError(
                        f"stage slice [s{idx}:{tot}] in {part!r} is out "
                        "of range")
                stage_slice = (idx, tot)
            else:  # [s0..N] / [z0..N]: the composition's slice count
                lo = int(s_lo)
                hi = int(s_hi) if s_hi is not None else lo
                if lo != 0 or hi < lo:
                    raise CompositionError(
                        f"composition slice range [{letter}{lo}..{hi}] in "
                        f"{part!r} must start at {letter}0")
                n = hi + 1
                if slices is not None and slices != n:
                    raise CompositionError(
                        f"conflicting slice counts in {sig!r}: "
                        f"{slices} vs {n}")
                this_layout = "zigzag" if letter == "z" else "contiguous"
                if layout is not None and layout != this_layout:
                    raise CompositionError(
                        f"conflicting slice layouts in {sig!r}: "
                        f"{layout} vs {this_layout}")
                slices = n
                layout = this_layout
        if short == "su":
            if axes:
                raise CompositionError(
                    f"sharded_update stage carries no axes, got {part!r}")
            stages.append(Stage("sharded_update", slice=stage_slice))
        else:
            names = tuple(a for a in (axes or "").split("+") if a)
            # an explicit @2 normalizes to the default-radix spelling
            r = int(radix) if radix is not None else None
            stages.append(Stage(
                _LONG[short], names, slice=stage_slice,
                radix=(r if r != DEFAULT_RADIX else None)))
    return Composition(tuple(stages), slices=slices or 1,
                       slice_layout=layout or "contiguous")


def canonical_axis_names(k: int) -> tuple:
    """Positional axis tokens ``('a0', ..., 'a<k-1>')``: a composition
    written in them binds to any mesh of ``k`` axes by position."""
    return tuple(f"a{i}" for i in range(k))


def bind_composition(comp: Composition, axes: Sequence[str]) -> Composition:
    """Rebind a composition written over :func:`canonical_axis_names`
    onto the mesh ``axes`` by position; one already spelled in ``axes``'s
    names passes through unchanged."""
    names = tuple(axes)
    used = {a for s in comp.stages for a in s.axes}
    if used <= set(names):
        return comp
    canon = canonical_axis_names(len(names))
    if not used <= set(canon):
        raise CompositionError(
            f"composition {comp.signature()!r} names axes "
            f"{sorted(used - set(names))} that are neither on the mesh "
            f"{names} nor canonical positional tokens {canon}")
    table = dict(zip(canon, names))
    return dataclasses.replace(comp, stages=tuple(
        dataclasses.replace(s, axes=tuple(table[a] for a in s.axes))
        for s in comp.stages))


# ---------------------------------------------------------------------------
# bucket slicing
# ---------------------------------------------------------------------------

def effective_slices(slices: int, n_elems: int) -> int:
    """The slice count a bucket of ``n_elems`` elements cuts into:
    ``min(slices, n_elems)``, at least 1 (a bucket smaller than the
    requested count degrades rather than run an empty stage)."""
    s = int(slices)
    if s < 1:
        raise CompositionError(f"slices must be >= 1, got {slices}")
    return max(1, min(s, int(n_elems)))


def slice_bounds(n_elems: int, n_slices: int) -> list:
    """Balanced contiguous ``[start, end)`` bounds cutting ``n_elems``
    into ``n_slices`` slices (the first ``n % S`` one element longer):
    disjoint, covering the bucket, and never empty when ``n_slices <=
    n_elems`` (:func:`effective_slices`)."""
    n, s = int(n_elems), int(n_slices)
    if s < 1:
        raise CompositionError(f"slice count must be >= 1, got {n_slices}")
    base, rem = divmod(n, s)
    out = []
    lo = 0
    for i in range(s):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def sliced_composition(comp: Composition, slices: int,
                       layout: str = "contiguous") -> Composition:
    """``comp`` over ``slices`` bucket slices (the compact form) in
    ``layout``. Refuses a ``sharded_update`` pipeline: the fuse point runs
    the inner optimizer once on every chunk and cannot slice."""
    s = int(slices)
    if s < 1:
        raise CompositionError(f"slices must be >= 1, got {slices}")
    if layout not in ("contiguous", "zigzag"):
        raise CompositionError(
            f"slice layout must be 'contiguous' or 'zigzag', got "
            f"{layout!r}")
    if s > 1 and comp.has_update:
        raise CompositionError(
            f"{comp.signature()!r}: a sharded_update pipeline cannot be "
            "sliced — the fuse point runs the inner optimizer once on "
            "the whole chunk tree")
    return dataclasses.replace(comp, slices=s, slice_layout=layout)


def compact_slices(comp: Composition) -> Composition:
    """An EXPANDED composition (per-stage ``[sI:S]`` addresses) back in
    the compact ``slices=S`` form the executor runs (the inverse of
    :func:`expand_slices`); an unannotated one passes through. Every
    slice must run the same pipeline; the composition must have passed
    :func:`validate_composition` (this regroups, it does not prove)."""
    if not any(s.slice is not None for s in comp.stages):
        return comp
    per_slice: dict = {}
    total = 0
    for s in comp.stages:
        if s.slice is None:
            raise CompositionError(
                f"{comp.signature()!r}: stage {s.signature()!r} has no "
                "slice address while others do")
        per_slice.setdefault(s.slice[0], []).append(
            dataclasses.replace(s, slice=None))
        total = max(total, s.slice[1])
    base = per_slice.get(0)
    if base is None or sorted(per_slice) != list(range(total)):
        raise CompositionError(
            f"{comp.signature()!r}: slice indices do not cover "
            f"0..{total - 1}")
    for i, stages in per_slice.items():
        if stages != base:
            raise CompositionError(
                f"{comp.signature()!r}: slice s{i} runs a different "
                f"pipeline than slice s0 "
                f"({'>'.join(s.signature() for s in stages)} vs "
                f"{'>'.join(s.signature() for s in base)}) — only a "
                "uniform expansion has a compact executable rendering")
    return Composition(tuple(base), slices=total)


def expand_slices(comp: Composition, size: Optional[int] = None) -> tuple:
    """The sliced composition's per-slice stages in the skewed issue
    order: tick t issues stage j of slice i for every ``i + j == t``
    (later slices first within a tick), so slice i's slow stage comes
    beside slice i+1's fast one. Each stage carries its ``slice=(i, S)``.
    ``size`` (the bucket's elements) applies :func:`effective_slices`;
    an unsliced composition expands to its own stages."""
    s_eff = (effective_slices(comp.slices, size) if size is not None
             else comp.slices)
    if s_eff <= 1:
        return comp.stages
    k = len(comp.stages)
    out: list = []
    for t in range(s_eff + k - 1):
        for j in range(k):
            i = t - j
            if 0 <= i < s_eff:
                out.append(dataclasses.replace(comp.stages[j],
                                               slice=(i, s_eff)))
    return tuple(out)


def _cut(flat: torch.Tensor, s_eff: int, zigzag: bool) -> list:
    """``flat`` cut into ``s_eff`` slices: ``flat[i::S]`` copied
    contiguous in the zigzag layout (NCCL and gloo take contiguous
    buffers), else the :func:`slice_bounds` views."""
    if zigzag:
        return [flat[i::s_eff].contiguous() for i in range(s_eff)]
    return [flat[lo:hi] for lo, hi in slice_bounds(flat.numel(), s_eff)]


def _join(parts: list, zigzag: bool) -> torch.Tensor:
    """The slices of :func:`_cut` back in place, one flat buffer."""
    if len(parts) == 1:
        return parts[0]
    if not zigzag:
        return torch.cat(parts)
    s = len(parts)
    out = parts[0].new_empty(sum(p.numel() for p in parts))
    for i, p in enumerate(parts):
        out[i::s] = p
    return out


# ---------------------------------------------------------------------------
# the validator: a correct mean-allreduce
# ---------------------------------------------------------------------------

def validate_composition(comp: Composition,
                         mesh_axes: Sequence[str]) -> Composition:
    """Prove ``comp`` is a correct mean-allreduce over ``mesh_axes``
    before anything runs; each violation raises :class:`CompositionError`
    naming it:

    - the stage list is non-empty and every primitive is known;
    - every reduce/scatter/gather stage names >= 1 mesh axis, none twice;
    - every mesh axis is REDUCED EXACTLY ONCE (by a ``reduce_scatter``
      or ``allreduce`` stage);
    - each ``allgather`` closes the most recent open ``reduce_scatter``
      with the SAME axis group (LIFO), and none is left open;
    - at most one ``sharded_update``, after every reduction, before every
      gather, with a scatter open.

    Sliced compositions add: ``slices`` an integer >= 1 and no
    ``sharded_update``; an expanded one addresses every stage, with one
    total, every slice present, and each slice's stages on their own a
    complete, conjugate mean-allreduce."""
    mesh = tuple(mesh_axes)
    if not isinstance(comp, Composition):
        raise CompositionError(
            f"expected a Composition, got {type(comp).__name__}")
    if not comp.stages:
        raise CompositionError(
            "empty stage list: a composition must reduce over "
            f"{mesh} and an empty pipeline reduces nothing")
    if not isinstance(comp.slices, int) or comp.slices < 1:
        raise CompositionError(
            f"{comp.signature()!r}: slices must be an integer >= 1, "
            f"got {comp.slices!r}")
    if comp.slice_layout not in ("contiguous", "zigzag"):
        raise CompositionError(
            f"{comp.signature()!r}: slice layout must be 'contiguous' "
            f"or 'zigzag', got {comp.slice_layout!r}")
    sliced = [s for s in comp.stages if s.slice is not None]
    if comp.has_update and (comp.slices > 1 or sliced):
        raise CompositionError(
            f"{comp.signature()!r}: a sliced composition cannot carry a "
            "sharded_update stage — the ZeRO fuse point runs the inner "
            "optimizer once on the whole chunk tree and is unsliceable")
    if sliced:
        if comp.slices > 1:
            raise CompositionError(
                f"{comp.signature()!r}: both a composition-level slice "
                f"count ({comp.slices}) and per-stage slice addresses — "
                "spell one form (compact slices= OR the expanded "
                "per-stage [sI:S] addressing), not both")
        if len(sliced) != len(comp.stages):
            bare = next(s for s in comp.stages if s.slice is None)
            raise CompositionError(
                f"{comp.signature()!r}: stage {bare.signature()!r} has "
                "no slice address while others do — an expanded "
                "composition addresses every stage")
        totals = {s.slice[1] for s in comp.stages}
        if len(totals) != 1:
            raise CompositionError(
                f"{comp.signature()!r}: conflicting slice totals "
                f"{sorted(totals)} — every stage of one expansion "
                "shares one slice count")
        total = totals.pop()
        per_slice: dict = {}
        for s in comp.stages:
            per_slice.setdefault(s.slice[0], []).append(
                dataclasses.replace(s, slice=None))
        missing = [i for i in range(total) if i not in per_slice]
        if missing:
            raise CompositionError(
                f"{comp.signature()!r}: slice(s) {missing} have no "
                f"stages — {total} slices were addressed and each "
                "must run the full pipeline (its elements would "
                "otherwise never be reduced)")
        for i in range(total):
            try:
                _validate_walk(Composition(tuple(per_slice[i])), mesh)
            except CompositionError as e:
                raise CompositionError(f"slice s{i}:{total}: {e}") from None
        return comp
    _validate_walk(comp, mesh)
    return comp


def _validate_walk(comp: Composition, mesh: tuple) -> Composition:
    """One pipeline's walk: a pipeline with any ``broadcast`` stage is
    the broadcast family (all stages bc), anything else the reduction
    family; the two never mix."""
    if any(s.primitive == "broadcast" for s in comp.stages):
        return _validate_broadcast_walk(comp, mesh)
    return _validate_stage_walk(comp, mesh)


def _validate_broadcast_walk(comp: Composition, mesh: tuple) -> Composition:
    """Every stage ``bc``, every mesh axis broadcast EXACTLY ONCE, radix
    >= 2, no ``sharded_update``."""
    covered: list = []
    for st in comp.stages:
        if st.primitive != "broadcast":
            raise CompositionError(
                f"{comp.signature()!r}: {st.signature()} mixed into a "
                "broadcast pipeline — bc stages never compose with "
                "reduction stages (the tree would overwrite partial "
                "sums with the root's buffer)")
        if not st.axes:
            raise CompositionError(
                f"{comp.signature()!r}: broadcast stage with an empty "
                "axis group — every tree names the axes it fans over")
        if len(set(st.axes)) != len(st.axes):
            raise CompositionError(
                f"{comp.signature()!r}: duplicate axis within stage "
                f"{st.signature()!r}")
        for a in st.axes:
            if a not in mesh:
                raise CompositionError(
                    f"{comp.signature()!r}: axis {a!r} is not on the "
                    f"mesh {mesh}")
            if a in covered:
                raise CompositionError(
                    f"{comp.signature()!r}: axis {a!r} broadcast more "
                    "than once — the second tree re-sends bytes the "
                    "first already delivered")
        if st.radix is not None and st.radix < 2:
            raise CompositionError(
                f"{comp.signature()!r}: multicast radix must be >= 2, "
                f"got {st.radix}")
        covered.extend(st.axes)
    missing = [a for a in mesh if a not in covered]
    if missing:
        raise CompositionError(
            f"{comp.signature()!r}: axes {tuple(missing)} never "
            "broadcast — those mesh levels would keep stale replicas")
    return comp


def _validate_stage_walk(comp: Composition, mesh: tuple) -> Composition:
    """The per-stage invariant walk over one reduction pipeline (run once
    for a compact composition, once a slice for an expanded one)."""
    reduced: list = []
    open_scatters: list = []
    update_seen = False
    for st in comp.stages:
        if st.primitive not in PRIMITIVES:
            raise CompositionError(
                f"unknown primitive {st.primitive!r} (stages compose "
                f"{PRIMITIVES})")
        if st.radix is not None:
            raise CompositionError(
                f"{comp.signature()!r}: stage {st.signature()!r} carries "
                "a multicast radix — only broadcast (bc) stages fan "
                "over a tree")
        if st.primitive == "sharded_update":
            if update_seen:
                raise CompositionError(
                    f"{comp.signature()!r}: more than one sharded_update "
                    "stage — the ZeRO fuse point is single")
            if set(reduced) != set(mesh):
                raise CompositionError(
                    f"{comp.signature()!r}: sharded_update before every "
                    f"axis is reduced (reduced {tuple(reduced)}, mesh "
                    f"{mesh}) — the update must see the fully-reduced "
                    "mean chunk")
            if not open_scatters:
                raise CompositionError(
                    f"{comp.signature()!r}: sharded_update with no open "
                    "reduce_scatter — the update would not be sharded "
                    "(that is a plain post-reduction update, not a "
                    "composition stage)")
            update_seen = True
            continue
        if not st.axes:
            raise CompositionError(
                f"{comp.signature()!r}: {st.primitive} stage with an "
                "empty axis group — every collective stage names the "
                "axes it rides")
        if len(set(st.axes)) != len(st.axes):
            raise CompositionError(
                f"{comp.signature()!r}: duplicate axis within stage "
                f"{st.signature()!r}")
        for a in st.axes:
            if a not in mesh:
                raise CompositionError(
                    f"{comp.signature()!r}: axis {a!r} is not on the "
                    f"mesh {mesh}")
        if st.primitive in ("reduce_scatter", "allreduce"):
            if update_seen:
                raise CompositionError(
                    f"{comp.signature()!r}: {st.signature()} after the "
                    "sharded_update — every reduction precedes the fuse "
                    "point")
            dup = [a for a in st.axes if a in reduced]
            if dup:
                raise CompositionError(
                    f"{comp.signature()!r}: axis {dup[0]!r} reduced more "
                    "than once — the mean would be over-divided")
            reduced.extend(st.axes)
            if st.primitive == "reduce_scatter":
                open_scatters.append(st.axes)
        else:  # allgather
            if not open_scatters:
                raise CompositionError(
                    f"{comp.signature()!r}: {st.signature()} with no open "
                    "reduce_scatter to conjugate")
            top = open_scatters.pop()
            if top != st.axes:
                raise CompositionError(
                    f"{comp.signature()!r}: {st.signature()} does not "
                    f"conjugate the open reduce_scatter over {top} — "
                    "scatter/gather pairs close LIFO with the same axis "
                    "group")
    missing = [a for a in mesh if a not in reduced]
    if missing:
        raise CompositionError(
            f"{comp.signature()!r}: axes {tuple(missing)} never reduced "
            "— the result would not be the mean over the mesh")
    if open_scatters:
        raise CompositionError(
            f"{comp.signature()!r}: reduce_scatter over "
            f"{open_scatters[-1]} never gathered back — the output "
            "would stay sharded")
    return comp


def _group_size(axes, axis_sizes) -> int:
    n = 1
    for a in axes:
        n *= int(axis_sizes[a])
    return n


def predicted_collectives(comp: Composition, size: Optional[int] = None,
                          axis_sizes: Optional[Mapping[str, int]] = None
                          ) -> dict:
    """The ``torch.distributed`` calls the executor makes for ``comp`` on
    one bucket, by :data:`STAGE_CALLS`: one a stage a slice (``S`` times
    the unsliced count at ``1/S`` payload each). ``size`` (the bucket's
    elements) applies the :func:`effective_slices` degrade. A
    ``broadcast`` stage makes ``tree_sends(n, radix)`` calls on the
    group's root (a member makes one for each sub-send it sends or
    receives in), so its count needs ``axis_sizes`` (axis name -> size);
    the ``batch_isend_irecv`` key appears only then."""
    s_eff = (effective_slices(comp.slices, size) if size is not None
             else comp.slices)
    out = {"reduce_scatter_tensor": 0, "all_reduce": 0, "all_gather": 0}
    if any(st.primitive == "broadcast" for st in comp.stages):
        out["batch_isend_irecv"] = 0
    for st in comp.stages:
        call = STAGE_CALLS.get(st.primitive)
        if call is None:
            continue
        if st.primitive == "broadcast":
            if axis_sizes is None:
                raise CompositionError(
                    f"predicted_collectives: broadcast stage "
                    f"{st.signature()!r} makes tree_sends(n, radix) "
                    "calls — pass axis_sizes to size the merged group")
            n = _group_size(st.axes, axis_sizes)
            out[call] += tree_sends(n, st.radix or DEFAULT_RADIX) * s_eff
        else:
            out[call] += s_eff
    return out


# ---------------------------------------------------------------------------
# the deriver and the menu
# ---------------------------------------------------------------------------

def _contiguous_partitions(items: tuple) -> list:
    """All ordered partitions of ``items`` into contiguous groups."""
    if not items:
        return [[]]
    out = []
    for i in range(1, len(items) + 1):
        head = items[:i]
        for rest in _contiguous_partitions(items[i:]):
            out.append([head] + rest)
    return out


def derive_compositions(mesh_axes: Sequence[str]) -> tuple:
    """The legal mean-allreduce compositions of a mesh: reverse the axes
    (the fast level scatters first, the slow one reduces innermost),
    partition them into contiguous level groups (one stage a group over
    its merged axes), scatter every outer group, reduce the innermost by
    an ``allreduce`` or its own ``reduce_scatter``/``allgather`` pair,
    and gather back out. ``2^k`` compositions for ``k`` axes, each
    validated; ``flat`` and ``two_level`` are among them."""
    names = tuple(mesh_axes)
    if not names:
        raise CompositionError("derive_compositions: empty mesh axis tuple")
    seen = set()
    out: list = []
    for parts in _contiguous_partitions(names[::-1]):
        # each group back in mesh order for readable signatures
        groups = [tuple(sorted(g, key=names.index)) for g in parts]
        outer, inner = groups[:-1], groups[-1]
        for innermost in ("allreduce", "reduce_scatter"):
            stages = [Stage("reduce_scatter", g) for g in outer]
            stages.append(Stage(innermost, inner))
            if innermost == "reduce_scatter":
                stages.append(Stage("allgather", inner))
            stages.extend(Stage("allgather", g) for g in reversed(outer))
            comp = Composition(tuple(stages))
            sig = comp.signature()
            if sig not in seen:
                seen.add(sig)
                out.append(validate_composition(comp, names))
    return tuple(out)


def flat_composition(mesh_axes: Sequence[str]) -> Composition:
    """``flat``: one all-reduce over the merged axes."""
    return Composition((Stage("allreduce", tuple(mesh_axes)),))


def two_level_composition(mesh_axes: Sequence[str]) -> Composition:
    """``two_level``: scatter the last (fast) axis, all-reduce the shard
    over the rest, gather back (the reference's
    ``TwoDimensionalCommunicator`` pipeline; on a flat mesh the rs > ag
    decomposition)."""
    names = tuple(mesh_axes)
    fast, rest = (names[-1],), names[:-1]
    stages = [Stage("reduce_scatter", fast)]
    if rest:
        stages.append(Stage("allreduce", rest))
    stages.append(Stage("allgather", fast))
    return Composition(tuple(stages))


def zero_composition(mesh_axes: Sequence[str]) -> Composition:
    """``zero``: the two-level reduction with the sharded update at the
    fully reduced chunk: ``rs(all) > su > ag(all)`` on a flat mesh,
    ``rs(fast) > ar(rest) > su > ag(fast)`` on a hierarchical one."""
    names = tuple(mesh_axes)
    fast, rest = (names[-1],), names[:-1]
    stages = [Stage("reduce_scatter", fast)]
    if rest:
        stages.append(Stage("allreduce", rest))
    stages.append(Stage("sharded_update"))
    stages.append(Stage("allgather", fast))
    return Composition(tuple(stages))


def broadcast_composition(mesh_axes: Sequence[str],
                          radix: int = DEFAULT_RADIX) -> Composition:
    """One multicast tree over the merged mesh axes: the group's root
    fans its buffer out in ``tree_depth(n, radix)`` rounds. Spelled
    ``bc(a0+a1+a2)`` (``@r`` when the radix is not the default)."""
    r = int(radix)
    if r < 2:
        raise CompositionError(f"multicast radix must be >= 2, got {radix}")
    return Composition((Stage(
        "broadcast", tuple(mesh_axes),
        radix=(r if r != DEFAULT_RADIX else None)),))


def compile_schedule(schedule, mesh_axes: Sequence[str]) -> Composition:
    """A schedule's spelling as a validated :class:`Composition`: a menu
    name (``'flat'``/``'two_level'``/``'zero'``), a signature (in the
    mesh's names or the canonical tokens) or a ``Composition``; an
    expanded spelling comes back compact."""
    names = tuple(mesh_axes)
    if isinstance(schedule, Composition):
        return compact_slices(validate_composition(
            bind_composition(schedule, names), names))
    if schedule == "flat":
        return flat_composition(names)
    if schedule == "two_level":
        return two_level_composition(names)
    if schedule == "zero":
        return zero_composition(names)
    if isinstance(schedule, str) and (">" in schedule or "(" in schedule):
        comp = parse_signature(schedule)
        return compact_slices(validate_composition(
            bind_composition(comp, names), names))
    from chainermn_tpu_torch.parallel.reduction_schedule import SCHEDULES

    raise CompositionError(
        f"unknown schedule {schedule!r}: expected one of {SCHEDULES}, a "
        "composition signature (e.g. 'rs(a1)>ar(a0)>ag(a1)'), or a "
        "Composition")


def schedule_candidates(n_axes: int) -> tuple:
    """The schedule choice set of an ``n_axes``-level world shape: the
    menu names, then the derived compositions the menu cannot express,
    by canonical-token signature."""
    from chainermn_tpu_torch.parallel.reduction_schedule import SCHEDULES

    names = canonical_axis_names(max(1, int(n_axes)))
    menu_sigs = {flat_composition(names).signature(),
                 two_level_composition(names).signature()}
    derived = tuple(c.signature() for c in derive_compositions(names)
                    if c.signature() not in menu_sigs)
    return tuple(SCHEDULES) + derived


def normalize_schedule_name(schedule: str, n_axes: int) -> str:
    """A menu instance's signature back to its menu name (other
    signatures and the names pass through)."""
    names = canonical_axis_names(max(1, int(n_axes)))
    table = {
        flat_composition(names).signature(): "flat",
        two_level_composition(names).signature(): "two_level",
        zero_composition(names).signature(): "zero",
    }
    return table.get(schedule, schedule)


def signature_for(schedule, n_axes: int) -> str:
    """The canonical-token signature of a menu name or signature."""
    names = canonical_axis_names(max(1, int(n_axes)))
    return compile_schedule(schedule, names).signature()


# ---------------------------------------------------------------------------
# the scatter frame and the wire layout
# ---------------------------------------------------------------------------

def _replay_sizes(stages: Sequence[Stage], size: int, axis_sizes):
    """Static walk of the scatter frame: per-stage ``(stage, size_in,
    size_out)`` element counts, the size at the end and the LIFO scatter
    stack ``[(axes, size before)]``: one walk for the executor, the split
    ZeRO runners and the wire layout, so none disagree on padding."""
    cur = int(size)
    stack: list = []
    rows: list = []
    for st in stages:
        if st.primitive == "reduce_scatter":
            n = _group_size(st.axes, axis_sizes)
            out = -(-cur // n)  # ceil: the padded shard length
            stack.append((st.axes, cur))
            rows.append((st, cur, out))
            cur = out
        elif st.primitive == "allgather":
            axes, orig = stack.pop()
            rows.append((st, cur, orig))
            cur = orig
        else:  # allreduce / sharded_update / broadcast: size unchanged
            rows.append((st, cur, cur))
    return rows, cur, stack


def _layout_row(st, size_in, size_out, itemsize, axis_sizes) -> dict:
    row = {"stage": st.signature(), "op": STAGE_CALLS[st.primitive],
           "nbytes": max(size_in, size_out) * itemsize}
    if st.primitive == "broadcast":
        row["rounds"] = tree_depth(_group_size(st.axes, axis_sizes),
                                   st.radix or DEFAULT_RADIX)
    return row


def stage_wire_layout(comp: Composition, axis_sizes: Mapping[str, int],
                      itemsize: int, size: int) -> list:
    """Per-stage wire table of one bucket of ``size`` elements at
    ``itemsize`` bytes each: the payload each collective stage carries
    (the full buffer into a scatter and out of a gather, the shard
    through an all-reduce) and its call. A sliced composition gives one
    row a stage a slice, in the skewed issue order, each with ``slice``
    and ``n_slices`` (the effective count); over the slices a stage's
    bytes sum to the unsliced rendering's."""
    comp = compact_slices(comp)
    s_eff = effective_slices(comp.slices, size)
    if s_eff <= 1:
        rows, _, _ = _replay_sizes(comp.stages, size, axis_sizes)
        return [_layout_row(st, a, b, itemsize, axis_sizes)
                for st, a, b in rows if st.primitive in STAGE_CALLS]
    bounds = slice_bounds(size, s_eff)
    per_slice_rows = [
        {(st.signature(), j): (st, size_in, size_out)
         for j, (st, size_in, size_out) in enumerate(
             _replay_sizes(comp.stages, hi - lo, axis_sizes)[0])}
        for lo, hi in bounds]
    out = []
    for st in expand_slices(comp, size):
        i, _ = st.slice
        base = dataclasses.replace(st, slice=None)
        j = comp.stages.index(base)
        if st.primitive not in STAGE_CALLS:
            continue
        _, size_in, size_out = per_slice_rows[i][(base.signature(), j)]
        row = _layout_row(base, size_in, size_out, itemsize, axis_sizes)
        row.update(slice=i, n_slices=s_eff)
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

def _order(ag: C.AxisGroups, axes: tuple):
    """``(merged groups, perm)`` of a stage's ``axes``: the groups merged
    in mesh order and, when ``axes`` is written in another order, the
    permutation ``perm[m]`` = the index over ``axes`` (row-major, as JAX
    numbers a ``psum_scatter`` over them) of the member at mesh-ordered
    position ``m`` (else None)."""
    grp = ag.merged(axes)
    ordered = ag.ordered(axes)
    if ordered == tuple(axes):
        return grp, None
    sizes = ag.sizes()
    n = ag.size(axes)
    coords = np.unravel_index(np.arange(n), [sizes[a] for a in ordered])
    by_name = dict(zip(ordered, coords))
    perm = np.ravel_multi_index([by_name[a] for a in axes],
                                [sizes[a] for a in axes])
    return grp, torch.as_tensor(perm, dtype=torch.long)


def _rs(cur: torch.Tensor, ag, axes) -> torch.Tensor:
    """A ``reduce_scatter`` stage: this member's summed shard."""
    grp, perm = _order(ag, axes)
    if perm is None:
        return C.staged_reduce_scatter(cur.contiguous(), grp)
    rows = C._rows(cur.reshape(-1), C.axes_size(grp))
    return C._rs_rows(rows[perm.to(rows.device)].contiguous(), grp)


def _ag(cur: torch.Tensor, ag, axes, orig_size: int) -> torch.Tensor:
    """An ``allgather`` stage, the conjugate of :func:`_rs`: the shards
    in order, un-padded to ``orig_size`` elements."""
    grp, perm = _order(ag, axes)
    if perm is None:
        return C.staged_allgather(cur.contiguous(), grp, orig_size)
    rows = C._ag_rows(cur.contiguous(), grp)
    inv = torch.argsort(perm).to(rows.device)
    return rows[inv].reshape(-1)[:orig_size]


def _ar(cur: torch.Tensor, ag, axes) -> torch.Tensor:
    return C.staged_allreduce(cur.contiguous(), ag.merged(axes))


def _bc(cur: torch.Tensor, ag, st) -> torch.Tensor:
    return C.staged_broadcast(cur.contiguous(), ag.merged(st.axes),
                              radix=st.radix or DEFAULT_RADIX)


def _run_stage(cur, st, ag, stack, update_fn=None):
    """One stage of a pipeline on ``cur`` (``stack``: the sizes the open
    scatters un-pad to)."""
    if st.primitive == "reduce_scatter":
        stack.append(cur.numel())
        return _rs(cur, ag, st.axes)
    if st.primitive == "allreduce":
        return _ar(cur, ag, st.axes)
    if st.primitive == "allgather":
        return _ag(cur, ag, st.axes, stack.pop())
    if st.primitive == "broadcast":
        return _bc(cur, ag, st)
    return update_fn(cur)  # sharded_update


def _reduce_axes(stages) -> tuple:
    """The axes ``stages`` reduce over: the names the mean divides by."""
    return tuple(a for s in stages
                 if s.primitive in ("reduce_scatter", "allreduce")
                 for a in s.axes)


def reduce_composed(x: torch.Tensor, comp: Composition, axes, *,
                    op: str = "mean",
                    update_fn: Optional[Callable] = None) -> torch.Tensor:
    """Run ``comp`` on this rank's ``x`` over ``axes`` (an
    :class:`~chainermn_tpu_torch.parallel.collectives.AxisGroups`, a
    communicator, or groups named by position), the executor every
    schedule lowers to:

    - ``reduce_scatter``: ceil-pad the flat buffer into ``[n, c]`` rows
      over the stage's merged group and reduce-scatter them (this
      member's exactly summed 1/n slice);
    - ``allreduce``: the sum over the group;
    - ``allgather``: the conjugate gather of the matching scatter,
      un-padded;
    - ``broadcast``: the group's root's buffer through the tree;
    - ``sharded_update``: ``update_fn`` on the fully reduced shard.

    The mean divides right after the stage that completes the reduction
    over every axis, where the JAX executor divides; the single-stage
    ``ar(all)`` is one all-reduce divided by the ranks (``lax.pmean``).
    A sliced composition cuts the flat buffer into
    ``effective_slices`` slices (contiguous, or ``flat[i::S]`` in the
    zigzag layout, copied contiguous for the calls) and runs every
    slice's stages in :func:`expand_slices` order, each slice dividing
    once; the slices go back in place."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    ag = C.axis_groups_of(axes)
    comp = compact_slices(comp)
    stages = comp.stages
    if comp.has_update and update_fn is None:
        raise ValueError(
            f"composition {comp.signature()!r} has a sharded_update "
            "stage but no update_fn was given")
    reduce_axes = _reduce_axes(stages)
    n_tot = ag.size(reduce_axes) if reduce_axes else 1
    # a broadcast pipeline reduces nothing: the mean never divides
    rem_init = len(reduce_axes) if reduce_axes else -1

    s_eff = effective_slices(comp.slices, x.numel())
    if s_eff > 1 and comp.has_update:
        raise CompositionError(
            f"{comp.signature()!r}: sliced execution with a "
            "sharded_update stage — the fuse point is unsliceable")
    zigzag = comp.slice_layout == "zigzag"
    cur_s = _cut(x.reshape(-1), s_eff, zigzag)
    stack_s: list = [[] for _ in cur_s]
    rem_s = [rem_init] * s_eff
    for st in expand_slices(comp, x.numel()):
        i = st.slice[0] if st.slice else 0
        cur_s[i] = _run_stage(cur_s[i], st, ag, stack_s[i], update_fn)
        if st.primitive in ("reduce_scatter", "allreduce"):
            rem_s[i] -= len(st.axes)
        if rem_s[i] == 0 and op == "mean":
            cur_s[i] = cur_s[i] / n_tot
            rem_s[i] = -1  # divide exactly once a slice
    return _join(cur_s, zigzag).reshape(x.shape)


def run_reduce_prefix(g: torch.Tensor, stages: Sequence[Stage], axes, *,
                      total: int, wire_dtype=None) -> torch.Tensor:
    """A composition's reduce prefix (the stages before
    ``sharded_update``) on one buffer: flatten, cast a floating one to
    ``wire_dtype``, scatter and reduce stage by stage, divide by
    ``total`` (the whole data-parallel degree) and return the mean chunk
    in ``g``'s dtype."""
    ag = C.axis_groups_of(axes)
    cur = g.reshape(-1)
    if wire_dtype is not None and g.is_floating_point():
        cur = cur.to(wire_dtype)
    for st in stages:
        if st.primitive not in ("reduce_scatter", "allreduce"):
            raise CompositionError(
                f"{st.signature()}: only reduce stages run before the "
                "sharded_update")
        cur = _run_stage(cur, st, ag, [])
    return (cur / total).to(g.dtype)


def run_gather_suffix(u_chunk: torch.Tensor, like, stages: Sequence[Stage],
                      prefix: Sequence[Stage], axes) -> torch.Tensor:
    """A composition's gather suffix (the stages after
    ``sharded_update``) on one updated chunk, back to ``like``'s shape
    and dtype (``like`` may be a ``meta`` tensor). The un-pad sizes
    replay the prefix's scatter frame (:func:`_replay_sizes`)."""
    ag = C.axis_groups_of(axes)
    _, _, stack = _replay_sizes(prefix, like.numel(), ag.sizes())
    cur = u_chunk.reshape(-1)
    for st in stages:
        if st.primitive != "allgather":
            raise CompositionError(
                f"{st.signature()}: only allgather stages run after the "
                "sharded_update")
        _, orig = stack.pop()
        cur = _ag(cur, ag, st.axes, orig)
    return cur.reshape(like.shape).to(like.dtype)


def reduce_composed_tree(leaves: list, comp: Composition, axes, *,
                         op: str = "mean") -> list:
    """Reduce a LIST of tensors under ``comp``. The single-stage
    ``ar(all)`` packs them, one all-reduce a dtype (the JAX plan's one
    fused ``pmean`` of its gradient list, and the plan's reduction
    without a composition); every other composition runs each tensor's
    flat buffer through :func:`reduce_composed` (per-tensor stage calls,
    the JAX package's documented cost of a scattered pipeline)."""
    ag = C.axis_groups_of(axes)
    comp = compact_slices(comp)
    if not (len(comp.stages) == 1 and comp.stages[0].primitive == "allreduce"
            and op == "mean" and comp.slices == 1):
        return [reduce_composed(g, comp, ag, op=op) for g in leaves]
    out = list(leaves)
    by_kind: dict = {}
    for i, t in enumerate(leaves):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    n = ag.size(comp.stages[0].axes)
    for idx in by_kind.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = _ar(flat, ag, comp.stages[0].axes) / n
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(leaves[i])
    return out


def run_stages_measured(flat: torch.Tensor, comp: Composition, axes, *,
                        sync: Callable = None):
    """``(sum, rows)``: ``comp`` run on ``flat`` as a SUM (no mean),
    stage by stage in :func:`expand_slices` order, ``sync()`` after each
    (the caller's wait for the device), and one row a stage: its
    signature, call, bytes (:func:`stage_wire_layout`, at ``flat``'s
    itemsize) and seconds. The eager measured reducer's loop."""
    import time

    ag = C.axis_groups_of(axes)
    comp = compact_slices(comp)
    n_elems = flat.numel()
    layout = stage_wire_layout(comp, ag.sizes(), flat.element_size(),
                               n_elems)
    s_eff = effective_slices(comp.slices, n_elems)
    zigzag = comp.slice_layout == "zigzag"
    cur_s = _cut(flat, s_eff, zigzag)
    stack_s: list = [[] for _ in cur_s]
    rows = []
    sync = sync or (lambda: None)
    for li, st in enumerate(expand_slices(comp, n_elems)):
        i = st.slice[0] if st.slice else 0
        t0 = time.perf_counter()
        cur_s[i] = _run_stage(cur_s[i], st, ag, stack_s[i])
        sync()
        row = dict(layout[li])
        row["dur_s"] = time.perf_counter() - t0
        rows.append(row)
    return _join(cur_s, zigzag), rows


__all__ = [
    "Composition",
    "CompositionError",
    "DEFAULT_RADIX",
    "PRIMITIVES",
    "STAGE_CALLS",
    "Stage",
    "bind_composition",
    "broadcast_composition",
    "canonical_axis_names",
    "compact_slices",
    "compile_schedule",
    "derive_compositions",
    "effective_slices",
    "expand_slices",
    "flat_composition",
    "normalize_schedule_name",
    "parse_signature",
    "predicted_collectives",
    "reduce_composed",
    "reduce_composed_tree",
    "run_gather_suffix",
    "run_reduce_prefix",
    "run_stages_measured",
    "schedule_candidates",
    "signature_for",
    "slice_bounds",
    "sliced_composition",
    "stage_wire_layout",
    "tree_depth",
    "tree_sends",
    "two_level_composition",
    "validate_composition",
    "zero_composition",
]
