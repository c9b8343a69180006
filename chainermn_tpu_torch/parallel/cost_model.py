"""α–β cost model for composed reduction schedules (counterpart of
``chainermn_tpu/parallel/cost_model.py``).

The deriver gives ``2^k`` pipelines a ``k``-axis mesh, and slicing
multiplies them; this module prices each with a per-LEVEL α–β model:
mesh level ℓ has a latency coefficient ``α_ℓ`` (ms a ring step) and a
bandwidth coefficient ``β_ℓ`` (ms a wire byte), and a stage over a
merged axis group costs ``steps·α_ℓ + wire·β_ℓ``, ℓ being the group's
SLOWEST level (axis 0 is the slow one, the mesh convention).

Stage terms (``n`` = the merged group's size, ``b`` = the bytes through
the stage, the ring algorithms' arithmetic):

- ``rs`` / ``ag``: ``n-1`` steps, ``((n-1)/n)·b`` wire bytes (``ag``
  prices the gathered size);
- ``ar``: ``2(n-1)`` steps, ``2((n-1)/n)·b``;
- ``bc``: ``tree_sends(n, radix)`` steps, ``tree_sends·b`` wire;
- ``su``: free.

A sliced composition is priced as its software pipeline's critical path:
stage j of slice i issues at tick ``i+j``, a tick costs the max of its
stages, the ticks add up.

Fits: :func:`fit_pipeline_rows` (non-negative least squares over
whole-pipeline medians at one world shape and payload),
:func:`load_from_bench_details` (the rows a bench left in a JSON file
whose path the caller gives: no TPU row carries over to the card) and
:func:`calibrate` (a live probe over a communicator through
:class:`~chainermn_tpu_torch.parallel.reduction_schedule.
MeasuredComposedReducer`, the median of ``repeats >= 3`` runs). Never
trusted blind: :func:`rank_compositions` without a model ranks nothing
(mode ``exhaustive``, provenance ``forced:uncalibrated``). The tuning
registry that records adoptions is ROADMAP queue 8's.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Mapping, Optional, Sequence

from chainermn_tpu_torch.parallel.composition import (
    Composition,
    CompositionError,
    DEFAULT_RADIX,
    _replay_sizes,
    canonical_axis_names,
    compact_slices,
    compile_schedule,
    effective_slices,
    signature_for,
    slice_bounds,
    tree_sends,
)

#: The composed wire is fp32 (the executor reduces fp32 buckets).
WIRE_ITEMSIZE = 4

#: Provenance of the forced-exhaustive degrade: never rank on a model
#: that was not fitted.
UNCALIBRATED = "forced:uncalibrated"


def stage_terms(comp: Composition, n_elems: int,
                world_shape: Sequence[int],
                mesh_axes: Optional[Sequence[str]] = None) -> list:
    """Per-stage model terms of ONE pipeline of ``n_elems`` fp32
    elements: ``(tick, level, steps, wire_bytes)`` rows, one a collective
    stage a slice; ``tick`` is the issue tick (``slice + stage index``).
    ``mesh_axes`` defaults to the canonical tokens."""
    shape = tuple(int(d) for d in world_shape)
    names = (tuple(mesh_axes) if mesh_axes is not None
             else canonical_axis_names(len(shape)))
    if len(names) != len(shape):
        raise CompositionError(
            f"world shape {shape} and mesh axes {names} disagree")
    axis_sizes = {a: shape[i] for i, a in enumerate(names)}
    level_of = {a: i for i, a in enumerate(names)}
    comp = compact_slices(comp)
    s_eff = effective_slices(comp.slices, int(n_elems))

    def rows_for(elems: int, slice_i: int) -> list:
        out = []
        replayed, _, _ = _replay_sizes(comp.stages, elems, axis_sizes)
        for j, (st, size_in, size_out) in enumerate(replayed):
            if st.primitive == "sharded_update":
                continue
            n = 1
            for a in st.axes:
                n *= axis_sizes[a]
            level = min(level_of[a] for a in st.axes)
            if st.primitive == "broadcast":
                sends = tree_sends(n, st.radix or DEFAULT_RADIX)
                steps = sends
                wire = float(sends * size_in * WIRE_ITEMSIZE)
            elif st.primitive == "allreduce":
                steps = 2 * (n - 1)
                wire = 2.0 * (n - 1) / n * size_in * WIRE_ITEMSIZE
            elif st.primitive == "reduce_scatter":
                steps = n - 1
                wire = float(n - 1) / n * size_in * WIRE_ITEMSIZE
            else:  # allgather: the gathered (output) size rides the wire
                steps = n - 1
                wire = float(n - 1) / n * size_out * WIRE_ITEMSIZE
            out.append((slice_i + j, level, steps, wire))
        return out

    if s_eff <= 1:
        return rows_for(int(n_elems), 0)
    rows = []
    for i, (lo, hi) in enumerate(slice_bounds(int(n_elems), s_eff)):
        rows.extend(rows_for(hi - lo, i))
    return rows


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Fitted per-level α–β coefficients for one world shape:
    ``alphas[ℓ]`` ms a ring step at level ℓ, ``betas[ℓ]`` ms a wire
    byte; ``source`` the fit's provenance, ``fit_err_pct`` the largest
    relative error of the model on the rows it was fitted from (its
    stated round-trip tolerance), ``fit_rows`` their signatures."""

    world_shape: tuple
    alphas: tuple
    betas: tuple
    source: str
    fit_err_pct: float
    fit_rows: tuple = ()

    def predict(self, comp, payload_bytes: int,
                mesh_axes: Optional[Sequence[str]] = None) -> float:
        """Predicted ms for ``comp`` (a signature or a
        :class:`~chainermn_tpu_torch.parallel.composition.Composition`)
        moving ``payload_bytes``; a sliced one by its critical path."""
        names = (tuple(mesh_axes) if mesh_axes is not None
                 else canonical_axis_names(len(self.world_shape)))
        if not isinstance(comp, Composition):
            comp = compile_schedule(comp, names)
        n_elems = max(1, int(payload_bytes) // WIRE_ITEMSIZE)
        ticks: dict = {}
        for tick, level, steps, wire in stage_terms(
                comp, n_elems, self.world_shape, names):
            cost = steps * self.alphas[level] + wire * self.betas[level]
            ticks[tick] = max(ticks.get(tick, 0.0), cost)
        return float(sum(ticks.values()))


def fit_pipeline_rows(rows_ms: Mapping[str, float],
                      world_shape: Sequence[int], payload_bytes: int, *,
                      source: str = "fit:pipeline_rows") -> CostModel:
    """Fit the per-level α–β coefficients to whole-pipeline medians
    (``{signature: ms}`` at one world shape and payload) by non-negative
    least squares (column scaling, a tiny ridge, re-solves with the
    negative coefficients clamped to 0), storing the fit's own largest
    relative error as ``fit_err_pct``."""
    import numpy as np

    shape = tuple(int(d) for d in world_shape)
    k = len(shape)
    sigs = sorted(rows_ms)
    if len(sigs) < 2:
        raise CompositionError(
            f"fit needs >= 2 pipeline rows, got {len(sigs)}")
    names = canonical_axis_names(k)
    n_elems = max(1, int(payload_bytes) // WIRE_ITEMSIZE)
    A = np.zeros((len(sigs), 2 * k))
    b = np.array([float(rows_ms[s]) for s in sigs])
    for i, sig in enumerate(sigs):
        comp = compile_schedule(sig, names)
        for _, level, steps, wire in stage_terms(
                comp, n_elems, shape, names):
            A[i, 2 * level] += steps
            A[i, 2 * level + 1] += wire
    col = np.maximum(np.abs(A).max(axis=0), 1e-12)
    As = A / col
    free = np.ones(2 * k, dtype=bool)
    x = np.zeros(2 * k)
    for _ in range(2 * k + 1):
        idx = np.where(free)[0]
        if idx.size == 0:
            break
        Af = As[:, idx]
        ridge = 1e-8 * np.eye(idx.size)
        xf = np.linalg.solve(Af.T @ Af + ridge, Af.T @ b)
        neg = xf < 0
        if not neg.any():
            x = np.zeros(2 * k)
            x[idx] = xf
            break
        free[idx[neg]] = False
    coeffs = x / col
    pred = A @ coeffs
    err = float(np.max(np.abs(pred - b) / np.maximum(np.abs(b), 1e-12)))
    return CostModel(
        world_shape=shape,
        alphas=tuple(float(coeffs[2 * i]) for i in range(k)),
        betas=tuple(float(coeffs[2 * i + 1]) for i in range(k)),
        source=source,
        fit_err_pct=round(err * 100.0, 3),
        fit_rows=tuple(sigs))


def load_from_bench_details(path, *, world_shape: Optional[Sequence[int]]
                            = None) -> Optional[CostModel]:
    """Fit the composed-sweep rows a bench left in the JSON file at
    ``path`` (``composed_schedule_ms``, ``composed_world_shape``,
    ``composed_payload_mb``); there is no default file: the repo's TPU
    rows price nothing on the card. ``None`` (the uncalibrated degrade,
    never a default model) when the file, the rows or the requested
    world shape are missing or differ, and when the rows cannot
    overdetermine the ``2k`` coefficients (fewer than ``2k + 1``)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    rows = data.get("composed_schedule_ms")
    shape = data.get("composed_world_shape")
    payload_mb = data.get("composed_payload_mb")
    if not isinstance(rows, dict) or not shape:
        return None
    if len(rows) < 2 * len(shape) + 1:
        return None
    if world_shape is not None and tuple(int(d) for d in shape) != tuple(
            int(d) for d in world_shape):
        return None
    try:
        return fit_pipeline_rows(
            {str(k): float(v) for k, v in rows.items()},
            tuple(int(d) for d in shape),
            int(float(payload_mb or 1.0) * (1 << 20)),
            source="fit:bench_details")
    except Exception:
        return None


def calibrate(comm, *, payload_mb: float = 1.0,
              candidates: Optional[Sequence[str]] = None,
              repeats: int = 3) -> CostModel:
    """A short live probe over ``comm``: every derived composition of its
    axes (or ``candidates``) run through
    :class:`~chainermn_tpu_torch.parallel.reduction_schedule.
    MeasuredComposedReducer` on a ``payload_mb`` fp32 buffer (one warm
    run, then the median of ``repeats >= 3`` timed runs a rank; a
    pipeline's time is the slowest rank's median, so every rank fits the
    same rows), fitted by :func:`fit_pipeline_rows`. Every rank calls it."""
    import torch

    from chainermn_tpu_torch.parallel import collectives as C
    from chainermn_tpu_torch.parallel.composition import derive_compositions
    from chainermn_tpu_torch.parallel.reduction_schedule import (
        MeasuredComposedReducer,
    )

    if int(repeats) < 3:
        raise ValueError(f"calibrate takes the median of >= 3 runs, got "
                         f"repeats={repeats}")
    ag = C.axis_groups_of(comm)
    sizes = ag.sizes()
    shape = tuple(sizes[a] for a in ag.names)
    if candidates is None:
        candidates = [c.signature() for c in derive_compositions(ag.names)]
    n_elems = max(1, int(float(payload_mb) * (1 << 20)) // WIRE_ITEMSIZE)
    gen = torch.Generator().manual_seed(comm.rank)
    device = getattr(comm, "device", torch.device("cpu"))
    grad = torch.randn(n_elems, generator=gen).to(device)
    mine: dict = {}
    for sig in candidates:
        red = MeasuredComposedReducer(comm, schedule=sig)
        red.reduce([grad])  # warm
        samples = []
        for _ in range(int(repeats)):
            t0 = time.perf_counter()
            red.reduce([grad])
            samples.append((time.perf_counter() - t0) * 1000.0)
        mine[canonical_signature(sig, len(shape), ag.names)] = statistics.median(
            samples)
    everyone = comm.allgather_obj(mine)
    rows = {s: max(r[s] for r in everyone) for s in mine}
    return fit_pipeline_rows(rows, shape, n_elems * WIRE_ITEMSIZE,
                             source="fit:calibration")


def canonical_signature(sig: str, n_axes: int,
                        mesh_axes: Optional[Sequence[str]] = None) -> str:
    """A signature re-spelled over the canonical positional tokens (the
    spelling fit rows and rank orders key on); ``mesh_axes`` names the
    mesh a signature in real axis names is written over (mapped to the
    tokens by position)."""
    if mesh_axes is None:
        return signature_for(sig, n_axes)
    names = tuple(mesh_axes)
    comp = compile_schedule(sig, names)
    table = dict(zip(names, canonical_axis_names(len(names))))
    return dataclasses.replace(comp, stages=tuple(
        dataclasses.replace(s, axes=tuple(table[a] for a in s.axes))
        for s in comp.stages)).signature()


@dataclasses.dataclass(frozen=True)
class RankResult:
    """One schedule-search ranking: ``order`` every candidate,
    best-predicted first (ties broken on the signature), ``measured`` the
    prefix to time, ``skipped`` the rest with their predictions still in
    ``predicted_ms``; ``mode`` ``"topk"`` or ``"exhaustive"``,
    ``provenance`` why (``cost_model:<fit source>`` or
    ``forced:uncalibrated``)."""

    mode: str
    provenance: str
    order: tuple
    predicted_ms: dict
    measured: tuple
    skipped: tuple


def rank_compositions(model: Optional[CostModel],
                      candidates: Sequence[str], payload_bytes: int, *,
                      k: int = 3,
                      mesh_axes: Optional[Sequence[str]] = None,
                      mode: str = "topk") -> RankResult:
    """Rank ``candidates`` (signatures) by predicted cost and pick the
    top ``k`` to measure. Degrades LOUDLY: ``model=None`` or
    ``mode="exhaustive"`` measures every candidate, with provenance
    ``forced:uncalibrated`` in the first case."""
    cands = tuple(dict.fromkeys(candidates))
    if model is None or mode == "exhaustive":
        return RankResult(
            mode="exhaustive",
            provenance=(UNCALIBRATED if model is None
                        else "exhaustive:requested"),
            order=cands, predicted_ms={}, measured=cands, skipped=())
    preds = {sig: model.predict(sig, payload_bytes, mesh_axes)
             for sig in cands}
    order = tuple(sorted(cands, key=lambda s: (preds[s], s)))
    k = max(1, int(k))
    return RankResult(
        mode="topk",
        provenance=f"cost_model:{model.source}",
        order=order,
        predicted_ms={s: round(preds[s], 4) for s in order},
        measured=order[:k],
        skipped=order[k:])


def emit_sched_search_event(rank: RankResult,
                            measured_ms: Optional[Mapping[str, float]] = None,
                            *, spread_pct: Optional[float] = None
                            ) -> Optional[float]:
    """The schedule search's audit: :func:`model_error_pct` of the
    measured arms, returned so callers gate on it. The JAX function also
    records it as a ``sched_search`` trace event when a recorder is
    active; the port has no trace recorder yet (ROADMAP queue 8), so this
    emits nothing, as the JAX function does with none active."""
    return model_error_pct(rank.predicted_ms, measured_ms or {})


def model_error_pct(predicted_ms: Mapping[str, float],
                    measured_ms: Mapping[str, float]) -> Optional[float]:
    """The largest relative predicted-vs-measured error (percent) over
    the signatures in BOTH maps; None when they share none."""
    errs = [abs(predicted_ms[s] - measured_ms[s])
            / max(abs(measured_ms[s]), 1e-12)
            for s in predicted_ms if s in measured_ms]
    if not errs:
        return None
    return round(max(errs) * 100.0, 3)


__all__ = ["CostModel", "RankResult", "UNCALIBRATED", "WIRE_ITEMSIZE",
           "calibrate", "canonical_signature", "emit_sched_search_event",
           "fit_pipeline_rows", "load_from_bench_details", "model_error_pct",
           "rank_compositions", "stage_terms"]
