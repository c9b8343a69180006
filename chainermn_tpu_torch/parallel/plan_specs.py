"""Spec layer of the :class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`
(counterpart of ``chainermn_tpu/parallel/plan_specs.py``).

The per-axis modules are *spec providers*: each publishes a small
descriptor (how its parameter and optimizer-state leaves lay out over its
mesh axis, and which collectives it owes the step), and this module turns
those descriptors plus the user's per-leaf spec tree into the update
groups one plan step composes.

Provider contract (``{tensor,zero,pipeline}.{tp,zero,pipe}_plan_axis``,
:func:`seq_plan_axis` and :func:`moe_plan_axis`):

- ``name``: the mesh axis name;
- ``stacked``: parameter leaves sharded by this axis stack a leading
  ``[n, ...]`` shard dim in the global view (each rank holds its slice);
- ``state_stacked``: the axis shards the *optimizer state* (ZeRO);
- ``collectives``: the collectives the axis owes the step, in the JAX
  package's vocabulary (``all-reduce``, ``reduce-scatter``,
  ``all-gather``, ``collective-permute``, ``all-to-all``), so that
  :meth:`~chainermn_tpu_torch.parallel.plan.ParallelPlan.describe` reads
  as the JAX one does. The port's tests count the ``torch.distributed``
  calls of a step against it.

The JAX ``PartitionSpec`` becomes :class:`PartitionSpec` here: a tuple of
mesh-axis names, one per leading stacked dim of a leaf (``P()`` is
replicated). The ``data`` axis is the plain data-parallel provider and
lives here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from torch.utils import _pytree as pytree

PyTree = Any

#: Canonical mesh-axis order: axes that tolerate slow links first, those
#: that want the fastest links last (``model`` last).
CANONICAL_AXES = ("data", "zero", "pipe", "seq", "expert", "model")

#: the ``seq_attn_impl`` candidates and the collectives each routes the
#: step through
SEQ_ATTN_IMPLS = ("ring", "ulysses")
SEQ_IMPL_COLLECTIVES = {
    # n-1 kv hops a layer a pass, plus the one gradient mean
    "ring": ("collective-permute", "all-reduce"),
    # two reshards in, one out, a layer, plus the one gradient mean
    "ulysses": ("all-to-all", "all-reduce"),
}


class PartitionSpec(tuple):
    """A leaf's placement in a plan: the mesh axes its leading dims stack
    over, in order (``P()`` replicated, ``P('model')``, ``P('pipe',
    'model')``). A tuple of names, and a leaf of the spec trees (not a
    container)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec


def seq_plan_axis(impl: str = "ring", axis_name: str = "seq") -> dict:
    """Descriptor of the ``seq`` axis: the batch's SEQUENCE dim shards over
    it, parameters and optimizer state stay replicated, and it owes the
    step one gradient all-reduce plus the attention collectives of the
    routed impl (the ring's ``collective-permute``, the default, or
    Ulysses' ``all-to-all``)."""
    if impl not in SEQ_ATTN_IMPLS:
        raise ValueError(
            f"seq_plan_axis impl must be one of {SEQ_ATTN_IMPLS}, got "
            f"{impl!r}")
    return {"name": axis_name, "stacked": False, "state_stacked": False,
            "collectives": SEQ_IMPL_COLLECTIVES[impl]}


def moe_plan_axis(axis_name: str = "expert") -> dict:
    """Descriptor of the ``expert`` axis (:mod:`chainermn_tpu_torch.
    parallel.moe`): expert leaves STACK a leading ``[n, ...]`` shard dim
    (``P('expert')``, the :func:`~chainermn_tpu_torch.parallel.moe.
    make_expert_params` layout), the batch's rows shard over the axis too,
    and it owes the step two all-to-alls a MoE layer a pass (dispatch and
    combine; their backward is again an all-to-all each) plus the one
    gradient all-reduce that makes the non-expert leaves' gradients the
    global token mean. Expert leaves take no collective over the axis."""
    return {"name": axis_name, "stacked": True, "state_stacked": False,
            "collectives": ("all-to-all", "all-reduce")}


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One resolved plan axis: the provider descriptor plus its size."""

    name: str
    size: int
    stacked: bool
    state_stacked: bool
    collectives: tuple


def _provider(role: str) -> dict:
    if role == "data":
        return {"name": "data", "stacked": False, "state_stacked": False,
                "collectives": ("all-reduce",)}
    if role == "zero":
        from chainermn_tpu_torch.parallel.zero import zero_plan_axis

        return zero_plan_axis()
    if role == "model":
        from chainermn_tpu_torch.parallel.tensor import tp_plan_axis

        return tp_plan_axis()
    if role == "pipe":
        from chainermn_tpu_torch.parallel.pipeline import pipe_plan_axis

        return pipe_plan_axis()
    if role == "seq":
        return seq_plan_axis()
    if role == "expert":
        return moe_plan_axis()
    raise ValueError(f"unknown plan axis {role!r}: a ParallelPlan composes "
                     f"{CANONICAL_AXES} (any subset)")


def resolve_axes(sizes: Mapping[str, int]) -> dict:
    """Provider descriptors for ``sizes`` (name -> size), in canonical
    mesh order."""
    for name in sizes:
        if name not in CANONICAL_AXES:
            _provider(name)  # raises with the canonical list
    out: dict = {}
    for name in CANONICAL_AXES:
        if name not in sizes:
            continue
        d = _provider(name)
        out[name] = AxisSpec(name=d["name"], size=int(sizes[name]),
                             stacked=bool(d["stacked"]),
                             state_stacked=bool(d["state_stacked"]),
                             collectives=tuple(d["collectives"]))
    return out


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _broadcast(spec, sub):
    """``spec`` at every leaf of ``sub`` (dicts, lists and tuples are
    containers, anything else a leaf)."""
    if isinstance(sub, Mapping):
        return {k: _broadcast(spec, v) for k, v in sub.items()}
    if isinstance(sub, (list, tuple)) and not is_spec(sub):
        return type(sub)(_broadcast(spec, v) for v in sub)
    return spec


def expand_specs(specs, params):
    """``specs`` (None, one spec, or a prefix tree of specs) as a full tree
    over ``params``, each spec broadcast over its params subtree."""
    if is_spec(specs) or specs is None:
        return _broadcast(P() if specs is None else specs, params)
    if isinstance(specs, Mapping):
        if not isinstance(params, Mapping) or set(specs) != set(params):
            raise ValueError(f"the spec tree's keys {sorted(specs)} do not "
                             f"match the params' "
                             f"{sorted(params) if isinstance(params, Mapping) else type(params).__name__}")
        return {k: expand_specs(specs[k], params[k]) for k in params}
    if isinstance(specs, (list, tuple)):
        if (not isinstance(params, (list, tuple))
                or len(specs) != len(params)):
            raise ValueError("the spec tree does not match the params' "
                             "structure")
        return type(params)(expand_specs(s, p)
                            for s, p in zip(specs, params))
    raise TypeError(f"param specs must be PartitionSpec leaves, got "
                    f"{type(specs).__name__}")


def normalize_param_specs(params: PyTree, specs: PyTree | None,
                          axes: Mapping[str, AxisSpec]) -> PyTree:
    """Expand the user's spec tree to a FULL per-leaf spec tree over
    ``params`` (the GLOBAL view: stacked leaves ``[n, ...]``) and validate
    it against the plan's axes.

    ``specs`` may be ``None`` (everything replicated), one spec
    (broadcast), or a prefix tree of specs (each broadcast over its
    params subtree). Each leaf spec is ``P()``, ``P(axis)`` or a
    canonical-order run of *stacked* plan axes (``P('pipe', 'model')``),
    one leading dim per named axis, each of its axis's size."""
    full = expand_specs(specs, params)

    def check(spec, leaf):
        entries = tuple(spec)
        if not entries:
            return
        if any(e is None for e in entries):
            raise ValueError(f"plan param specs use the leading-stack "
                             f"convention: P() or P(<stacked axes...>), got "
                             f"{spec}")
        for ax in entries:
            if ax not in axes or not axes[ax].stacked:
                stacked = [a for a, s in axes.items() if s.stacked]
                raise ValueError(
                    f"param spec {spec} names {ax!r}, but this plan's "
                    f"stacked axes are {stacked} (zero/data/seq shard "
                    f"state, batch and activations, never parameter leaves)")
        order = [CANONICAL_AXES.index(a) for a in entries]
        if len(set(entries)) != len(entries) or order != sorted(order):
            raise ValueError(f"multi-axis param spec {spec} must name "
                             f"distinct stacked axes in canonical order "
                             f"{CANONICAL_AXES}")
        shape = tuple(getattr(leaf, "shape", ()))
        for d, ax in enumerate(entries):
            lead = shape[d] if len(shape) > d else None
            if lead != axes[ax].size:
                raise ValueError(
                    f"leaf sharded {spec} must stack [{axes[ax].size}, ...] "
                    f"over {ax!r} at dim {d}; got leading dim {lead} (use "
                    f"stack_tp_params / stack_stage_params)")

    for spec, leaf in zip(pytree.tree_leaves(full),
                          pytree.tree_leaves(params)):
        check(spec, leaf)
    return full


def partition_groups(flat_specs: Sequence, axes: Mapping[str, AxisSpec]
                     ) -> dict:
    """Split flattened param leaves into update groups by their spec: each
    stacked spec (``model``, ``pipe``, or ``pipe+model``, keyed by
    ``'+'.join(axes)``) a group of its own; the replicated leaves the
    ``'zero'`` group when a ``state_stacked`` axis is present, else the
    plain ``'rep'`` group."""
    has_zero = any(s.state_stacked for s in axes.values())
    groups: dict = {}
    for i, spec in enumerate(flat_specs):
        entries = tuple(spec)
        key = "+".join(entries) if entries else (
            "zero" if has_zero else "rep")
        groups.setdefault(key, []).append(i)
    return groups


def group_stack_axes(group: str) -> tuple:
    """The stacked mesh axes a :func:`partition_groups` key names (empty
    for the ``zero``/``rep`` groups)."""
    if group in ("zero", "rep"):
        return ()
    return tuple(group.split("+"))


def owed_collectives(axes: Mapping[str, AxisSpec]) -> dict:
    """Per-axis collective vocabulary: what the structural tests count."""
    return {name: spec.collectives for name, spec in axes.items()}


def composition_collectives(comp) -> dict:
    """A :class:`~chainermn_tpu_torch.parallel.composition.Composition` as
    a spec provider: per mesh axis, the ``torch.distributed`` calls its
    stages owe the step, in stage order (``STAGE_CALLS``: the calls the
    port's tests count), which
    :class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan` reports for
    the ``data`` axis when ``grad_reduction=`` drives the gradient
    reduction."""
    from chainermn_tpu_torch.parallel.composition import STAGE_CALLS

    out: dict = {}
    for st in comp.stages:
        call = STAGE_CALLS.get(st.primitive)
        if call is None:
            continue
        for a in st.axes:
            out.setdefault(a, []).append(call)
    return {a: tuple(v) for a, v in out.items()}


__all__ = ["AxisSpec", "CANONICAL_AXES", "P", "PartitionSpec",
           "SEQ_ATTN_IMPLS", "SEQ_IMPL_COLLECTIVES", "composition_collectives",
           "expand_specs", "group_stack_axes", "moe_plan_axis",
           "normalize_param_specs", "owed_collectives", "partition_groups",
           "resolve_axes", "seq_plan_axis"]
