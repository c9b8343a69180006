"""ParallelPlan: one named rank mesh and one composed train step for
DP x ZeRO x pipeline x sequence x TP (counterpart of
``chainermn_tpu/parallel/plan.py``).

The JAX plan compiles ONE ``shard_map`` program over a named device mesh
in which the per-axis modules take part as *spec providers*
(:mod:`chainermn_tpu_torch.parallel.plan_specs`). The port runs one
process per rank: a plan lays the ranks of the default group out in a
named mesh (:func:`~chainermn_tpu_torch.parallel.mesh.make_mesh`, one
process group per axis, canonical axis order), and its step runs on every
rank with the rank's share of the batch and its slice of every stacked
leaf, making the collectives the providers owe:

- ``data``: the batch's rows shard over it, gradients are averaged over
  it (one all-reduce);
- ``zero``: data parallelism with a ZeRO-1 update
  (:mod:`chainermn_tpu_torch.parallel.zero`): the gradient mean arrives
  as a reduce-scatter onto this rank's ``1/n`` chunk of every leaf (the
  JAX ``_chunk_rows`` layout), the inner optimizer steps the chunk, and
  an all-gather returns the parameters;
- ``model``: tensor parallelism (:mod:`chainermn_tpu_torch.parallel.
  tensor`): marked leaves stack ``[n, ...]`` shards in the global view
  and each rank holds its own; the loss is written with the
  ``copy_to_tp``/``reduce_from_tp`` pairs over ``plan.group('model')``;
- ``pipe``: GPipe micro-batch pipelining (:mod:`chainermn_tpu_torch.
  parallel.pipeline`): stage leaves stack ``[n_stages, ...]`` and the
  step runs :func:`~chainermn_tpu_torch.parallel.pipeline.pipeline_local`
  wrapped in :func:`~chainermn_tpu_torch.parallel.pipeline.
  unscale_replicated_grads`;
- ``seq``: sequence parallelism: the batch's sequence dim shards over
  it, attention routes through the ring or Ulysses
  (:meth:`ParallelPlan.seq_attention`), and gradients take one mean over
  the axis before the dp reduction;
- ``expert``: MoE expert parallelism (:mod:`chainermn_tpu_torch.parallel.
  moe`): expert leaves stack ``[n, ...]`` shards (``P('expert')``), the
  batch's rows shard over it after the dp axes, and tokens ride exactly
  two all-to-alls a MoE layer a pass (:meth:`ParallelPlan.moe_layer`).
  An expert leaf's gradient takes no all-reduce (the all-to-all's
  backward already brought every rank's cotangents to its owner) and is
  divided by the axis size; every other leaf takes the mean over the
  axis, fused into the dp all-reduce.

``zero_stacked_groups=True`` chunks the STACKED groups' optimizer state
over the ``zero`` axis too (their dp mean becomes the zero chain:
reduce-scatter over ``zero`` > all-reduce over the other dp axes >
``1/z``-chunk update > all-gather over ``zero``); a leaf spec ``P('pipe',
'model')`` stacks a leaf over both axes.

The optimizer is a factory ``make_inner(params) -> torch.optim.Optimizer``
(or a :class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer`,
unwrapped by :func:`~chainermn_tpu_torch.optimizers.inner_transform`),
built once per update group over the tensors that group updates; with a
``zero`` axis it must be element-wise (the ZeRO constraint).

State layout: each rank keeps only its own slice of a stacked leaf and
its own chunk of zero-chunked state. :meth:`ParallelPlan.global_params`
gathers the global view (what JAX's ``jax.device_get(state.params)``
gives: ``[n, ...]`` stacked leaves), and :meth:`ParallelPlan.state_tree`
presents the state with ``DTensor`` leaves placed over the plan's mesh,
so the checkpointer writes each rank's shards as ``key@@index`` entries.
JAX's donation becomes the in-place update: a step returns the same
tensor objects and allocates no new state. JAX's jit-cache pin has no
counterpart.

``grad_reduction=`` drives the plain groups' data-parallel gradient
reduction by a composition over the dp axes (a menu name, a signature or
a ``Composition``), run by :func:`~chainermn_tpu_torch.parallel.
composition.reduce_composed_tree`: ``ar(all)`` is the reduction without
it, call for call; any other composition reduces each leaf through its
stages, and reports its calls as the ``data`` axis's owed collectives
(:func:`~chainermn_tpu_torch.parallel.plan_specs.composition_collectives`).

Left for later, each raising ``NotImplementedError`` naming its ROADMAP
item: ``seq_attention(impl='auto')`` and ``moe_layer(impl='auto')``
(item 8: the tuning registry).
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import math
from typing import Any, Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel import plan_specs as _ps
from chainermn_tpu_torch.parallel.mesh import best_mesh_shape, make_mesh
from chainermn_tpu_torch.parallel.plan_specs import P
from chainermn_tpu_torch.parallel.zero import ZeroShardOptimizer

PyTree = Any


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"item {item})")


@dataclasses.dataclass(frozen=True)
class PipelinePlanSpec:
    """How a plan with a ``pipe`` axis runs the pipelined region.

    ``stage_fn(params_local, x_mb) -> y_mb`` is one homogeneous stage
    (output shape == input shape) receiving the COLLAPSED param tree
    (pipe-stacked leaves arrive as this stage's slice). Every trainable
    leaf of a pipe plan must be pipe-stacked. ``loss_fn(y, batch) ->
    loss`` (or ``(loss, metrics_dict)``) maps the reassembled pipeline
    output to the local-batch-mean loss."""

    stage_fn: Callable
    loss_fn: Callable
    n_microbatches: Optional[int] = None
    #: pull the pipeline input out of the batch (default: ``batch[0]`` for
    #: tuple/list batches, else the batch itself)
    input_of: Optional[Callable] = None


def _pipe_input(batch):
    if isinstance(batch, (tuple, list)):
        return batch[0]
    return batch


class PlanTrainState(NamedTuple):
    """A plan step's state on one rank: ``params`` (the param tree, each
    stacked leaf as this rank's slice with its stacked dims collapsed),
    ``opt_state`` (``{group: optimizer}``: the inner torch optimizer
    over the group's leaves, or for a zero-chained group a
    :class:`~chainermn_tpu_torch.parallel.zero.ZeroShardOptimizer` whose
    inner optimizer steps this rank's chunks of them), ``step`` and
    ``model_state`` (replicated)."""

    params: PyTree
    opt_state: dict
    step: int = 0
    model_state: PyTree = ()


def _plan_loss(loss_fn: Callable) -> Callable:
    """``loss_fn(params, batch[, model_state])`` in any of the JAX forms
    (``loss``, ``(loss, metrics)``, ``(loss, (metrics, model_state))``) as
    ``(loss, metrics, model_state)``."""
    try:
        takes_state = len(inspect.signature(loss_fn).parameters) >= 3
    except (TypeError, ValueError):
        takes_state = False

    def run(params, batch, model_state):
        out = (loss_fn(params, batch, model_state) if takes_state
               else loss_fn(params, batch))
        if not isinstance(out, tuple):
            return out, {}, model_state
        loss, aux = out
        if isinstance(aux, tuple) and len(aux) == 2:
            return loss, aux[0], aux[1]
        return loss, aux, model_state

    return run


def _mean_packed(tensors: list, group, n: int) -> list:
    """The mean over ``group`` of each tensor, as one all-reduce a dtype
    (the tensors packed into one flat buffer)."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


class ParallelPlan:
    """One named rank mesh plus the specs to run a composed train step.

    Args:
      axes: a mapping ``{axis: size}`` (at most one size may be ``-1``,
        inferred from the world size) or a sequence of axis names,
        auto-factorised balanced with larger factors first
        (:func:`~chainermn_tpu_torch.parallel.mesh.best_mesh_shape`) in
        canonical order; names come from :data:`~chainermn_tpu_torch.
        parallel.plan_specs.CANONICAL_AXES`. Rank ``r`` of the default
        group sits at the row-major position ``r`` of the mesh.
      device: the ranks' device (``None``: the CUDA card, raising without
        one; the CPU tests pass ``'cpu'``).
      grad_reduction: the schedule of the non-ZeRO groups' dp gradient
        reduction: a menu name, a composition signature or a
        ``Composition`` over exactly the plan's dp axes (``data`` [+
        ``zero``]), validated here; a sharded update is refused (that is
        the ``zero`` axis's job). ``None`` keeps the packed mean.
      zero_stacked_groups: chunk the STACKED groups' optimizer state over
        the ``zero`` axis too. Needs a ``zero`` axis and a stacked axis.

    Needs the default process group (a communicator makes one).
    """

    def __init__(self, axes, *, device=None, grad_reduction=None,
                 zero_stacked_groups: bool = False) -> None:
        self.device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("a ParallelPlan needs the default process "
                               "group; create a communicator or call "
                               "torch.distributed.init_process_group first")
        n = dist.get_world_size()
        if isinstance(axes, Mapping):
            sizes = dict(axes)
            unknown = [a for a, s in sizes.items() if s == -1]
            if len(unknown) > 1:
                raise ValueError(f"at most one axis size may be -1, got "
                                 f"{unknown}")
            if unknown:
                rest = math.prod(s for a, s in sizes.items()
                                 if a not in unknown)
                if rest == 0 or n % rest:
                    raise ValueError(f"cannot infer {unknown[0]!r}: {n} ranks "
                                     f"do not factor over the explicit sizes "
                                     f"{sizes}")
                sizes[unknown[0]] = n // rest
        else:
            names = list(axes)
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate plan axes: {names}")
            ordered = [a for a in _ps.CANONICAL_AXES if a in names]
            _ps.resolve_axes(dict.fromkeys(names, 1))  # name validation
            sizes = dict(zip(ordered, best_mesh_shape(n, len(ordered))))
        self.axes: dict = _ps.resolve_axes(sizes)
        shape = tuple(s.size for s in self.axes.values())
        if math.prod(shape) != n:
            raise ValueError(
                f"plan axes {dict((a, s.size) for a, s in self.axes.items())}"
                f" cover {math.prod(shape)} mesh slots but {n} ranks run")
        self._zsg = bool(zero_stacked_groups)
        if self._zsg:
            if "zero" not in self.axes:
                raise ValueError("zero_stacked_groups=True needs a 'zero' "
                                 "axis to chunk the stacked groups' state "
                                 "over")
            if not any(s.stacked for s in self.axes.values()):
                raise ValueError("zero_stacked_groups=True needs a stacked "
                                 "axis ('model'/'pipe') whose state it can "
                                 "chunk — a plain zero plan already chunks "
                                 "everything")
            if grad_reduction is not None:
                raise ValueError("zero_stacked_groups and grad_reduction= "
                                 "are mutually exclusive: the stacked "
                                 "groups' reduction IS the zero composition "
                                 "(rs > ar > update > ag)")
        self._grad_comp = None
        if grad_reduction is not None:
            from chainermn_tpu_torch.parallel.composition import (
                compile_schedule,
            )

            if not self.dp_axes:
                raise ValueError(
                    "grad_reduction= needs a data-parallel axis "
                    "('data'/'zero') to reduce over; this plan has none")
            comp = compile_schedule(grad_reduction, self.dp_axes)
            if comp.has_update:
                raise ValueError(
                    f"grad_reduction composition {comp.signature()!r} "
                    "carries a sharded_update stage — the sharded update "
                    "is the 'zero' AXIS's job (add zero to the plan's "
                    "axes); grad_reduction takes pure reductions")
            self._grad_comp = comp
            # the composition is the data axis's spec provider; the zero
            # axis keeps its own entry (its groups' rs/ag are its job)
            owed = _ps.composition_collectives(comp)
            if "data" in owed and "data" in self.axes:
                self.axes["data"] = dataclasses.replace(
                    self.axes["data"], collectives=owed["data"])
        self.mesh = make_mesh(tuple(self.axes), shape, self.device)
        self.shape = shape
        self.coords = dict(zip(self.axes, np.unravel_index(
            dist.get_rank(), shape)))
        self.coords = {a: int(c) for a, c in self.coords.items()}
        #: one process group per axis, and one over each set of axes the
        #: step reduces over together (made here: every rank makes every
        #: group, in one order, as torch.distributed requires)
        self._groups = {(a,): self.mesh.get_group(a) for a in self.axes}
        dp, sq, ex = self.dp_axes, self._seq_axes, self._expert_axes
        for combo in dict.fromkeys((dp, dp + sq, dp + ex, dp + sq + ex)):
            if len(combo) > 1:
                self._groups[combo] = self._new_group(combo)
        #: the dp axes by name (the composed reduction's binding)
        self._dp_groups = C.AxisGroups(
            dp, [self._groups[(a,)] for a in dp],
            {dp: self._groups[dp]} if len(dp) > 1 else {})
        #: decision records the plan resolved (``seq_attn_impl``,
        #: ``moe_dispatch``)
        self.decisions: list = []
        self._seq_impl: Optional[str] = None
        self._moe_impl: Optional[str] = None

    def _new_group(self, axes: tuple):
        """The process group over ``axes`` through this rank (the ranks
        that share its coordinates on every other axis)."""
        names = list(self.axes)
        ranks = np.arange(math.prod(self.shape)).reshape(self.shape)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        mine = None
        for fixed in itertools.product(*(range(self.shape[i])
                                         for i in rest)):
            index = [slice(None)] * len(names)
            for i, c in zip(rest, fixed):
                index[i] = c
            members = sorted(int(r) for r in ranks[tuple(index)].reshape(-1))
            g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = g
        return mine

    # -- topology accessors -------------------------------------------------

    def axis_size(self, name: str) -> int:
        return self.axes[name].size if name in self.axes else 1

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on ``name`` (JAX ``lax.axis_index``)."""
        return self.coords[name] if name in self.axes else 0

    def group(self, *axes: str):
        """The process group of one axis (or of several, made when the
        plan was: the dp axes, and the dp axes with ``seq``, ``expert`` or
        both) through this rank."""
        key = tuple(axes)
        if key not in self._groups:
            raise ValueError(f"this plan has no process group over {key}; "
                             f"it has {sorted(self._groups)}")
        return self._groups[key]

    @property
    def _seq_axes(self) -> tuple:
        return ("seq",) if "seq" in self.axes else ()

    @property
    def _expert_axes(self) -> tuple:
        return ("expert",) if "expert" in self.axes else ()

    @property
    def _row_axes(self) -> tuple:
        """The axes the batch's rows shard over: the dp axes, then
        ``expert``."""
        return self.dp_axes + self._expert_axes

    @property
    def dp_axes(self) -> tuple:
        """Axes the batch rows shard (and gradients reduce) over."""
        return tuple(a for a in ("data", "zero") if a in self.axes)

    @property
    def dp_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.dp_axes) or 1

    def batch_spec(self) -> P:
        """Batch sharding: dim 0 over the dp axes (and ``expert``, which
        shards tokens by batch row too) and, with a ``seq`` axis, dim 1
        (the sequence) over it."""
        rows = self._row_axes
        if "seq" in self.axes:
            return P(rows if rows else None, "seq")
        return P(rows) if rows else P()

    def local_batch(self, batch: PyTree) -> PyTree:
        """This rank's share of a GLOBAL batch (every tensor or array leaf
        cut by :meth:`batch_spec`: its rows over the dp axes and
        ``expert``, major to minor in that order, and its sequence over
        ``seq``), as each device's shard of the JAX plan's batch."""
        row = 0
        for a in self._row_axes:
            row = row * self.axis_size(a) + self.axis_index(a)
        nrow = math.prod(self.axis_size(a) for a in self._row_axes)

        def cut(x):
            if not isinstance(x, (torch.Tensor, np.ndarray)):
                return x
            if nrow > 1:
                if x.shape[0] % nrow:
                    raise ValueError(f"batch dim {x.shape[0]} not divisible "
                                     f"by the row-shard count {nrow} (the "
                                     f"dp axes and expert)")
                b = x.shape[0] // nrow
                x = x[row * b:(row + 1) * b]
            if "seq" in self.axes:
                n, t = self.axis_size("seq"), x.shape[1]
                if t % n:
                    raise ValueError(f"sequence dim {t} not divisible by "
                                     f"the seq size {n}")
                i = self.axis_index("seq")
                x = x[:, i * (t // n):(i + 1) * (t // n)]
            return x

        return pytree.tree_map(cut, batch)

    def describe(self) -> dict:
        """Axis sizes and the collectives each spec provider owes the
        step."""
        out = {"mesh": {a: s.size for a, s in self.axes.items()},
               "collectives": _ps.owed_collectives(self.axes),
               "batch_spec": str(self.batch_spec())}
        if self._grad_comp is not None:
            out["grad_reduction"] = self._grad_comp.signature()
        if self._zsg:
            out["zero_stacked_groups"] = True
        if self._seq_impl is not None:
            out["seq_attn_impl"] = self._seq_impl
        if self._moe_impl is not None:
            out["moe_dispatch_impl"] = self._moe_impl
        return out

    # -- the seq axis's attention router ------------------------------------

    def seq_local_positions(self, t_local: int, device=None) -> torch.Tensor:
        """GLOBAL positions of this rank's ``t_local`` tokens (``axis_index
        * t_local + arange``): what sequence-parallel loss functions pass
        as the model's ``positions=``."""
        return (self.axis_index("seq") * t_local
                + torch.arange(t_local, device=device or self.device))

    def seq_attention(self, *, heads: int, t_local: int,
                      kv_heads: Optional[int] = None, impl: str = "auto",
                      causal: bool = True, block_q: int = 512,
                      block_k: int = 1024):
        """Resolve the ``seq_attn_impl`` decision and return ``(attn_fn,
        record)``: ``attn_fn`` matches the ``attention_fn`` contract of
        :class:`~chainermn_tpu_torch.models.transformer.TransformerBlock`
        and runs the ring (:func:`~chainermn_tpu_torch.parallel.
        ring_attention.seq_ring_attention_local`) or Ulysses
        (:func:`~chainermn_tpu_torch.parallel.ulysses.
        ulysses_attention_local`) over the plan's ``seq`` group.

        ``impl`` is ``'ring'`` or ``'ulysses'``; an explicit
        ``'ulysses'`` with indivisible heads is rejected at entry, naming
        both numbers. ``'auto'`` (the tuning registry) is ROADMAP item 8.
        The record ``{'name', 'key', 'winner', 'source': 'explicit'}`` is
        appended to ``plan.decisions``, and the resolved impl's owed
        collectives replace the seq axis's entry in :meth:`describe`."""
        from chainermn_tpu_torch.parallel.ring_attention import (
            seq_ring_attention_local,
        )
        from chainermn_tpu_torch.parallel.ulysses import (
            check_ulysses_divisibility,
            ulysses_attention_local,
        )

        if "seq" not in self.axes:
            raise ValueError("seq_attention needs a 'seq' plan axis")
        n = self.axis_size("seq")
        kvh = int(kv_heads or heads)
        if impl == "auto":
            raise _later("seq_attention(impl='auto') (the seq_attn_impl "
                         "decision through the tuning registry)", "8")
        if impl not in _ps.SEQ_ATTN_IMPLS:
            raise ValueError(f"seq_attn_impl must be one of "
                             f"{_ps.SEQ_ATTN_IMPLS + ('auto',)}, got "
                             f"{impl!r}")
        if impl == "ulysses":
            check_ulysses_divisibility(heads, kvh, n)
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else self.device.type)
        record = {"name": "seq_attn_impl",
                  "key": f"{kind}|{n}x{int(heads)}x{max(1, int(t_local))}"
                         f"|seqattn",
                  "winner": impl, "source": "explicit"}
        self.decisions.append(record)
        self._seq_impl = impl
        self.axes["seq"] = dataclasses.replace(
            self.axes["seq"], collectives=_ps.SEQ_IMPL_COLLECTIVES[impl])
        group = self.group("seq")

        if impl == "ring":
            def attn_fn(q, k, v, *, causal=causal, scale=None, **kw):
                return seq_ring_attention_local(
                    q, k, v, group, causal=causal, scale=scale,
                    block_q=block_q, block_k=block_k, **kw)
        else:
            def attn_fn(q, k, v, *, causal=causal, scale=None, **kw):
                return ulysses_attention_local(q, k, v, group, causal=causal,
                                               scale=scale, impl="flash",
                                               **kw)
        return attn_fn, record

    # -- the expert axis's MoE router ---------------------------------------

    def moe_layer(self, *, tokens_local: int, d_model: int,
                  experts_per_shard: int = 1,
                  capacity_factor: Optional[float] = 1.25, k: int = 1,
                  impl: str = "auto", dtype=None):
        """Resolve the ``moe_dispatch`` decision for the ``expert`` axis
        and return ``(moe_fn, record)``: ``moe_fn(x, router_w, expert_fn,
        expert_params) -> (out, aux)`` runs :func:`~chainermn_tpu_torch.
        parallel.moe.moe_layer_local` over ``plan.group('expert')`` with
        ``return_stats=True``, its stats reduced over the dp axes and
        ``expert`` (every axis the token dim shards over). ``aux`` holds
        the layout-invariant ``load_balance`` loss and the float32
        ``expert_load`` ``[E]``, ``dropped``, ``padded`` and ``capacity``.

        ``impl`` is ``'sort'`` or ``'einsum'``; ``'auto'`` (the tuning
        registry) is ROADMAP item 8. The record ``{'name':
        'moe_dispatch', 'key', 'winner', 'source': 'explicit'}`` is
        appended to ``plan.decisions`` and :meth:`describe` names the
        winner."""
        from chainermn_tpu_torch.parallel.moe import moe_layer_local

        if "expert" not in self.axes:
            raise ValueError("moe_layer needs an 'expert' plan axis")
        n = self.axis_size("expert")
        e_global = n * int(experts_per_shard)
        if k > e_global:
            raise ValueError(
                f"moe_layer k={k} exceeds n_experts={e_global} "
                f"({n} shards x {experts_per_shard} experts/shard)")
        if impl == "auto":
            raise _later("moe_layer(impl='auto') (the moe_dispatch decision "
                         "through the tuning registry)", "8")
        if impl not in ("sort", "einsum"):
            raise ValueError(f"moe_dispatch impl must be 'sort', 'einsum' or "
                             f"'auto', got {impl!r}")
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else self.device.type)
        dt = str(dtype if dtype is not None else torch.float32)
        record = {"name": "moe_dispatch",
                  "key": f"{kind}|{max(1, int(tokens_local))}x{e_global}x"
                         f"{int(d_model)}|{dt.replace('torch.', '')}",
                  "winner": impl, "source": "explicit"}
        self.decisions.append(record)
        self._moe_impl = impl
        group = self.group("expert")
        # the token dim shards over every row axis, so the stats reduce
        # over all of them: over 'expert' alone the aux loss would be a
        # mean of per-data-shard values under expert x data
        stats = self.group(*self._row_axes)

        def moe_fn(x, router_w, expert_fn, expert_params):
            return moe_layer_local(
                x, router_w, expert_fn, expert_params, group,
                capacity_factor=capacity_factor, k=k, dispatch_impl=impl,
                experts_per_shard=experts_per_shard, return_stats=True,
                stats_axes=stats)

        return moe_fn, record

    # -- specs --------------------------------------------------------------

    def param_specs(self, params: PyTree, specs: PyTree = None) -> PyTree:
        """The full per-leaf spec tree for the GLOBAL-view ``params``,
        validated against this plan's axes (see :func:`~chainermn_tpu_torch.
        parallel.plan_specs.normalize_param_specs`)."""
        return _ps.normalize_param_specs(params, specs, self.axes)

    def _groups_of(self, flat_specs):
        return _ps.partition_groups(flat_specs, self.axes)

    def _zero_chained(self, group: str) -> bool:
        return group == "zero" or (self._zsg and group != "rep")

    def state_specs(self, params: PyTree, specs: PyTree = None) -> dict:
        """``{'params': spec tree, 'opt_state': {group: spec}}``: the
        leading stacked axes of each param leaf and of each update group's
        optimizer-state leaves (JAX ``state_specs``' layout)."""
        spec_tree = self.param_specs(params, specs)
        groups = self._groups_of(pytree.tree_leaves(spec_tree))
        opt = {}
        for grp in groups:
            axes = _ps.group_stack_axes(grp)
            opt[grp] = P(*(axes + (("zero",) if self._zero_chained(grp)
                                   else ())))
        return {"params": spec_tree, "opt_state": opt}

    # -- state --------------------------------------------------------------

    def _local_leaf(self, leaf, spec) -> torch.Tensor:
        """This rank's slice of a global-view leaf, its stacked dims
        collapsed, as a fresh tensor on the plan's device."""
        for ax in tuple(spec):
            leaf = leaf[self.axis_index(ax)]
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf))
        return t.detach().to(self.device).clone()

    def create_train_state(self, params: PyTree, make_inner, *,
                           param_specs: PyTree = None,
                           model_state: PyTree = ()) -> PlanTrainState:
        """The plan state on this rank from the GLOBAL-view ``params``
        (tensors or numpy arrays; stacked leaves ``[n, ...]``): this rank's
        slice of each leaf as a new leaf tensor on the plan's device, and
        each update group's optimizer (the inner one over the leaves, or a
        ZeroShardOptimizer over them for a zero-chained group)."""
        from chainermn_tpu_torch.optimizers import inner_transform

        inner = inner_transform(make_inner)
        spec_tree = self.param_specs(params, param_specs)
        flat_g, treedef = pytree.tree_flatten(params)
        flat_s = pytree.tree_leaves(spec_tree)
        local = []
        for leaf, spec in zip(flat_g, flat_s):
            t = self._local_leaf(leaf, spec)
            if not t.is_floating_point():
                raise TypeError("every plan param leaf must be floating "
                                f"point, got {t.dtype}")
            local.append(t.requires_grad_())
        opt_state = {}
        for grp, idx in self._groups_of(flat_s).items():
            leaves = [local[i] for i in idx]
            if self._zero_chained(grp):
                # the zero chain: reduce-scatter over ``zero``, all-reduce
                # over the other dp axes, the 1/z-chunk update, all-gather
                other = tuple(a for a in self.dp_axes if a != "zero")
                opt = ZeroShardOptimizer(
                    inner, leaves, self.group("zero"),
                    extra_group=self.group(*other) if other else None)
            else:
                opt = inner(leaves)
            opt_state[grp] = opt
        model_state = pytree.tree_map(
            lambda x: torch.as_tensor(np.array(x) if isinstance(
                x, np.ndarray) else x).to(self.device), model_state)
        return PlanTrainState(params=pytree.tree_unflatten(local, treedef),
                              opt_state=opt_state, step=0,
                              model_state=model_state)

    # -- the step -----------------------------------------------------------

    def compile_train_step(self, loss_fn: Optional[Callable], make_inner,
                           params: PyTree = None, *,
                           param_specs: PyTree = None, donate: bool = True,
                           pipeline: Optional[PipelinePlanSpec] = None):
        """The composed train step: ``step(state, batch) -> (state,
        metrics)`` on this rank's share of the batch
        (:meth:`local_batch` cuts it from a global one).

        ``loss_fn(params, batch)`` is the shard-local loss (the local-batch
        mean; the JAX forms of :func:`_plan_loss`), written against the
        COLLAPSED param tree (stacked leaves arrive as this rank's slice).
        With a ``pipe`` axis pass ``pipeline=`` (the plan then never calls
        ``loss_fn``). ``make_inner`` is unwrapped as in
        :meth:`create_train_state`; the state it made carries the
        optimizers. ``params`` (the global-view template) validates the
        specs up front. ``donate=False`` is refused: the step always
        updates the state's tensors in place."""
        from chainermn_tpu_torch.optimizers import inner_transform

        if "pipe" in self.axes and pipeline is None:
            raise ValueError("this plan has a 'pipe' axis: pass pipeline="
                             "PipelinePlanSpec(stage_fn, loss_fn, ...)")
        if pipeline is not None and "pipe" not in self.axes:
            raise ValueError("pipeline= given but the plan has no 'pipe' "
                             "axis")
        if not donate:
            raise ValueError("donate=False has no counterpart: the port's "
                             "plan step updates the state in place")
        inner_transform(make_inner)  # refuses the wrappers it cannot carry
        if params is not None:
            spec_tree = self.param_specs(params, param_specs)
            self._check_pipe_specs(params, spec_tree, pipeline)
        return _PlanStep(self, loss_fn, param_specs, pipeline)

    def _check_pipe_specs(self, tree, spec_tree, pipeline):
        if pipeline is None:
            return
        keyed = pytree.tree_flatten_with_path(tree)[0]
        bad = [pytree.keystr(path) for (path, _), spec in
               zip(keyed, pytree.tree_leaves(spec_tree))
               if not (tuple(spec) and tuple(spec)[0] == "pipe")]
        if bad:
            raise ValueError(
                "every trainable leaf of a pipe plan must be pipe-stacked "
                f"(P('pipe') or P('pipe', 'model')); got {bad[:8]} — stage "
                "leaves carry their own slice per stage, and replicated "
                "leaves have no cross-stage gradient sum (the "
                "embed/head-outside contract of make_pipeline)")

    # -- views of the state -------------------------------------------------

    def _gather_stack(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        for ax in reversed(axes):
            t = C._all_gather(t.detach(), self.group(ax), 0, False)
        return t

    def global_params(self, state: PlanTrainState,
                      param_specs: PyTree = None) -> PyTree:
        """The GLOBAL view of ``state.params`` on every rank (a
        collective): each stacked leaf gathered into its ``[n, ...]``
        stack over its axes (JAX's ``jax.device_get(state.params)``)."""
        specs = _ps.expand_specs(param_specs, state.params)
        flat, treedef = pytree.tree_flatten(state.params)
        out = [self._gather_stack(t, tuple(s)) if tuple(s) else t.detach()
               for t, s in zip(flat, pytree.tree_leaves(specs))]
        return pytree.tree_unflatten(out, treedef)

    def _dtensor(self, local: torch.Tensor, axes: tuple):
        """``local`` (this rank's block) as a DTensor over the plan's mesh:
        one leading dim per axis of ``axes``, sharded over that axis."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        names = list(self.axes)
        t = local.detach()
        for _ in axes:
            t = t.unsqueeze(0)
        placements = [Replicate()] * len(names)
        for d, ax in enumerate(axes):
            placements[names.index(ax)] = Shard(d)
        shape = tuple(self.axis_size(a) for a in axes) + tuple(local.shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(t.contiguous(), self.mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    def state_tree(self, state: PlanTrainState,
                   param_specs: PyTree = None) -> dict:
        """The state as a tree of tensors for the checkpointer: ``params``
        (each stacked leaf a DTensor of its global ``[n, ...]`` shape),
        ``opt_state`` (per group, each parameter's optimizer state, every
        tensor a DTensor stacked over the group's axes: ``[z, ...]`` over
        ``zero`` for chunked state, as JAX's stacked state leaves),
        ``step`` and ``model_state``. Every optimizer must hold its state
        (after a step; :meth:`load_checkpoint` primes a fresh template)."""
        specs = _ps.expand_specs(param_specs, state.params)
        flat, treedef = pytree.tree_flatten(state.params)
        flat_s = pytree.tree_leaves(specs)
        params = pytree.tree_unflatten(
            [self._dtensor(t, tuple(s)) if tuple(s) else t.detach()
             for t, s in zip(flat, flat_s)], treedef)
        opt_tree = {}
        for grp, opt in state.opt_state.items():
            axes = _ps.group_stack_axes(grp) + (
                ("zero",) if self._zero_chained(grp) else ())
            sd = opt.state_dict()
            n_params = sum(len(g["params"]) for g in sd["param_groups"])
            if len(sd["state"]) != n_params:
                raise ValueError(
                    f"the {grp!r} group's optimizer holds no state for some "
                    "of its tensors: take a step first, or restore into a "
                    "fresh state through ParallelPlan.load_checkpoint")
            opt_tree[grp] = {
                "state": {i: {k: (self._dtensor(v, axes)
                                  if isinstance(v, torch.Tensor) and axes
                                  else v)
                              for k, v in s.items()}
                          for i, s in sd["state"].items()},
                "param_groups": sd["param_groups"]}
        tree = {"params": params, "opt_state": opt_tree, "step": state.step}
        if pytree.tree_leaves(state.model_state):
            tree["model_state"] = state.model_state
        return tree

    def load_state_tree(self, state: PlanTrainState,
                        tree: dict) -> PlanTrainState:
        """Load a :meth:`state_tree` (e.g. restored by the checkpointer)
        into ``state`` in place; returns it with the tree's step."""
        flat, _ = pytree.tree_flatten(state.params)
        saved = pytree.tree_leaves(tree["params"])
        with torch.no_grad():
            for t, s in zip(flat, saved):
                if hasattr(s, "to_local"):
                    s = s.to_local().reshape(t.shape)
                t.copy_(s)
        for grp, opt in state.opt_state.items():
            sd = tree["opt_state"][grp]
            depth = len(_ps.group_stack_axes(grp)) + self._zero_chained(grp)
            local = {}
            for i, st in sd["state"].items():
                local[i] = {}
                for k, v in st.items():
                    if hasattr(v, "to_local"):
                        v = v.to_local()
                        v = v.reshape(v.shape[depth:])
                    local[i][k] = v
            opt.load_state_dict({"state": local,
                                 "param_groups": sd["param_groups"]})
        model_state = tree.get("model_state", state.model_state)
        return state._replace(step=tree["step"], model_state=model_state)

    def load_checkpoint(self, checkpointer, state: PlanTrainState, **kw):
        """Resume ``state`` from ``checkpointer``'s newest common snapshot
        (saved as ``checkpointer.save(plan.state_tree(state), it)``):
        returns ``(state, iteration)``, or ``(state, None)`` with the state
        untouched when there is none. A fresh state's optimizers are first
        given their state by one zero-gradient step at learning rate 0
        (the checkpointer's priming of a template); that state is dropped
        again when nothing is restored."""
        from chainermn_tpu_torch.extensions.checkpoint import (
            _prime_optimizer,
            _unprime,
        )

        primed = [opt for opt in state.opt_state.values()
                  if _prime_optimizer(opt)]
        try:
            tree, it = checkpointer.maybe_load(self.state_tree(state), **kw)
        except BaseException:
            for opt in primed:
                _unprime(opt)
            raise
        if it is None:
            for opt in primed:
                _unprime(opt)
            return state, None
        return self.load_state_tree(state, tree), it


class _PlanStep:
    """The composed step of :meth:`ParallelPlan.compile_train_step`."""

    def __init__(self, plan: ParallelPlan, loss_fn, param_specs, pipeline):
        self.plan = plan
        self.param_specs = param_specs
        self.pipeline = pipeline
        self.lfn = None if pipeline is not None else _plan_loss(loss_fn)
        self.plan_info = plan.describe()

    def _pipe_loss(self, params_c, batch):
        from chainermn_tpu_torch.parallel.pipeline import (
            pipeline_local,
            unscale_replicated_grads,
        )

        plan, pipe = self.plan, self.pipeline
        g = plan.group("pipe")
        x = (pipe.input_of or _pipe_input)(batch)
        n_micro = pipe.n_microbatches or plan.axis_size("pipe")
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"local batch {b} not divisible by "
                             f"n_microbatches {n_micro}")
        xm = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
        ym = pipeline_local(pipe.stage_fn, params_c, xm, g)
        # every stage computes the same loss from the replicated outputs;
        # the replication's transpose would scale the cotangent by n_stages
        ym = unscale_replicated_grads(ym, g)
        out = pipe.loss_fn(ym.reshape((b,) + tuple(ym.shape[2:])), batch)
        if isinstance(out, tuple):
            return out[0], out[1]
        return out, {}

    def __call__(self, state: PlanTrainState, batch):
        plan = self.plan
        specs = _ps.expand_specs(self.param_specs, state.params)
        flat_s = pytree.tree_leaves(specs)
        flat_p = pytree.tree_leaves(state.params)
        groups = plan._groups_of(flat_s)
        if set(groups) != set(state.opt_state):
            raise ValueError(f"the state's update groups "
                             f"{sorted(state.opt_state)} are not the specs' "
                             f"{sorted(groups)}: pass the param_specs the "
                             "state was created with")
        if self.pipeline is not None:
            plan._check_pipe_specs(state.params, specs, self.pipeline)
        with torch.enable_grad():
            if self.pipeline is None:
                loss, metrics, model_state = self.lfn(
                    state.params, batch, state.model_state)
            else:
                loss, metrics = self._pipe_loss(state.params, batch)
                model_state = state.model_state
            grads = torch.autograd.grad(loss, flat_p, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(flat_p, grads)]
        if "seq" in plan.axes:
            # each seq shard computed the mean loss of its OWN tokens: one
            # mean makes every gradient the global token mean, before the
            # dp reduction
            grads = _mean_packed(grads, plan.group("seq"),
                                 plan.axis_size("seq"))
        # the expert shards also each computed the mean loss of their OWN
        # tokens. An expert leaf's gradient already gathered every shard's
        # cotangents through the all-to-all's backward (an all-reduce would
        # mix different experts): it is only divided by the axis size. Every
        # other leaf takes the mean over 'expert': fused into the dp
        # all-reduce below for the plain groups, on its own before a
        # zero-chained group's reduce-scatter
        expert = {i for i, s in enumerate(flat_s) if "expert" in tuple(s)}
        n_exp = plan.axis_size("expert")
        ex = plan._expert_axes
        for i in expert:
            grads[i] = grads[i] / n_exp
        chained = [i for grp, idx in groups.items()
                   if plan._zero_chained(grp) for i in idx
                   if i not in expert]
        if ex and chained:
            reduced = _mean_packed([grads[i] for i in chained],
                                   plan.group("expert"), n_exp)
            for i, g in zip(chained, reduced):
                grads[i] = g
        # the plain groups (replicated, and stacked without
        # zero_stacked_groups): the dp mean (with the expert mean), one
        # all-reduce for all, or the grad_reduction composition over the
        # dp axes (after the expert mean of the non-expert leaves)
        plain = [i for grp, idx in groups.items()
                 if not plan._zero_chained(grp) for i in idx]
        if plan._grad_comp is not None:
            from chainermn_tpu_torch.parallel.composition import (
                reduce_composed_tree,
            )

            rest = [i for i in plain if i not in expert]
            if ex and rest:
                for i, g in zip(rest, _mean_packed(
                        [grads[i] for i in rest], plan.group("expert"),
                        n_exp)):
                    grads[i] = g
            if plain:
                for i, g in zip(plain, reduce_composed_tree(
                        [grads[i] for i in plain], plan._grad_comp,
                        plan._dp_groups)):
                    grads[i] = g
            plain = []
        for axes, idx in ((plan.dp_axes + ex,
                           [i for i in plain if i not in expert]),
                          (plan.dp_axes, [i for i in plain if i in expert])):
            if axes and idx:
                n = math.prod(plan.axis_size(a) for a in axes)
                reduced = _mean_packed([grads[i] for i in idx],
                                       plan.group(*axes), n)
                for i, g in zip(idx, reduced):
                    grads[i] = g
        with torch.no_grad():
            # each group's optimizer: the inner one over the leaves, or the
            # ZeroShardOptimizer of a zero-chained group
            for grp, idx in groups.items():
                for i in idx:
                    flat_p[i].grad = grads[i]
                state.opt_state[grp].step()
                for i in idx:
                    flat_p[i].grad = None
        names = ["loss", *metrics]
        # every metric rides one packed mean (the MoE stats are vectors)
        vals = [torch.as_tensor(v).detach().float().to(plan.device)
                for v in (loss, *metrics.values())]
        red = plan.dp_axes + plan._seq_axes + plan._expert_axes
        if red:
            n = math.prod(plan.axis_size(a) for a in red)
            vals = _mean_packed(vals, plan.group(*red), n)
            if pytree.tree_leaves(model_state):
                leaves, spec = pytree.tree_flatten(model_state)
                model_state = pytree.tree_unflatten(
                    _mean_packed([t.detach().float() for t in leaves],
                                 plan.group(*red), n), spec)
        return (state._replace(step=state.step + 1, model_state=model_state),
                dict(zip(names, vals)))

__all__ = ["ParallelPlan", "PipelinePlanSpec", "PlanTrainState"]
