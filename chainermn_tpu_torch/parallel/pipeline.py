"""Pipeline parallelism over a stage group — GPipe (plain, interleaved,
heterogeneous) and 1F1B (counterpart of
``chainermn_tpu/parallel/pipeline.py``).

The JAX engines run all stages in ONE SPMD program over a ``'stage'``
mesh axis: a ``lax.scan`` over schedule ticks, a ``ppermute`` hop each
tick, and ``jax.grad`` of the scan for the backward. The port runs one
process per rank, rank ``s`` of the stage group being stage ``s``: each
rank runs its own stage's tick loop, and the hop is
:func:`~chainermn_tpu_torch.parallel.collectives.ppermute`'s transfer
(``batch_isend_irecv``). The schedules, their tick formulas and the
parameter layouts are the JAX ones.

Every rank makes the same ``torch.distributed`` calls in the same order,
forward and backward: one transfer a tick (1F1B: two, the activations
forward and the cotangents back), whether or not the rank's stage runs
at that tick. A stage that is idle (fill and drain) runs nothing and
sends zeros, where the JAX stage computes on zeros and masks its
output. The GPipe engines are one ``torch.autograd.Function`` whose
backward replays the ticks in reverse: each stage's saved graph is
differentiated with the cotangent that arrives from the next stage, so
the backward's transfers cannot wait on the order in which autograd
reaches them. 1F1B is an explicit schedule: forward ticks run
``stage_fn`` without a graph, backward ticks recompute the stage from
its saved input and take ``torch.autograd.grad`` of it.

Where JAX differentiates from outside ``shard_map`` and the port's
ranks are all inside, the boundary of the ``make_*`` engines is defined
so that on every rank the gradient of every leaf is JAX's global-view
gradient of ONE loss that every rank computes alike from the replicated
output: the output's cotangent is taken once (the last stage's own,
not the sum over the ranks), the input's cotangent, which only stage 0
produces, is broadcast to every rank (an embedding before the pipeline
gets its whole gradient on every rank), and the heterogeneous engine's
replicated parameters get each stage's gradient on every rank. The
``*_local`` functions keep the JAX inside-``shard_map`` meaning: the
gradient of the SUM of the ranks' losses, as every function of
:mod:`~chainermn_tpu_torch.parallel.collectives` gives (wrap the output
in :func:`unscale_replicated_grads` to count a replicated loss once).

A ``mesh`` is a ``DeviceMesh`` (:func:`~chainermn_tpu_torch.parallel.
mesh.make_mesh`), whose ``axis_name`` group is the stage group and
``batch_axis`` group the data group, or, for a stage axis alone, a
process group or a communicator (``None``: the default group). A rank
passes and updates only its own stage's parameters (``[v, ...]`` chunks
under interleaving), as ``P(axis_name)`` hands each device its slice
(:func:`chainermn_tpu_torch.convert.stage_params_from_stack` takes a
rank's slice of a JAX stack); with ``batch_axis`` it passes its own
share of the batch, as ``P(batch_axis)`` hands each device its rows.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch.parallel import collectives as C

PyTree = Any


def unscale_replicated_grads(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; cotangent divided by the group size backward.

    :func:`pipeline_local` replicates its outputs as a ``psum`` does, and
    its backward sums the ranks' cotangents (the ``psum`` transpose), so
    when every stage computes the same loss from the replicated outputs
    the cotangent arrives scaled by ``n_stages``. Wrapping the output in
    this adjoint restores exactness. The ``make_*`` engines need no
    correction: their boundary takes the output's cotangent once."""
    g = C.as_group(group)
    n = C.axis_size_of(g)
    return C._linear(x, lambda v: v.view_as(v), lambda ct: ct / n)


def pipe_plan_axis(axis_name: str = "pipe") -> dict:
    """Spec-provider descriptor for the ``ParallelPlan``: stage parameters
    stack a leading ``[n_stages, ...]`` dim over ``axis_name`` (the
    :func:`stack_stage_params` layout), and the axis owes the step the
    conveyor's transfer (one a schedule tick, forward and backward).
    Leaves consumed INSIDE ``stage_fn`` must be pipe-stacked; replicated
    leaves (embed/head) belong outside the pipelined region."""
    return {
        "name": axis_name,
        "stacked": True,
        "state_stacked": False,
        "collectives": ("collective-permute",),
    }


def pipeline_total_ticks(n_stages: int, n_micro: int,
                         virtual_stages: int = 1) -> int:
    """Schedule length of :func:`pipeline_local` in conveyor ticks (one
    chunk execution per stage per tick).

    ``virtual_stages == 1``: the classic GPipe ``n_micro + n - 1``, bubble
    fraction ``(n-1)/(n_micro + n - 1)``.

    ``virtual_stages == v > 1``: microbatches stream in waves of ``n``
    through the looped conveyor; each wave occupies ``v*n`` ticks per
    stage back-to-back, so for ``n | n_micro`` the total is
    ``v*n_micro + n - 1`` and the bubble fraction shrinks to
    ``(n - 1) / (v*n_micro + n - 1)``. Partial waves still occupy a full
    ``v*n``-tick wave slot (choose ``n_micro`` a multiple of
    ``n_stages``)."""
    if virtual_stages == 1:
        return n_micro + n_stages - 1
    waves = -(-n_micro // n_stages)
    return virtual_stages * n_stages * waves + n_stages - 1


# ---------------------------------------------------------------------------
# mesh axes, parameter trees
# ---------------------------------------------------------------------------

def _axis_group(mesh, axis_name: str):
    """The process group of ``axis_name``: ``mesh.get_group`` of a
    ``DeviceMesh``; else ``mesh`` is the group itself (or a
    communicator), for a stage axis alone."""
    if isinstance(mesh, DeviceMesh):
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise ValueError(f"mesh has axes {names}, not {axis_name!r}")
        return mesh.get_group(axis_name)
    return C.as_group(mesh)


def _batch_group(mesh, batch_axis: Optional[str]):
    if batch_axis is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"batch_axis={batch_axis!r} needs a DeviceMesh "
                         "that names it (make_mesh)")
    return _axis_group(mesh, batch_axis)


def _detached(tree: PyTree, grad: bool) -> PyTree:
    """``tree`` with each tensor detached, requiring grad again when
    ``grad`` and the tensor did: a stage's own leaves of a saved tick
    graph."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        return t.detach().requires_grad_(grad and t.requires_grad)

    return pytree.tree_map(leaf, tree)


def _to_meta(tree: PyTree) -> PyTree:
    return pytree.tree_map(
        lambda t: t.detach().to("meta") if isinstance(t, torch.Tensor)
        else t, tree)


def _bcast(t: torch.Tensor, group, root: int, n: int) -> torch.Tensor:
    return C._bcast(t, group, root) if n > 1 else t


def _microbatches(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(
            f"batch {batch} not divisible by n_microbatches {n_micro}")
    return x.reshape((n_micro, batch // n_micro) + tuple(x.shape[1:]))


def _new_stats(stats: Optional[dict]) -> dict:
    """The caller's stats dict, emptied for this call (or a new one)."""
    out = {} if stats is None else stats
    out.clear()
    return out


# ---------------------------------------------------------------------------
# the GPipe conveyor (plain, interleaved, heterogeneous)
# ---------------------------------------------------------------------------

class _Op(NamedTuple):
    """What one stage runs at one tick: microbatch ``i`` through
    ``chunk`` (the interleaved chunk ``j``, or the heterogeneous stage's
    own function), fed from the batch (``feed``) or the conveyor, its
    output banked (``bank``) and/or sent on (``send``)."""

    i: int
    chunk: int
    feed: bool
    bank: bool
    send: bool


class _Conveyor:
    """One stage's GPipe schedule: ``ops[t]`` (an :class:`_Op`, None when
    idle), one transfer each tick, and the ticks' replay in reverse.

    ``fns[c]`` is chunk ``c``'s function and ``chunk_params(c, leaves,
    grad)`` gives ``(params, refs)``: its parameter tree from this rank's
    flat leaves, detached, and ``refs``, the ``(leaf index, tensor)`` of
    each tensor in it that requires grad. ``act`` is the conveyor's
    ``(shape, dtype)``, ``bank`` the banked ``[n_micro, ...]`` output's.
    ``outside`` selects the boundary of the module docstring: the
    output's cotangent taken once and the input's broadcast from stage 0,
    against the ``psum`` transpose of the ``*_local`` functions."""

    def __init__(self, *, group, ops, perm, fns, chunk_params, act, bank,
                 outside, stats):
        self.group = group
        self.n = C.axis_size_of(group)
        self.ops, self.perm = ops, perm
        self.inverse = [(d, s) for s, d in perm]
        self.fns = fns
        self.chunk_params = chunk_params
        self.act, self.bank = act, bank
        self.outside = outside
        self.stats = stats

    def _zeros(self, shape_dtype, like: torch.Tensor) -> torch.Tensor:
        return torch.zeros(shape_dtype[0], dtype=shape_dtype[1],
                           device=like.device)

    def forward(self, x: torch.Tensor, leaves: list, keep: bool):
        """Run the ticks. ``keep`` holds each op's graph for
        :meth:`backward`, in ``self.kept`` (``{tick: (inp, out)}``) and
        ``self.chunks``. Returns the banked outputs, replicated from the
        last stage."""
        used = sorted({op.chunk for op in self.ops if op is not None})
        self.chunks = {c: self.chunk_params(c, leaves, keep) for c in used}
        self.kept = {}
        outputs = self._zeros(self.bank, x)
        calls = 0
        buf = None
        for t, op in enumerate(self.ops):
            out = None
            if op is not None:
                inp = x[op.i] if op.feed else buf
                params = self.chunks[op.chunk][0]
                if keep:
                    inp = inp.detach()
                    if inp.is_floating_point() and (
                            not op.feed or x.requires_grad):
                        inp.requires_grad_()
                    with torch.enable_grad():
                        out = self.fns[op.chunk](params, inp)
                    self.kept[t] = (inp, out)
                else:
                    out = self.fns[op.chunk](params, inp)
                calls += 1
                if op.bank:
                    outputs[op.i] = out.detach()
            send = (out.detach() if out is not None and op.send
                    else self._zeros(self.act, x))
            buf = C._permute(send, self.group, self.perm)
        self.stats.update(ticks=len(self.ops), stage_calls=calls,
                          saved_inputs=len(self.kept))
        return _bcast(outputs, self.group, self.n - 1, self.n)

    def backward(self, ct: torch.Tensor, x_spec, x_grad: bool):
        """The ticks in reverse: each tick's transfer backward (the
        inverse permutation), then the op's graph under the cotangent its
        output got. ``x_spec`` is the input's (shape, dtype). Returns
        ``(dx, {(chunk, leaf index): grad})``."""
        if not self.outside and self.n > 1:
            ct = C._all_reduce(ct, self.group)  # the psum transpose
        dx = self._zeros(x_spec, ct) if x_grad else None
        grads = {}
        ct_recv = None  # the cotangent of what this rank received at t
        for t in reversed(range(len(self.ops))):
            sent = C._permute(self._zeros(self.act, ct) if ct_recv is None
                              else ct_recv, self.group, self.inverse)
            ct_recv = None
            op = self.ops[t]
            if op is None:
                continue
            inp, out = self.kept.pop(t)
            cto = sent if op.send else None
            if op.bank:
                cto = ct[op.i] if cto is None else cto + ct[op.i]
            refs = self.chunks[op.chunk][1]
            wrt = [r for _, r in refs] + ([inp] if inp.requires_grad else [])
            if not wrt or not out.requires_grad:
                continue
            got = torch.autograd.grad(out, wrt, cto.to(out.dtype),
                                      allow_unused=True)
            for (k, _), g in zip(refs, got):
                if g is not None:
                    key = (op.chunk, k)
                    grads[key] = g if key not in grads else grads[key] + g
            dinp = got[-1] if inp.requires_grad else None
            if dinp is None:
                continue
            if op.feed:
                if dx is not None:
                    dx[op.i] = dinp
            else:
                ct_recv = dinp
        if dx is not None and self.outside:
            dx = _bcast(dx, self.group, 0, self.n)
        self.chunks = None
        return dx, grads


def _remat(f: Callable) -> Callable:
    """``f`` under ``torch.utils.checkpoint`` (``jax.checkpoint``'s
    role): its backward recomputes it from its inputs."""
    return lambda p, a: checkpoint(f, p, a, use_reentrant=False)


class _ConveyorFn(torch.autograd.Function):
    """The conveyor as one differentiable op of the batch ``x`` and this
    rank's parameter leaves: the forward runs the ticks, the backward
    replays them; ``grads_of`` turns the chunks' gradients into the
    leaves'."""

    @staticmethod
    def forward(ctx, conv, grads_of, x, *leaves):
        ctx.conv, ctx.grads_of = conv, grads_of
        ctx.x_spec = (x.shape, x.dtype)
        return conv.forward(x, list(leaves), True)

    @staticmethod
    def backward(ctx, ct):
        dx, grads = ctx.conv.backward(ct.contiguous(), ctx.x_spec,
                                      ctx.needs_input_grad[2])
        ctx.conv = None
        return (None, None, dx,
                *ctx.grads_of(grads, ctx.needs_input_grad[3:]))


def _run_conveyor(conv: _Conveyor, grads_of: Callable, x: torch.Tensor,
                  leaves: list) -> torch.Tensor:
    """Differentiate through the conveyor when grad mode is on and ``x``
    or a leaf requires grad; else run the ticks under ``no_grad``."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in [x] + leaves):
        return _ConveyorFn.apply(conv, grads_of, x, *leaves)
    with torch.no_grad():
        return conv.forward(x, leaves, False)


def _chunk_params(spec, *, sliced: bool, offset: int = 0,
                  count: Optional[int] = None):
    """``chunk_params`` over flat leaves: the tree ``spec`` of leaves
    ``[offset, offset + count)``, each at index ``c`` when ``sliced`` (an
    interleaved chunk ``c``'s slice of the ``[v, ...]`` leaves)."""
    def make(c, leaves, grad):
        sel = leaves[offset:len(leaves) if count is None
                     else offset + count]
        if sliced:
            sel = [t[c] if isinstance(t, torch.Tensor) else t for t in sel]
        det = _detached(sel, grad)
        refs = [(offset + k, t) for k, t in enumerate(det)
                if isinstance(t, torch.Tensor) and t.requires_grad]
        return pytree.tree_unflatten(det, spec), refs
    return make


def _homogeneous(stage_fn, stage_params, x, group, virtual_stages,
                 outside, stats):
    n = C.axis_size_of(group)
    s = C.axis_index(group)
    v = virtual_stages
    n_micro = x.shape[0]
    leaves, spec = pytree.tree_flatten(stage_params)
    if v > 1:
        firsts = [t.shape[0] for t in leaves if isinstance(t, torch.Tensor)]
        if firsts and firsts[0] != v:
            raise ValueError(
                f"virtual_stages={v} needs params stacked to leading dim "
                f"n_stages*virtual_stages={n * v} (per-stage slice {v}); "
                f"got per-stage slice {firsts[0]} — use "
                f"stack_interleaved_stage_params")
    ops = []
    for t in range(pipeline_total_ticks(n, n_micro, v)):
        d = t - s
        j = (d % (v * n)) // n  # this tick's model chunk
        i = d if v == 1 else (d // (v * n)) * n + d % n
        # stage 0 chunk 0 eats microbatch i; everything else eats the
        # conveyor (stage 0's later chunks the loop-back from stage n - 1)
        ops.append(_Op(i, j, s == 0 and j == 0, s == n - 1 and j == v - 1,
                       True) if d >= 0 and i < n_micro else None)
    # v == 1: stage i -> i+1 (the last output falls off); v > 1: the full
    # rotation, the last stage's chunk-j output is stage 0's chunk j+1 input
    perm = ([(i, i + 1) for i in range(n - 1)] if v == 1
            else [(i, (i + 1) % n) for i in range(n)])

    def grads_of(grads, needs):
        out = []
        for k, (t, need) in enumerate(zip(leaves, needs)):
            if not need:
                out.append(None)
                continue
            per = [grads.get((c, k)) for c in range(v)]
            per = [torch.zeros_like(t if v == 1 else t[c]) if g is None
                   else g for c, g in enumerate(per)]
            out.append(per[0] if v == 1 else torch.stack(per))
        return out

    mb = tuple(x.shape[1:])
    conv = _Conveyor(group=group, ops=ops, perm=perm, fns=[stage_fn] * v,
                     chunk_params=_chunk_params(spec, sliced=v > 1),
                     act=(mb, x.dtype), bank=((n_micro,) + mb, x.dtype),
                     outside=outside, stats=stats)
    return _run_conveyor(conv, grads_of, x, leaves)


def pipeline_local(stage_fn: Callable, stage_params: PyTree,
                   x: torch.Tensor, group=None, virtual_stages: int = 1,
                   *, stats: Optional[dict] = None) -> torch.Tensor:
    """Run the (interleaved) GPipe schedule on this rank's stage of
    ``group`` (the JAX function runs INSIDE ``shard_map`` over the stage
    axis).

    Args:
      stage_fn: ``stage_fn(params, x_microbatch) -> y_microbatch`` — one
        pipeline stage; output shape/dtype must equal input shape/dtype
        (stage-to-stage activations travel a homogeneous conveyor).
      stage_params: this stage's parameter pytree; with ``virtual_stages
        == v > 1`` the leaves keep a leading ``[v, ...]`` axis — this
        stage's model chunks (global stage ``j*n + s`` is chunk ``j``
        here; see :func:`stack_interleaved_stage_params`).
      x: ``[n_micro, mb, ...]`` microbatched input (the same on every
        stage; only stage 0 consumes it).
      group: the stage group (a process group or a communicator; None:
        the default group); this rank's index in it is its stage.
      virtual_stages: interleave ``v`` model chunks per physical stage —
        the looped conveyor: microbatch ``i`` (wave ``w = i // n``, slot
        ``r = i % n``) runs chunk ``j`` on stage ``s`` at tick ``t =
        w*v*n + j*n + r + s``; activations hop ``s → s+1`` every tick and
        the last stage's chunk-``j`` output loops back to stage 0 as
        chunk ``j+1``'s input, arriving exactly one tick later. The
        bubble shrinks to ``(n-1)/(v*n_micro + n - 1)``
        (:func:`pipeline_total_ticks`). Interleave for bubble (GPipe
        memory profile, pair with ``remat_stages``), 1F1B for memory.
      stats: a dict that receives this rank's ``ticks``, ``stage_calls``
        (forward stage executions: ``v * n_micro``, idle ticks run
        nothing) and ``saved_inputs`` (stage inputs held for the
        backward: one per execution, where the JAX scan saves one per
        tick, idle ticks included).

    Returns:
      ``[n_micro, mb, ...]`` — the final chunk's outputs, replicated from
      the last stage to every stage. Differentiable with the JAX
      inside-``shard_map`` meaning: the backward sums the ranks'
      cotangents of the output, and only stage 0 receives the input's.
    """
    return _homogeneous(stage_fn, stage_params, x, C.as_group(group),
                        virtual_stages, False, _new_stats(stats))


def make_pipeline(stage_fn: Callable, mesh, *, axis_name: str = "stage",
                  n_microbatches: Optional[int] = None,
                  remat_stages: bool = False,
                  batch_axis: Optional[str] = None,
                  virtual_stages: int = 1):
    """Build the pipelined apply over this rank's stage parameters.

    Returns ``fn(stage_params, x) -> y`` where ``stage_params`` is this
    rank's stage (leaves ``[v, ...]`` with ``virtual_stages=v``, in the
    layout of :func:`stack_interleaved_stage_params`) and ``x`` the
    batch ``[batch, ...]``, the same on every stage; the batch is split
    into ``n_microbatches`` equal microbatches (default: the stage
    count). ``y`` is on every rank. Differentiable with the boundary of
    the module docstring: a loss every rank computes alike from ``y``
    gives each rank its stage's gradient and the whole gradient of
    ``x`` (so of an embedding before the pipeline), as JAX's
    ``jax.grad`` from outside ``shard_map`` gives them.

    ``remat_stages=True`` checkpoints each stage (``torch.utils.
    checkpoint``): the backward recomputes each stage's internal
    activations instead of storing them per tick; the per-tick stage
    inputs are still saved, so the saving scales with stage depth.

    ``batch_axis`` composes data parallelism (a 2-D ``(batch_axis,
    axis_name)`` mesh): ``x`` is this rank's share of the batch, each
    data slice runs its own schedule over the stage axis, and
    ``n_microbatches`` splits the local batch. Gradient reduction over
    ``batch_axis`` is the caller's job, as with any data-parallel step.

    ``fn.stats`` holds the last call's counts (:func:`pipeline_local`).
    """
    group = _axis_group(mesh, axis_name)
    _batch_group(mesh, batch_axis)
    n_micro = n_microbatches or C.axis_size_of(group)
    if remat_stages:
        stage_fn = _remat(stage_fn)

    def fn(stage_params, x):
        xm = _microbatches(x, n_micro)
        ym = _homogeneous(stage_fn, stage_params, xm, group, virtual_stages,
                          True, _new_stats(fn.stats))
        return ym.reshape((x.shape[0],) + tuple(ym.shape[2:]))

    fn.stats = {}
    return fn


def stack_stage_params(params_list) -> PyTree:
    """Stack per-stage parameter pytrees (identical structure) along a new
    leading axis — the JAX layout of a pipeline's parameters, stage
    ``s`` at index ``s``."""
    return pytree.tree_map(lambda *ls: torch.stack(ls), *params_list)


def stack_interleaved_stage_params(params_list, n_stages: int,
                                   virtual_stages: int) -> PyTree:
    """Stack ``n_stages * virtual_stages`` per-global-stage pytrees (in
    execution order) into the interleaved layout: position ``s*v + j``
    holds global stage ``j*n + s``, so physical stage ``s``'s slice
    ``[s*v:(s+1)*v]`` holds exactly its chunks."""
    n, v = n_stages, virtual_stages
    if len(params_list) != n * v:
        raise ValueError(
            f"need n_stages*virtual_stages={n * v} stage params, "
            f"got {len(params_list)}")
    order = [j * n + s for s in range(n) for j in range(v)]
    return stack_stage_params([params_list[g] for g in order])


# ---------------------------------------------------------------------------
# Heterogeneous stages
# ---------------------------------------------------------------------------

def _hetero_shapes(stage_fns, stage_params, xm: torch.Tensor):
    """The conveyor's and the bank's ``(shape, dtype)`` from a walk of the
    stages on meta tensors (the same on every rank, no transfer), with
    the JAX package's checks."""
    n = len(stage_fns)
    if len(stage_params) != n:
        raise ValueError(f"need {n} stage params, got {len(stage_params)}")
    if n < 2:
        raise ValueError("hetero pipeline needs >= 2 stages")
    with torch.no_grad():
        act = stage_fns[0](_to_meta(stage_params[0]), _to_meta(xm[0]))
        h = act
        for i in range(1, n - 1):
            h = stage_fns[i](_to_meta(stage_params[i]), h)
            if (h.shape, h.dtype) != (act.shape, act.dtype):
                raise ValueError(
                    f"stage {i} breaks the conveyor: emits {h.dtype}"
                    f"{tuple(h.shape)}, ring carries {act.dtype}"
                    f"{tuple(act.shape)} — middle stages must preserve the "
                    "activation shape")
        out = stage_fns[n - 1](_to_meta(stage_params[n - 1]), h)
    return (tuple(act.shape), act.dtype), (tuple(out.shape), out.dtype)


def _hetero(stage_fns, stage_params, x, group, outside, stats):
    n = C.axis_size_of(group)
    s = C.axis_index(group)
    if len(stage_fns) != n:
        raise ValueError(f"need {n} stage_fns, got {len(stage_fns)}")
    act, out = _hetero_shapes(stage_fns, stage_params, x)
    n_micro = x.shape[0]
    # stage s runs microbatch t - s on its own function; the last stage
    # banks and sends nothing on
    ops = [_Op(t - s, s, s == 0, s == n - 1, s < n - 1)
           if 0 <= t - s < n_micro else None for t in range(n_micro + n - 1)]
    leaves, makers, offset = [], [], 0
    for p in stage_params:
        flat, spec = pytree.tree_flatten(p)
        makers.append(_chunk_params(spec, sliced=False, offset=offset,
                                    count=len(flat)))
        leaves += flat
        offset += len(flat)

    def grads_of(grads, needs):
        out = []
        for k, (t, need) in enumerate(zip(leaves, needs)):
            if not need:
                out.append(None)
                continue
            g = grads.get((s, k))
            g = torch.zeros_like(t) if g is None else g
            # each stage's gradient lives on its rank: the replicated
            # parameters get it on every rank (zeros elsewhere, so exact)
            out.append(C._all_reduce(g, group) if outside and n > 1 else g)
        return out

    conv = _Conveyor(group=group, ops=ops, perm=[(i, i + 1)
                                                 for i in range(n - 1)],
                     fns=list(stage_fns),
                     chunk_params=lambda c, fl, g: makers[c](c, fl, g),
                     act=act, bank=((n_micro,) + out[0], out[1]),
                     outside=outside, stats=stats)
    return _run_conveyor(conv, grads_of, x, leaves)


def pipeline_hetero_local(stage_fns, stage_params, x: torch.Tensor,
                          group=None, *,
                          stats: Optional[dict] = None) -> torch.Tensor:
    """GPipe schedule with a DIFFERENT function per stage, on this rank's
    stage of ``group`` (the JAX function runs INSIDE ``shard_map``).

    Lifts the homogeneous engine's two contract restrictions:

      - ``stage_fns[s]`` is stage ``s``'s own callable; rank ``s`` runs
        only it.
      - The conveyor's dtype/shape (stage-to-stage activations) is
        decoupled from both the FEED (stage 0's input — e.g. int token
        ids) and the BANK (last stage's output — e.g. ``[mb, T, vocab]``
        logits): an embedding stage consumes the raw microbatch and an
        LM-head stage banks logits, so the WHOLE model pipelines.

    Remaining contract: middle stages map the activation shape to itself
    (one homogeneous conveyor — checked on meta tensors on every rank
    before any transfer), and stage ``s``'s params are ``stage_params[s]``
    of a tuple of per-stage pytrees REPLICATED to every rank
    (heterogeneous trees cannot stack; for big homogeneous trunks prefer
    :func:`pipeline_local`, which gives each rank its own stage's).

    Args:
      stage_fns: ``n_stages`` callables, ``fns[s](params[s], a) -> b``.
      stage_params: tuple/list of ``n_stages`` parameter pytrees.
      x: ``[n_micro, mb, ...]`` microbatched feed.
      group, stats: as :func:`pipeline_local`.

    Returns:
      ``[n_micro, ...bank_shape]`` outputs, replicated from the last
      stage. Differentiable with the inside meaning: the backward sums
      the ranks' cotangents of the output, and rank ``s`` gets only stage
      ``s``'s parameter gradients (zeros for the others).
    """
    return _hetero(stage_fns, stage_params, x, C.as_group(group), False,
                   _new_stats(stats))


def make_pipeline_hetero(stage_fns, mesh, *, axis_name: str = "stage",
                         n_microbatches: Optional[int] = None,
                         remat_stages: bool = False,
                         batch_axis: Optional[str] = None):
    """Build the pipelined apply over PER-STAGE functions and params.

    Returns ``fn(stage_params, x) -> y`` where ``stage_params`` is a
    tuple of ``n_stages`` pytrees (one per stage, any structures), the
    same on every rank, and ``x`` is the batch. Unlike
    :func:`make_pipeline`, stage 0 may change the activation shape/dtype
    (embedding) and the last stage may emit a different shape
    (head/logits) — the whole model pipelines. The last stage must emit
    ``[microbatch, ...]`` outputs, checked with the conveyor before any
    transfer.

    Params are replicated (not stage-sharded): the price of
    heterogeneous trees; after a backward every rank holds every stage's
    gradient, as the global view's ``jax.grad`` gives it.
    ``remat_stages`` checkpoints each stage fn. ``batch_axis`` composes
    data parallelism exactly as in :func:`make_pipeline`.
    """
    group = _axis_group(mesh, axis_name)
    _batch_group(mesh, batch_axis)
    n_micro = n_microbatches or C.axis_size_of(group)
    fns = [_remat(f) if remat_stages else f for f in stage_fns]

    def fn(stage_params, x):
        xm = _microbatches(x, n_micro)
        mb = xm.shape[1]
        _, (bank, _) = _hetero_shapes(fns, stage_params, xm)
        if len(bank) < 1 or bank[0] != mb:
            raise ValueError(
                f"last stage must emit [microbatch={mb}, ...] outputs for "
                f"batch reassembly; got {bank} — reduce losses "
                "per-example ([mb]), not to a scalar")
        ym = _hetero(fns, stage_params, xm, group, True,
                     _new_stats(fn.stats))
        return ym.reshape((x.shape[0],) + tuple(ym.shape[2:]))

    fn.stats = {}
    return fn


# ---------------------------------------------------------------------------
# 1F1B schedule
# ---------------------------------------------------------------------------

def _tree_add(a: PyTree, b: PyTree) -> PyTree:
    return pytree.tree_map(lambda u, w: u + w, a, b)


def pipeline_1f1b_local(stage_fn: Callable, loss_grad_fn: Callable,
                        stage_params: PyTree, x: torch.Tensor,
                        targets: torch.Tensor, group=None, *,
                        head_params: PyTree = None,
                        collect_input_grads: bool = False,
                        stats: Optional[dict] = None):
    """One-forward-one-backward pipeline schedule on this rank's stage of
    ``group`` (the JAX function runs INSIDE ``shard_map``).

    Where :func:`pipeline_local` and a backward replay the whole forward
    schedule before the backward (so every microbatch's boundary
    activation is live at once — GPipe's memory profile), 1F1B
    interleaves: after warmup each stage alternates one microbatch's
    forward with an earlier microbatch's backward, so at most
    ``n_stages`` microbatch inputs are ever saved per stage (a ring), for
    any number of microbatches. The backward recomputes the stage forward
    from the saved INPUT (per-microbatch rematerialisation).

    Schedule (stage ``s`` of ``n``, microbatch ``i``): forward at tick
    ``s + 2i``, backward at tick ``2(n-1) - s + 2i + 1`` — disjoint
    parities, so each tick a stage executes exactly ONE op — forward,
    backward, or (during fill/drain) nothing. Every tick makes two
    transfers on every rank, whatever it ran: the activations hop ``s →
    s+1`` and the cotangents ``s → s-1``, each arriving exactly at its
    consumption tick. Nothing here is differentiated by autograd: the
    engine IS the forward and the backward.

    Args:
      stage_fn: ``stage_fn(params, x_mb) -> y_mb``, output shape == input
        shape (homogeneous stages, as in :func:`pipeline_local`).
      loss_grad_fn: without ``head_params``: ``loss_grad_fn(y_mb,
        target_mb) -> (loss, dy_mb)`` — per-microbatch loss and its
        gradient wrt the final stage output. With ``head_params`` (a
        trainable loss head after the pipelined region):
        ``loss_grad_fn(head_params, y_mb, target_mb) -> (loss, (dhead,
        dy_mb))``. Runs ONLY on the LAST stage, only on a microbatch's
        real output (never on a zero buffer).
      stage_params: this stage's parameter pytree.
      x: ``[n_micro, mb, ...]`` microbatched input (stage 0 consumes it).
      targets: ``[n_micro, ...]`` per-microbatch targets (the last stage
        consumes them).
      group: the stage group, as :func:`pipeline_local`.
      head_params: optional trainable parameters of the loss head.
      collect_input_grads: also return the loss gradient wrt ``x``
        (``[n_micro, mb, ...]``, on every rank).
      stats: a dict that receives ``ticks``, ``stage_calls`` (forward
        executions), ``recomputes`` (backward executions) and
        ``saved_inputs`` (the most microbatch inputs held at once: at
        most ``n``, the ring).

    Returns:
      ``(loss, grads[, head_grads][, x_grads])``: mean per-microbatch
      loss (on every rank), this stage's parameter gradients (mean over
      microbatches), and — when requested — the head-parameter and input
      gradients (on every rank).
    """
    group = C.as_group(group)
    n = C.axis_size_of(group)
    s = C.axis_index(group)
    stats = _new_stats(stats)
    n_micro = x.shape[0]
    mb_shape = tuple(x.shape[1:])
    fwd_perm = [(i, i + 1) for i in range(n - 1)]
    bwd_perm = [(i + 1, i) for i in range(n - 1)]
    zeros_mb = x.new_zeros(mb_shape)
    p_leaves, p_spec = pytree.tree_flatten(_detached(stage_params, False))
    params = pytree.tree_unflatten(p_leaves, p_spec)
    trainable = [k for k, t in enumerate(p_leaves)
                 if isinstance(t, torch.Tensor) and t.is_floating_point()]
    grads = [torch.zeros_like(p_leaves[k]) for k in trainable]
    hgrads = (None if head_params is None
              else pytree.tree_map(torch.zeros_like, head_params))
    dx_buf = x.new_zeros(x.shape) if collect_input_grads else None
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    saved = [None] * n  # the input ring
    live = most_live = calls = recomputes = 0
    fwd_msg = cot_msg = zeros_mb
    y_last = None
    total = 2 * (n + n_micro - 1)
    for t in range(total):
        tf = t - s
        i_f = tf // 2
        f_valid = tf % 2 == 0 and 0 <= i_f < n_micro
        i_b = (t - (2 * (n - 1) - s + 1)) // 2
        b_valid = tf % 2 == 1 and 0 <= i_b < n_micro
        out = dx = None
        if f_valid:
            inp = x[i_f] if s == 0 else fwd_msg
            with torch.no_grad():
                out = stage_fn(params, inp)
            saved[i_f % n] = inp
            live += 1
            most_live = max(most_live, live)
            calls += 1
            if s == n - 1:
                y_last = out
        elif b_valid:
            x_saved = saved[i_b % n]
            saved[i_b % n] = None
            live -= 1
            if s == n - 1:
                # the loss head, on this microbatch's own output
                tgt = targets[i_b]
                if head_params is None:
                    loss, dy = loss_grad_fn(y_last, tgt)
                else:
                    loss, (dhead, dy) = loss_grad_fn(head_params, y_last,
                                                     tgt)
                    hgrads = _tree_add(hgrads, dhead)
                loss_sum = loss_sum + torch.as_tensor(loss).float()
            else:
                dy = cot_msg
            ps_leaves = list(p_leaves)
            for k in trainable:
                ps_leaves[k] = p_leaves[k].detach().requires_grad_()
            wrt = [ps_leaves[k] for k in trainable]
            want_dx = s > 0 or collect_input_grads
            xs = x_saved.detach().requires_grad_(want_dx)
            with torch.enable_grad():
                y = stage_fn(pytree.tree_unflatten(ps_leaves, p_spec), xs)
                got = torch.autograd.grad(y, wrt + ([xs] if want_dx
                                                    else []),
                                          dy.to(y.dtype), allow_unused=True)
            recomputes += 1
            for k, g in enumerate(got[:len(wrt)]):
                if g is not None:
                    grads[k] = grads[k] + g
            if want_dx:
                dx = got[-1]
                if dx_buf is not None and s == 0:
                    dx_buf[i_b] = dx
        fwd_msg = C._permute(out if f_valid else zeros_mb, group, fwd_perm)
        cot_msg = C._permute(dx if b_valid and dx is not None else zeros_mb,
                             group, bwd_perm)
    stats.update(ticks=total, stage_calls=calls, recomputes=recomputes,
                 saved_inputs=most_live)
    flat = [torch.zeros_like(t) if isinstance(t, torch.Tensor) else t
            for t in p_leaves]
    for k, g in zip(trainable, grads):
        flat[k] = g / n_micro
    result = (_bcast(loss_sum, group, n - 1, n) / n_micro,
              pytree.tree_unflatten(flat, p_spec))
    if head_params is not None:
        # only the last stage accumulated head grads
        result += (pytree.tree_map(
            lambda g: _bcast(g, group, n - 1, n) / n_micro, hgrads),)
    if collect_input_grads:
        # only stage 0 wrote its slots: d(returned loss)/dx
        result += (_bcast(dx_buf, group, 0, n) / n_micro,)
    return result


def make_pipeline_1f1b(stage_fn: Callable, loss_grad_fn: Callable, mesh, *,
                       axis_name: str = "stage",
                       n_microbatches: Optional[int] = None,
                       batch_axis: Optional[str] = None):
    """Build the 1F1B train-step core: ``fn(stage_params, x, targets[,
    head_params], *, collect_input_grads=False) -> (loss, grads[,
    head_grads][, x_grads])``.

    ``stage_params`` is this rank's stage; ``x`` the batch ``[batch,
    ...]`` and ``targets`` the per-example targets ``[batch, ...]``, both
    split into ``n_microbatches``. Unlike :func:`make_pipeline` (a
    differentiable *apply*), this IS the fwd+bwd engine — feed the
    returned grads (this rank's stage's) to any optimizer; raise
    ``n_microbatches`` freely, saved activations stay ``O(n_stages)``.
    Passing ``head_params`` switches ``loss_grad_fn`` to the
    trainable-head contract (see :func:`pipeline_1f1b_local`) and appends
    the head gradients; ``collect_input_grads=True`` appends the gradient
    wrt ``x`` (``[batch, ...]``) for an embed before the pipeline.

    ``batch_axis`` composes data parallelism (2-D ``(batch_axis,
    axis_name)`` mesh): ``x`` and ``targets`` are this rank's share, each
    data slice runs its own 1F1B schedule, and the returned loss, stage
    grads and head grads are ALREADY averaged over ``batch_axis``
    (x_grads stay per-shard, scaled by ``1/n_data``: the gradient of the
    RETURNED loss wrt this shard). ``fn.stats`` holds the last call's
    counts.
    """
    group = _axis_group(mesh, axis_name)
    data = _batch_group(mesh, batch_axis)
    n_micro = n_microbatches or C.axis_size_of(group)

    def fn(stage_params, x, targets, head_params=None, *,
           collect_input_grads=False):
        xm = _microbatches(x, n_micro)
        tm = targets.reshape((n_micro, xm.shape[1]) + tuple(targets.shape[1:]))
        res = list(pipeline_1f1b_local(
            stage_fn, loss_grad_fn, stage_params, xm, tm, group,
            head_params=head_params, collect_input_grads=collect_input_grads,
            stats=fn.stats))
        if data is not None:
            # the data-parallel mean, where the train step takes it
            mean = lambda t: C._all_reduce(t, data, "mean")  # noqa: E731
            res[0] = mean(res[0])
            res[1] = pytree.tree_map(mean, res[1])
            if head_params is not None:
                res[2] = pytree.tree_map(mean, res[2])
        if collect_input_grads:
            xg = res[-1]
            if data is not None:
                xg = xg / C.axis_size_of(data)
            res[-1] = xg.reshape(x.shape)
        return tuple(res)

    fn.stats = {}
    return fn


__all__ = ["make_pipeline", "make_pipeline_1f1b", "make_pipeline_hetero",
           "pipe_plan_axis", "pipeline_1f1b_local", "pipeline_hetero_local",
           "pipeline_local", "pipeline_total_ticks",
           "stack_interleaved_stage_params", "stack_stage_params",
           "unscale_replicated_grads"]
