"""The multi-node optimizer wrappers (counterpart of
``chainermn_tpu/optimizers.py``: ``MultiNodeOptimizer``,
``create_multi_node_optimizer``, ``LocalSGDOptimizer``,
``create_local_sgd``), and ``LARS``/``LAMB``, the counterparts of
``optax.lars`` and ``optax.lamb`` the ImageNet twin takes.

:class:`MultiNodeOptimizer` holds a ``torch.optim.Optimizer`` and a
communicator. ``step()`` averages every parameter's ``.grad`` over the
ranks, then steps the inner optimizer. How it averages:

- by default, the communicator's own strategy
  (``comm.allreduce_grad``): one packed all-reduce, the two-level
  pipeline under ``'two_dimensional'``; on the int8 wire
  (``allreduce_grad_dtype='int8'``) the two-phase quantized all-reduce
  per gradient, per bucket under ``'two_dimensional'`` (the scales
  follow that layout, so the int8 wire never rides the packed buffer);
- ``reduction_schedule='flat'``, ``'two_level'``, a composition
  signature (``'rs(intra)>rs(inter)>ag(inter)>ag(intra)'``, sliced
  ``'rs(data)[s0..3]>ag(data)'``) or a ``Composition`` over the
  communicator's ``axis_names``, validated at construction: the
  bucketed schedules of :func:`~chainermn_tpu_torch.parallel.
  reduction_schedule.reduce_tree` over the communicator's axes. A
  composition with a sharded update is refused (spell it ``'zero'``);
- ``reduction_schedule='zero'``: ``zero_composition(axes)``, split at
  its sharded update: reduce-scatter over the last (intra) axis and
  all-reduce over the others (the prefix), the inner optimizer on this
  rank's 1/n chunk of every parameter, all-gather (the suffix), through
  :class:`~chainermn_tpu_torch.parallel.zero.ZeroShardOptimizer` (the
  inner optimizer is rebuilt over the chunks with its defaults; it must
  be element-wise);
- ``error_feedback=True`` (the int8 wire only): EF-SGD. The flat form
  adds a per-rank fp32 residual shaped as the parameters into each
  ~64 MB bucket's message and keeps what its stage-1 quantization
  dropped; under a communicator with ``two_level_axes``
  (``'two_dimensional'``) the residual is one shard-shaped buffer a
  bucket (1/n_intra of the flat one), fed back where the inter stage
  rounds.

``double_buffering=True`` keeps the JAX package's staleness-1 semantics:
each step applies the gradients reduced at the previous step (zeros at
the first step) and banks this step's. :meth:`MultiNodeOptimizer.
state_dict` carries the inner optimizer's state, that bank and the error-
feedback residual — per-rank state, which the npz checkpointer's
per-rank files keep for each rank.

:class:`LocalSGDOptimizer` replaces the per-step reduction by one
parameter average every ``sync_every`` steps, folded through an outer
heavy-ball step from the last sync's anchor (DiLoCo).

Left for later: ``reduction_schedule='auto'`` (ROADMAP queue 8),
raising.

:func:`inner_transform` unwraps a wrapper into the factory of its inner
optimizer, which a :class:`~chainermn_tpu_torch.parallel.plan.
ParallelPlan` builds over its own update groups.
"""

from __future__ import annotations

import inspect

import torch

from chainermn_tpu_torch.communicators.base import (
    CommunicatorBase,
    _wire_dtype,
)
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel.composition import Composition
from chainermn_tpu_torch.parallel.reduction_schedule import (
    DEFAULT_BUCKET_BYTES,
    bucket_partition,
    check_schedule,
    int8_rendering,
    reduce_tree,
)


class MultiNodeOptimizer:
    """A ``torch.optim.Optimizer`` whose ``step()`` first reduces the
    gradients over the communicator. Unknown attributes (``param_groups``,
    ``state``, ``zero_grad``, ...) are the inner optimizer's."""

    #: protocol marker for make_train_step: this wrapper reduces the
    #: gradients itself, so the step must not reduce them again
    handles_cross_rank_sync = True

    def __init__(self, actual_optimizer: torch.optim.Optimizer,
                 communicator: CommunicatorBase, *,
                 double_buffering: bool = False, compress_dtype=None,
                 error_feedback: bool = False,
                 reduction_schedule=None) -> None:
        schedule = check_schedule(reduction_schedule, communicator)
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.double_buffering = double_buffering
        # None falls back to the communicator's wire, as in the JAX
        # wrapper
        self.compress_dtype = (communicator.allreduce_grad_dtype
                               if compress_dtype is None
                               else _wire_dtype(compress_dtype))
        int8 = self.compress_dtype == torch.int8
        if isinstance(schedule, Composition) and schedule.has_update:
            raise ValueError(
                f"reduction_schedule composition {schedule.signature()!r} "
                "carries a sharded_update stage — spell the structural "
                "form as reduction_schedule='zero'")
        self.error_feedback = error_feedback
        if error_feedback and not int8:
            raise ValueError(
                "error_feedback requires the int8 quantized wire "
                "(allreduce_grad_dtype='int8'): other dtypes lose nothing "
                "systematic to feed back")
        if error_feedback and reduction_schedule not in (None, "flat"):
            raise ValueError(
                "error_feedback owns its reduction (the flat or the "
                "communicator's topology-aware quantized wire): "
                f"reduction_schedule={reduction_schedule!r} cannot compose")
        if int8 and isinstance(schedule, Composition):
            # refuses what the two-phase wire cannot render
            int8_rendering(schedule, communicator.axis_groups)
        if schedule == "zero":
            if double_buffering:
                raise ValueError(
                    "reduction_schedule='zero' cannot compose with "
                    "double_buffering: the sharded update replaces the "
                    "grads the staleness bank would carry")
            if int8:
                raise ValueError(
                    "reduction_schedule='zero' cannot ride the int8 wire "
                    "(its reduce-scatter sums raw chunks; the two-phase "
                    "quantized scheme has no scatter form): use bf16 "
                    "compression or the flat/two_level schedules")
        #: the schedule as given
        self.reduction_schedule = reduction_schedule
        #: what the step runs through ``reduce_tree``: the schedule
        #: compiled into a validated Composition (None for the
        #: communicator's own reduction and for ``'zero'``)
        self._comp = schedule if isinstance(schedule, Composition) else None
        #: the buckets of the schedules and of error feedback
        self.bucket_bytes = getattr(communicator, "bucket_bytes",
                                    DEFAULT_BUCKET_BYTES)
        #: the gradients reduced at the previous step (double buffering)
        self._bank = None
        self._residual = self._init_residual() if error_feedback else None
        if schedule == "zero":
            self.actual_optimizer = self._zero_wrapper(actual_optimizer)

    def _params(self) -> list:
        return [p for g in self.actual_optimizer.param_groups
                for p in g["params"]]

    # -- the 'zero' schedule -------------------------------------------

    def _zero_wrapper(self, inner: torch.optim.Optimizer):
        """The :class:`~chainermn_tpu_torch.parallel.zero.
        ZeroShardOptimizer` of the ``'zero'`` schedule, the groups of
        ``zero_composition(axes)`` (``rs(fast) > ar(rest) > su >
        ag(fast)``): chunks over the last axis, the others' all-reduce
        after its scatter, the inner optimizer rebuilt over the chunks
        with its defaults."""
        from chainermn_tpu_torch.parallel.zero import ZeroShardOptimizer

        if len(inner.param_groups) != 1:
            raise ValueError(
                "reduction_schedule='zero' rebuilds the inner optimizer "
                "over its chunks with its defaults: give it one param group")
        ag = self.communicator.axis_groups
        fast, rest = ag.names[-1], ag.names[:-1]
        extra = C._merged(ag.merged(rest)) if rest else None
        params = list(inner.param_groups[0]["params"])
        return ZeroShardOptimizer(inner_transform(inner), params,
                                  ag.groups[fast], extra_group=extra,
                                  compress_dtype=self.compress_dtype)

    # -- error feedback ------------------------------------------------

    def _ef_buckets(self, params: list) -> list:
        """The ~64 MB fp32 buckets of the non-empty parameters
        (:func:`~chainermn_tpu_torch.parallel.reduction_schedule.
        bucket_partition`): one layout for the residual and the wire."""
        return bucket_partition(list(range(len(params))),
                                [p.numel() for p in params], 4,
                                self.bucket_bytes)

    def _init_residual(self) -> list:
        """Zeros in fp32: shaped as the parameters (the flat form), or one
        ``[two_level_shard_len(bucket elements, n_intra)]`` buffer a bucket
        (the shard-level form)."""
        params = self._params()
        axes2 = self.communicator.two_level_axes
        if axes2 is None:
            return [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params]
        n_intra = C.axes_size(axes2[0])
        return [torch.zeros(C.two_level_shard_len(
                    sum(params[i].numel() for i in b), n_intra),
                    dtype=torch.float32, device=params[b[0]].device)
                for b in self._ef_buckets(params)]

    def _reduce_with_feedback(self, params: list) -> None:
        """EF-SGD over the int8 wire, in place: each bucket's message is
        the gradients plus the residual (flat form) or the intra-summed
        shard plus the residual (shard-level form); the new residual is
        what the message's stage-1 quantization dropped. (Gradients are
        floating; an empty one, in no bucket, is its own mean.)"""
        comm = self.communicator
        grads = comm._grads(params)
        axes = C._axes(comm.grad_axes)
        buckets = self._ef_buckets(params)
        axes2 = comm.two_level_axes
        if axes2 is not None and len(self._residual) != len(buckets):
            raise ValueError(
                f"shard-level EF residual has {len(self._residual)} buckets "
                f"but these gradients need {len(buckets)}: the state was "
                "built for other parameters")
        for k, bidx in enumerate(buckets):
            if axes2 is not None:
                m = torch.cat([grads[i].float().reshape(-1) for i in bidx])
                mean, self._residual[k] = (
                    C.int8_two_level_allreduce_mean_with_feedback(
                        m, self._residual[k], axes2[0], axes2[1]))
                err = None
            else:
                m = torch.cat([(grads[i].float() + self._residual[i])
                               .reshape(-1) for i in bidx])
                mean, local_rt = C.int8_allreduce_mean_with_feedback(m, axes)
                err = m - local_rt
            off = 0
            for i in bidx:
                c = grads[i].numel()
                grads[i].copy_(mean[off:off + c].view_as(grads[i]))
                if err is not None:
                    self._residual[i] = err[off:off + c].view_as(
                        self._residual[i]).clone()
                off += c

    # -- the step ------------------------------------------------------

    def _reduce(self, params: list) -> None:
        comm = self.communicator
        if self.error_feedback:
            self._reduce_with_feedback(params)
        elif self._comp is not None:
            grads = comm._grads(params)
            for g, m in zip(grads, reduce_tree(
                    grads, schedule=self._comp,
                    axes=comm, compress_dtype=self.compress_dtype,
                    bucket_bytes=self.bucket_bytes)):
                g.copy_(m)
        else:
            comm.allreduce_grad(params, dtype=self.compress_dtype)

    @torch.no_grad()
    def step(self) -> None:
        if self.reduction_schedule == "zero":
            self.actual_optimizer.step()  # scatter, 1/n update, gather
            return
        params = self._params()
        self._reduce(params)
        if self.double_buffering:
            # staleness 1: apply last step's reduced gradients (zeros at
            # the first step), bank this step's
            if self._bank is None:
                self._bank = [torch.zeros_like(p) for p in params]
            for i, p in enumerate(params):
                p.grad, self._bank[i] = self._bank[i], p.grad
        self.actual_optimizer.step()

    def state_dict(self) -> dict:
        """``{"actual_optimizer": inner.state_dict(), "bank": ...,
        "residual": ...}``. The bank is the list of gradients reduced at
        the last step with double buffering (zeros before the first step:
        what that step applies), None without it; the residual is this
        rank's error-feedback residual (a list of fp32 tensors), None
        without error feedback."""
        bank = None
        if self.double_buffering:
            bank = (self._bank if self._bank is not None
                    else [torch.zeros_like(p) for p in self._params()])
        return {"actual_optimizer": self.actual_optimizer.state_dict(),
                "bank": bank, "residual": self._residual}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore :meth:`state_dict`'s output: the inner optimizer's
        state, the bank and the residual copied onto the parameters'
        devices."""
        bank = state_dict["bank"]
        if (bank is None) != (not self.double_buffering):
            raise ValueError(
                f"the state's bank is {'absent' if bank is None else 'present'}"
                f" but this optimizer has double_buffering="
                f"{self.double_buffering}")
        params = self._params()
        if bank is not None:
            if len(bank) != len(params):
                raise ValueError(f"the state banks {len(bank)} gradients for "
                                 f"{len(params)} parameters")
            for b, p in zip(bank, params):
                if b.shape != p.shape:
                    raise ValueError(f"a banked gradient of shape "
                                     f"{tuple(b.shape)} for a parameter of "
                                     f"shape {tuple(p.shape)}")
            self._bank = [b.to(device=p.device, dtype=p.dtype, copy=True)
                          for b, p in zip(bank, params)]
        residual = state_dict.get("residual")
        if (residual is None) != (not self.error_feedback):
            raise ValueError(
                f"the state's residual is "
                f"{'absent' if residual is None else 'present'} but this "
                f"optimizer has error_feedback={self.error_feedback}")
        if residual is not None:
            want = [r.shape for r in self._residual]
            if [tuple(r.shape) for r in residual] != [tuple(w) for w in want]:
                raise ValueError(
                    f"the state's residual has shapes "
                    f"{[tuple(r.shape) for r in residual]}, this optimizer's "
                    f"{[tuple(w) for w in want]}")
            self._residual = [r.to(device=o.device, dtype=torch.float32,
                                   copy=True)
                              for r, o in zip(residual, self._residual)]
        self.actual_optimizer.load_state_dict(state_dict["actual_optimizer"])

    def __getattr__(self, item):
        # Guard against re-entry while __dict__ is still empty (copy,
        # unpickling).
        if item.startswith("__") or "actual_optimizer" not in self.__dict__:
            raise AttributeError(item)
        return getattr(self.actual_optimizer, item)


class LocalSGDOptimizer:
    """Local SGD / DiLoCo-style periodic parameter averaging.

    Each rank steps ``inner`` on its LOCAL gradients; every
    ``sync_every``-th step the ranks average their parameters (one
    all-reduce a dtype over the communicator's ``grad_axes``) and fold
    the average through an outer heavy-ball step from the last sync's
    ``anchor``: ``v = outer_momentum * v + (anchor - mean)``, ``anchor =
    params = anchor - outer_lr * v`` (``outer_momentum=0, outer_lr=1`` is
    plain averaging). The step count is the same on every rank, so every
    rank syncs at the same steps. The anchor is the parameters before
    the first step (after ``create_train_state``'s broadcast).

    ``state_dict`` carries the inner optimizer's state, the step, the
    anchor and the outer velocity. Unknown attributes are ``inner``'s."""

    #: the sync is the periodic parameter mean: gradients reach ``inner``
    #: un-reduced
    handles_cross_rank_sync = True

    def __init__(self, inner: torch.optim.Optimizer,
                 communicator: CommunicatorBase, *, sync_every: int,
                 outer_lr: float = 1.0, outer_momentum: float = 0.0) -> None:
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self.inner = inner
        self.comm = communicator
        self.sync_every = int(sync_every)
        self.outer_lr = outer_lr
        self.outer_momentum = outer_momentum
        self._step = 0
        params = self._params()
        self._anchor = [p.detach().clone() for p in params]
        self._velocity = [torch.zeros_like(p) for p in params]

    @property
    def actual_optimizer(self) -> torch.optim.Optimizer:
        """The inner optimizer (the name the checkpointer reads)."""
        return self.inner

    def _params(self) -> list:
        return [p for g in self.inner.param_groups for p in g["params"]]

    def _mean(self, params: list) -> list:
        """The parameters' mean over the ranks, one packed all-reduce a
        dtype (the JAX ``pmean`` of every leaf)."""
        axes = C._axes(self.comm.grad_axes)
        n = C.axes_size(axes)
        out = [None] * len(params)
        kinds: dict = {}
        for i, p in enumerate(params):
            kinds.setdefault(p.dtype, []).append(i)
        for idx in kinds.values():
            flat = torch.cat([params[i].detach().reshape(-1) for i in idx])
            flat = C._psum(flat, axes) / n
            off = 0
            for i in idx:
                c = params[i].numel()
                out[i] = flat[off:off + c].view_as(params[i])
                off += c
        return out

    @torch.no_grad()
    def step(self) -> None:
        params = self._params()
        if self._step == 0:
            for a, p in zip(self._anchor, params):
                a.copy_(p)
        self.inner.step()
        self._step += 1
        if self._step % self.sync_every:
            return
        for p, a, v, m in zip(params, self._anchor, self._velocity,
                              self._mean(params)):
            v.mul_(self.outer_momentum).add_(a - m)
            a.sub_(self.outer_lr * v)
            p.copy_(a)

    def state_dict(self) -> dict:
        return {"actual_optimizer": self.inner.state_dict(),
                "step": self._step, "anchor": self._anchor,
                "velocity": self._velocity}

    def load_state_dict(self, state_dict: dict) -> None:
        params = self._params()
        for key in ("anchor", "velocity"):
            got = state_dict[key]
            if [tuple(t.shape) for t in got] != [tuple(p.shape)
                                                 for p in params]:
                raise ValueError(f"the state's {key} does not match the "
                                 "parameters' shapes")
        self._anchor = [t.to(device=p.device, dtype=p.dtype, copy=True)
                        for t, p in zip(state_dict["anchor"], params)]
        self._velocity = [t.to(device=p.device, dtype=p.dtype, copy=True)
                          for t, p in zip(state_dict["velocity"], params)]
        self._step = int(state_dict["step"])
        self.inner.load_state_dict(state_dict["actual_optimizer"])

    def __getattr__(self, item):
        if item.startswith("__") or "inner" not in self.__dict__:
            raise AttributeError(item)
        return getattr(self.inner, item)


def create_local_sgd(inner: torch.optim.Optimizer,
                     communicator: CommunicatorBase, *, sync_every: int,
                     outer_lr: float = 1.0,
                     outer_momentum: float = 0.0) -> LocalSGDOptimizer:
    """Factory for :class:`LocalSGDOptimizer`."""
    return LocalSGDOptimizer(inner, communicator, sync_every=sync_every,
                             outer_lr=outer_lr,
                             outer_momentum=outer_momentum)


def _trust_ratio(p: torch.Tensor, u: torch.Tensor, coefficient: float,
                 eps: float) -> torch.Tensor:
    """``coefficient * |p| / (|u| + eps)``, or 1 where either norm is 0
    (``optax.scale_by_trust_ratio``)."""
    pn = torch.linalg.vector_norm(p)
    un = torch.linalg.vector_norm(u)
    ratio = coefficient * pn / (un + eps)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)


class LARS(torch.optim.Optimizer):
    """Layer-wise adaptive rate scaling, ``optax.lars`` with its defaults:
    per parameter tensor, ``u = g + weight_decay * p``, ``u *=
    trust_coefficient * |p| / (|u| + eps)`` (1 where a norm is 0), ``u *=
    -lr``, then the momentum trace ``t = u + momentum * t`` (Nesterov:
    ``u + momentum * t``) and ``p += t``."""

    def __init__(self, params, lr: float, *, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001, eps: float = 0.0,
                 momentum: float = 0.9, nesterov: bool = False) -> None:
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay,
            trust_coefficient=trust_coefficient, eps=eps,
            momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad + group["weight_decay"] * p
                u = u * _trust_ratio(p, u, group["trust_coefficient"],
                                     group["eps"])
                u = u * -group["lr"]
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                t = state["trace"]
                t.copy_(u + group["momentum"] * t)
                p.add_(u + group["momentum"] * t if group["nesterov"] else t)
        return loss


class LAMB(torch.optim.Optimizer):
    """Layer-wise adaptive moments, ``optax.lamb`` with its defaults:
    Adam's bias-corrected ``m / (sqrt(v + eps_root) + eps)``, plus
    ``weight_decay * p``, scaled by ``|p| / |u|`` (1 where a norm is 0)
    per parameter tensor, then by ``-lr``, added to ``p``."""

    def __init__(self, params, lr: float, *, betas=(0.9, 0.999),
                 eps: float = 1e-6, eps_root: float = 0.0,
                 weight_decay: float = 0.0) -> None:
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * (g * g) + b2 * v)
                count = state["step"]
                m_hat = m / (1 - b1 ** count).to(m.dtype)
                v_hat = v / (1 - b2 ** count).to(v.dtype)
                u = m_hat / (torch.sqrt(v_hat + group["eps_root"])
                             + group["eps"])
                u = u + group["weight_decay"] * p
                u = u * _trust_ratio(p, u, 1.0, 0.0)
                p.add_(u * -group["lr"])
        return loss


def inner_transform(optimizer):
    """The plain optimizer factory a :class:`~chainermn_tpu_torch.parallel.
    plan.ParallelPlan` composes: ``make_inner(params) -> Optimizer``.

    A plan owns the whole reduction (its spec providers say which
    collective each axis owes the step) and builds one inner optimizer
    per update group over the tensors that group updates, so it takes a
    factory, as :func:`~chainermn_tpu_torch.parallel.zero.
    zero_shard_optimizer` does. A :class:`MultiNodeOptimizer` is unwrapped
    into a factory of its inner optimizer's class with its defaults (the
    JAX function returns the inner optax transform); wrappers whose
    semantics live in the wrapper itself (double buffering's staleness
    bank, error feedback, a compressed wire, local SGD's sync cadence)
    are refused loudly rather than silently dropped. A factory (any other
    callable) passes through; a bare ``torch.optim.Optimizer`` instance
    is unwrapped like the wrapper's inner one."""
    if isinstance(optimizer, LocalSGDOptimizer):
        raise ValueError(
            "LocalSGDOptimizer's sync cadence is wrapper state; a "
            "ParallelPlan cannot carry it — pass the plain inner optimizer")
    if isinstance(optimizer, MultiNodeOptimizer):
        if optimizer.double_buffering or optimizer.error_feedback:
            raise ValueError(
                "a ParallelPlan composes its own reduction; "
                "double_buffering/error_feedback live in the wrapper's "
                "wire and cannot ride a plan-compiled step — pass the "
                "plain inner optimizer")
        if optimizer.compress_dtype is not None:
            raise ValueError(
                "a ParallelPlan reduces in full precision; the wrapper's "
                f"compressed wire (allreduce_grad_dtype="
                f"{str(optimizer.compress_dtype).replace('torch.', '')}) "
                "would be silently dropped — pass the plain inner "
                "optimizer, or keep this call site on the communicator path")
        optimizer = optimizer.actual_optimizer
    if isinstance(optimizer, torch.optim.Optimizer):
        cls = type(optimizer)
        # the defaults the constructor takes (AdamW keeps a
        # ``decoupled_weight_decay`` default that its constructor fixes)
        takes = inspect.signature(cls.__init__).parameters
        defaults = {k: v for k, v in optimizer.defaults.items()
                    if k in takes}

        def make_inner(params):
            return cls(params, **defaults)

        make_inner.optimizer_class = cls
        make_inner.defaults = defaults
        return make_inner
    if not callable(optimizer):
        raise TypeError(f"a ParallelPlan takes an optimizer factory "
                        f"make_inner(params) -> torch.optim.Optimizer, got "
                        f"{type(optimizer).__name__}")
    return optimizer


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator: CommunicatorBase, *,
                                double_buffering: bool = False,
                                allreduce_grad_dtype=None,
                                error_feedback: bool = False,
                                reduction_schedule=None
                                ) -> MultiNodeOptimizer:
    """Factory mirroring the reference signature
    (``create_multi_node_optimizer(opt, comm, double_buffering)``);
    ``error_feedback=True`` needs ``allreduce_grad_dtype='int8'`` (here or
    on the communicator), ``reduction_schedule`` is ``'flat'``,
    ``'two_level'``, ``'zero'``, a composition signature or a
    ``Composition``."""
    return MultiNodeOptimizer(
        actual_optimizer, communicator, double_buffering=double_buffering,
        compress_dtype=allreduce_grad_dtype, error_feedback=error_feedback,
        reduction_schedule=reduction_schedule)


__all__ = ["LAMB", "LARS", "LocalSGDOptimizer", "MultiNodeOptimizer",
           "create_local_sgd", "create_multi_node_optimizer",
           "inner_transform"]
