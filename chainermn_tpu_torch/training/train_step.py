"""The data-parallel train step (counterpart of
``chainermn_tpu/training/train_step.py``).

Where the JAX package compiles forward, backward, gradient mean and
optimizer update into one program over the mesh, the port runs them
eagerly in one process per rank: ``loss_fn(model, batch)`` forward,
``backward()``, the gradient mean over the communicator (inside a
:class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer`, or in the
step for a plain optimizer), ``optimizer.step()``, and the rank-mean of
the metrics.

A :class:`TrainState` is what the checkpointer saves and restores
(:mod:`chainermn_tpu_torch.extensions.checkpoint`): the module's and the
optimizer's ``state_dict`` and the step.

``make_train_step(plan=...)`` delegates to the
:class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`'s composed step.

Error feedback's residual is PER-RANK state (the JAX package stacks it
``[n_slots, ...]`` and shards it over the grad axes): here it lives in
the :class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` of each
rank and in its ``state_dict``, so the npz checkpointer's per-rank files
keep every rank's residual and a resume gives each rank its own back
(the DCP backend, whose contract is replicated state, refuses it).
So is a :class:`~chainermn_tpu_torch.optimizers.LocalSGDOptimizer`'s
inner state (each rank steps on its own gradients); its anchor, outer
velocity and step count are alike on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch import nn

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class TrainState(NamedTuple):
    """What the step carries: the module (parameters and buffers, which
    hold what the JAX ``params``/``model_state`` hold), the optimizer
    (its state is the JAX ``opt_state``) and the step count."""

    model: nn.Module
    optimizer: Any
    step: int = 0


def create_train_state(model: nn.Module, optimizer,
                       comm: CommunicatorBase) -> TrainState:
    """Broadcast the model's parameters and buffers from rank 0 (the
    reference's first-update ``bcast_data``) and wrap model and optimizer
    into a :class:`TrainState`. The optimizer must hold exactly the
    model's parameters.

    The buffers are the JAX ``create_train_state(..., model_state=)``:
    BatchNorm's running statistics are broadcast with the parameters, so
    every rank starts from rank 0's."""
    owned = {id(p) for p in model.parameters()}
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if owned != held:
        raise ValueError("the optimizer must be built over exactly the "
                         "model's parameters")
    comm.bcast_data(model)
    return TrainState(model=model, optimizer=optimizer, step=0)


def normalize_loss_fn(loss_fn: Callable) -> Callable:
    """Wrap ``loss_fn(model, batch)`` into ``(loss, metrics)``, accepting
    every documented return shape: ``loss``, ``(loss, metrics)`` or
    ``(loss, (metrics, new_model_state))`` — the module's buffers ARE its
    model state and its train-mode forward updates them in place (as
    BatchNorm does), so the third form's state is dropped."""
    def _loss_with_aux(model, batch):
        out = loss_fn(model, batch)
        if not isinstance(out, tuple):
            return out, {}
        loss, aux = out
        if isinstance(aux, tuple) and len(aux) == 2:
            aux = aux[0]
        return loss, aux

    return _loss_with_aux


def _split(batch, n: int):
    """``n`` microbatches of every tensor leaf of ``batch`` (dim 0)."""
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % n:
            raise ValueError(f"local batch dim {batch.shape[0]} not "
                             f"divisible by accum_steps={n}")
        return list(batch.chunk(n))
    if isinstance(batch, (tuple, list)):
        parts = [_split(x, n) for x in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    if isinstance(batch, dict):
        parts = {k: _split(x, n) for k, x in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    raise TypeError(f"cannot split a batch leaf of type {type(batch)}")


def make_train_step(loss_fn: Callable, optimizer,
                    comm: CommunicatorBase = None, *, accum_steps: int = 1,
                    plan=None, param_specs=None, pipeline=None,
                    axis_name=None, batch_spec=None):
    """Build the data-parallel train step.

    ``loss_fn(model, batch)`` returns the LOCAL-batch mean loss (or one of
    the tuple forms of :func:`normalize_loss_fn`); the step averages over
    the ranks. ``optimizer`` is a
    :class:`~chainermn_tpu_torch.optimizers.MultiNodeOptimizer` (it
    reduces the gradients itself) or any ``torch.optim.Optimizer`` (the
    step then reduces them through ``comm.allreduce_grad``).
    ``accum_steps`` splits the batch into microbatches along dim 0, each
    backward adding ``grad / accum_steps``, and reduces once.

    ``plan``: a :class:`~chainermn_tpu_torch.parallel.plan.ParallelPlan`
    — the step is the plan's composed step
    (:meth:`~chainermn_tpu_torch.parallel.plan.ParallelPlan.
    compile_train_step`: ``loss_fn(params, batch)`` on the collapsed
    param tree, this rank's share of the batch, state from
    ``plan.create_train_state``); ``optimizer`` is a factory
    ``make_inner(params)`` or a wrapper that
    :func:`~chainermn_tpu_torch.optimizers.inner_transform` unwraps;
    ``param_specs`` marks model/pipe-stacked leaves and ``pipeline``
    passes a pipe plan's ``PipelinePlanSpec``. ``accum_steps`` does not
    apply there (nor do the JAX ``axis_name``/``batch_spec``).

    Returns ``step(state, batch) -> (state, metrics)``; ``metrics`` maps
    ``'loss'`` and the loss function's metrics to 0-dim fp32 tensors,
    averaged over the ranks and over the microbatches.
    """
    if plan is not None:
        if accum_steps != 1 or axis_name is not None or batch_spec is not None:
            raise ValueError(
                "plan= owns the batch/axis layout: axis_name, batch_spec "
                "and accum_steps do not apply to a plan-compiled step")
        return plan.compile_train_step(loss_fn, optimizer,
                                       param_specs=param_specs,
                                       pipeline=pipeline)
    if param_specs is not None or pipeline is not None:
        raise ValueError("param_specs/pipeline only apply to the plan= path")
    if axis_name is not None or batch_spec is not None:
        raise ValueError("axis_name/batch_spec have no meaning on the "
                         "communicator path: each rank passes its own "
                         "share of the batch")
    if comm is None:
        raise ValueError("pass a communicator (or plan=)")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    reduce_in_step = not getattr(optimizer, "handles_cross_rank_sync", False)
    loss_with_aux = normalize_loss_fn(loss_fn)

    def step(state: TrainState, batch):
        model = state.model
        optimizer.zero_grad(set_to_none=True)
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        totals: dict = {}
        for mb in micro:
            loss, metrics = loss_with_aux(model, mb)
            (loss / len(micro)).backward()
            for name, val in {"loss": loss, **metrics}.items():
                val = torch.as_tensor(val).detach().float()
                totals[name] = totals.get(name, 0.0) + val / len(micro)
        if reduce_in_step:
            comm.allreduce_grad(model)
        optimizer.step()
        if comm.size > 1:
            # the JAX step's pmean of model_state: buffers must not drift
            # across ranks (sync-BN keeps them equal already)
            _mean_buffers(model, comm)
        names = list(totals)
        means = comm.allreduce_mean(torch.stack([totals[n].reshape(())
                                                 for n in names]))
        return (state._replace(step=state.step + 1),
                dict(zip(names, means.unbind())))

    return step



@torch.no_grad()
def _mean_buffers(model: nn.Module, comm: CommunicatorBase) -> None:
    """Average the module's floating buffers over the ranks, as one
    packed all_reduce."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if not bufs:
        return
    flat = torch.cat([b.reshape(-1).float() for b in bufs])
    flat = comm.allreduce_mean(flat)
    off = 0
    for b in bufs:
        n = b.numel()
        b.copy_(flat[off:off + n].view_as(b))
        off += n


def make_eval_step(metric_fn: Callable, comm: CommunicatorBase):
    """Build the eval step: ``metric_fn(model, batch) -> {name: scalar}``
    of local-batch means, run without gradients in eval mode (BatchNorm
    on its running averages), each metric averaged over the ranks.

    Returns ``eval_step(model, batch) -> {name: 0-dim fp32 tensor}``;
    the model's train/eval mode is restored afterwards."""
    def eval_step(model: nn.Module, batch):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                metrics = metric_fn(model, batch)
        finally:
            model.train(was_training)
        names = list(metrics)
        means = comm.allreduce_mean(torch.stack(
            [torch.as_tensor(metrics[n]).float().reshape(()) for n in names]))
        return dict(zip(names, means.unbind()))

    return eval_step
