"""FSDP-style parameter and optimizer-state sharding (counterpart of
``chainermn_tpu/parallel/fsdp.py``, "ZeRO-3").

Where :mod:`chainermn_tpu_torch.parallel.zero` shards only the optimizer
state, here the parameters AND the optimizer state live sharded over the
data-parallel group: each parameter is a ``DTensor`` on a 1-D device mesh
of the group, placed by the JAX package's per-leaf rule
(:func:`fsdp_shardings`): a leaf of at least ``min_size`` elements is
``Shard(d)`` on its largest dimension that the group size divides, and
the rest (small leaves, leaves with no such dimension) ``Replicate()``.
The optimizer is built over those DTensors, so its state (Adam's
moments) takes the same placements.

The JAX step lets XLA insert the collectives from the shardings. The
port's step (:func:`make_fsdp_train_step`) writes them out, one rank per
process: at the start of the forward every sharded parameter is
all-gathered into its full tensor (an ``autograd.Function``), the
module runs on the full tensors, and in the backward each full gradient
is reduce-scattered back onto the shards (divided by the group size: the
mean over the ranks) as soon as it is ready; a replicated parameter's
gradient is all-reduced to its mean. The optimizer then steps the local
shards. ``torch.distributed.fsdp.fully_shard`` is not used: it shards
every parameter on dim 0, where the JAX rule picks the dim per leaf and
leaves small ones replicated.

Memory per rank: the parameters between steps, the gradients after the
backward and the optimizer state are ``1/n`` for every sharded leaf; the
full parameters live from the gather to the end of the backward, and
the whole module is gathered at once, so the peak keeps every full
parameter (a gather per block is not ported).

Contract, as in JAX: the loss is the GLOBAL batch mean. Each rank's
``loss_fn`` returns the mean over its share of the batch (equal shares),
and the gradients and the reported loss are averaged over the ranks.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.parallel.collectives import as_group
from chainermn_tpu_torch.training.train_step import (
    TrainState,
    _mean_buffers,
    normalize_loss_fn,
)


def _placement_of(shape, n: int, min_size: int):
    """``Shard(d)`` on the largest dim of ``shape`` that ``n`` divides (the
    first of equals), or ``Replicate()``: the JAX ``fsdp_shardings``
    rule for one leaf."""
    from torch.distributed.tensor import Replicate, Shard

    size = 1
    for s in shape:
        size *= s
    if size < min_size:
        return Replicate()
    best, best_dim = None, -1
    for d, s in enumerate(shape):
        if s % n == 0 and s > best_dim:
            best, best_dim = d, s
    return Replicate() if best is None else Shard(best)


def fsdp_shardings(tree, n: int, *, min_size: int = 2**15):
    """Per-leaf placements over a 1-D mesh of ``n`` ranks for ``tree`` (a
    module, giving its named parameters, or a dict of tensors): each
    leaf maps to ``(Shard(d),)`` or ``(Replicate(),)`` by the JAX rule."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    return {k: (_placement_of(tuple(v.shape), n, min_size),)
            for k, v in tree.items()}


def device_mesh(comm_or_group, device) -> "DeviceMesh":  # noqa: F821
    """The 1-D device mesh over a communicator's or group's ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    g = as_group(comm_or_group)
    if g is None:
        g = dist.group.WORLD
    return DeviceMesh.from_group(g, torch.device(device).type)


class _GatherShards(torch.autograd.Function):
    """The full parameter from its local shard: all-gather along the
    shard dim forward; the gradient's mean over the ranks, this rank's
    block of it, backward (a reduce-scatter). ``dim`` None: a replicated
    leaf, identity forward and an all-reduce mean backward."""

    @staticmethod
    def forward(ctx, local, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        if dim is None:
            return local.view_as(local)
        loc = local.movedim(dim, 0).contiguous()
        full = loc.new_empty((n * loc.shape[0],) + tuple(loc.shape[1:]))
        dist.all_gather_into_tensor(full, loc, group=group)
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.dim, ctx.group, ctx.n
        if dim is None:
            out = g.contiguous().clone()
            dist.all_reduce(out, group=group)
            return out / n, None, None, None
        gm = g.movedim(dim, 0).contiguous()
        part = gm.new_empty((gm.shape[0] // n,) + tuple(gm.shape[1:]))
        dist.reduce_scatter_tensor(part, gm, group=group)
        return (part / n).movedim(0, dim), None, None, None


def _owners(module: nn.Module) -> dict:
    """``{id(param): (param, [(owner module, attribute), ...])}``: a tied
    parameter has several owners."""
    out: dict = {}
    for mod in module.modules():
        for attr, p in mod._parameters.items():
            if p is not None:
                out.setdefault(id(p), (p, []))[1].append((mod, attr))
    return out


@contextlib.contextmanager
def _full_parameters(module: nn.Module, group, n: int):
    """Within the block, every DTensor parameter of ``module`` reads as
    its full tensor (gathered once, differentiable back to the shard);
    the parameters are put back at the end."""
    from torch.distributed.tensor import DTensor, Shard

    swapped = []
    for p, owners in _owners(module).values():
        if not isinstance(p, DTensor):
            continue
        pl = p.placements[0]
        dim = pl.dim if isinstance(pl, Shard) else None
        full = _GatherShards.apply(p.to_local(), dim, group, n)
        for mod, attr in owners:
            mod._parameters[attr] = full
            swapped.append((mod, attr, p))
    try:
        yield
    finally:
        for mod, attr, p in swapped:
            mod._parameters[attr] = p


def create_fsdp_train_state(model: nn.Module, make_optimizer: Callable,
                            comm, *, min_size: int = 2**15):
    """Place ``model``'s parameters as DTensors over the communicator's
    group by :func:`fsdp_shardings` (in place: each becomes a DTensor
    parameter; rank 0's parameters and buffers are broadcast first, as
    :func:`~chainermn_tpu_torch.training.create_train_state` does) and
    build ``make_optimizer(params)`` over them, so its state is placed
    alike. Returns ``(TrainState, placements)``; pass the placements to
    :func:`make_fsdp_train_step`. The buffers stay plain replicated
    tensors."""
    from torch.distributed.tensor import distribute_tensor

    comm.bcast_data(model)
    device = next(model.parameters()).device
    mesh = device_mesh(comm, device)
    n = mesh.size()
    placements = fsdp_shardings(model, n, min_size=min_size)
    owners = _owners(model)
    names = {id(p): k for k, p in model.named_parameters()}
    with torch.no_grad():
        for pid, (p, mods) in owners.items():
            d = nn.Parameter(distribute_tensor(p.detach(), mesh,
                                               placements[names[pid]]),
                             requires_grad=p.requires_grad)
            for mod, attr in mods:
                mod._parameters[attr] = d
    optimizer = make_optimizer(list(model.parameters()))
    return TrainState(model=model, optimizer=optimizer, step=0), placements


def make_fsdp_train_step(loss_fn: Callable, optimizer, comm,
                         placements: Optional[dict] = None):
    """The FSDP train step over the communicator ``comm``: ``step(state,
    batch) -> (state, metrics)``.

    ``loss_fn(model, batch)`` sees the module with full parameters and
    this rank's share of the batch, and returns its mean loss (or the
    tuple forms of :func:`~chainermn_tpu_torch.training.train_step.
    normalize_loss_fn`). The gradients reach the shards as the means over
    the ranks (see the module docstring), the optimizer steps the
    shards, floating buffers are averaged over the ranks, and
    ``metrics`` are the ranks' means. ``placements`` (from
    :func:`create_fsdp_train_state`) is checked against the module's."""
    group = as_group(comm)
    n = dist.get_world_size(group)
    loss_with_aux = normalize_loss_fn(loss_fn)

    def step(state: TrainState, batch):
        model = state.model
        if placements is not None:
            got = {k: tuple(p.placements) for k, p in
                   model.named_parameters()}
            if got != {k: tuple(v) for k, v in placements.items()}:
                raise ValueError("the module's parameters are not placed "
                                 "as create_fsdp_train_state placed them")
        optimizer.zero_grad(set_to_none=True)
        with _full_parameters(model, group, n):
            loss, metrics = loss_with_aux(model, batch)
        loss.backward()
        optimizer.step()
        if n > 1:
            _mean_buffers(model, comm)
        names = ["loss", *metrics]
        vals = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                            for v in (loss, *metrics.values())])
        dist.all_reduce(vals, group=group)
        return (state._replace(step=state.step + 1),
                dict(zip(names, (vals / n).unbind())))

    return step


__all__ = ["create_fsdp_train_state", "device_mesh", "fsdp_shardings",
           "make_fsdp_train_step"]
