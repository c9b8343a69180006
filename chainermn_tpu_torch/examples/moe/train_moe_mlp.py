"""Expert-parallel (MoE) training, the port's twin of
``examples/moe/train_moe_mlp.py``: a residual MoE classifier with one
expert MLP a rank of the group, tokens routed by a learned gate through
two all-to-alls a pass (:func:`chainermn_tpu_torch.parallel.moe.
moe_layer_local`), Switch top-1 or GShard top-2 routing, and the
load-balancing auxiliary loss.

The task (10-blob classification, each blob with its own linear map,
from ``np.random.RandomState(0)``, each rank taking its rows of the
batch), the flags, the weights (drawn by :mod:`chainermn_tpu_torch.
utils.prng` as ``jax.random`` draws them, to a few ulps; ``run(...,
params=)`` takes others) and Adam are the JAX example's: Adam on the
dense leaves, whose gradients are averaged over the ranks, and on each
rank's own expert, whose gradient the all-to-all's backward gathered
from every rank's tokens. The printed loss is the task loss averaged
over the ranks.

``--dispatch-impl`` defaults to ``sort`` here: the JAX example's
``auto`` resolves to ``sort`` on every backend through its tuning
registry's default table; ``auto`` is ROADMAP queue 8 and exits.
``--device`` defaults to the CUDA card (and raises without one), and
``--communicator`` to ``pure_nccl`` there, ``naive`` (gloo) on the CPU.
One rank on the card::

    python -m chainermn_tpu_torch.examples.moe.train_moe_mlp

n gloo ranks on the CPU: a ``run_distributed`` worker that calls
:func:`run` (``["--device", "cpu", ...]``), which returns every
iteration's loss and accuracy.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel.moe import (
    load_balancing_loss,
    make_expert_params,
    moe_layer_local,
)
from chainermn_tpu_torch.utils import prng


def _parser():
    p = argparse.ArgumentParser(
        description="expert parallelism (MoE), the port's twin")
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=256)
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--topk", type=int, default=1, choices=(1, 2),
                   help="1: Switch top-1 routing; 2: GShard top-2")
    p.add_argument("--capacity-factor", type=float, default=1.5)
    p.add_argument("--dispatch-impl", default="sort",
                   choices=("auto", "einsum", "sort"),
                   help="queue assembly: dense one-hot einsum (reference) "
                        "or index sort/scatter (scalable, the default: the "
                        "JAX example's auto resolves to it); auto needs "
                        "the tuning registry, not ported yet")
    p.add_argument("--aux-weight", type=float, default=1e-2,
                   help="load-balancing auxiliary loss weight")
    return p


def expert_fn(params, x):
    return F.gelu(x @ params["w1"], approximate="tanh") @ params["w2"]


def init_weights(n_experts: int, width: int):
    """The JAX example's draws: ``w_in``, ``router`` and ``w_out`` from
    ``key(0)``, ``key(1)`` and ``key(3)``, and the experts from
    ``make_expert_params`` over ``key(2)`` (``w1``/``w2`` from the two
    halves of each expert's key). Returns ``(dense, experts)``, the
    experts stacked ``[n_experts, ...]``."""
    W = width

    def expert_init(key):
        k1, k2 = prng.split(key)
        return {"w1": prng.normal(k1, (W, 2 * W)) / math.sqrt(W),
                "w2": prng.normal(k2, (2 * W, W)) / math.sqrt(2 * W)}

    dense = {"w_in": prng.normal(prng.PRNGKey(0), (20, W)) * 0.3,
             "router": prng.normal(prng.PRNGKey(1), (W, n_experts)) * 0.1,
             "w_out": prng.normal(prng.PRNGKey(3), (W, 10)) * 0.1}
    experts = make_expert_params(expert_init, prng.PRNGKey(2), n_experts)
    return dense, experts


def run(argv: Optional[Sequence[str]] = None, *, group=None,
        params=None) -> dict:
    """Train; returns ``{"losses": [...], "accs": [...]}``, every
    iteration's task loss and accuracy (averaged over the ranks, the same
    on every rank). ``group``, a process group, replaces the
    communicator's (two ranks on one card over gloo); ``params``, a
    ``(dense, experts)`` pair of the :func:`init_weights` layout, replaces
    the drawn weights."""
    args = _parser().parse_args(argv)
    if args.dispatch_impl == "auto":
        raise SystemExit(
            "--dispatch-impl auto resolves through the tuning registry, "
            "which is not ported yet (ROADMAP queue 8); pass sort or einsum "
            "(the JAX registry's default table says sort)")
    device = resolve_device(args.device)
    if group is None:
        comm = create_communicator(
            args.communicator or ("pure_nccl" if device.type == "cuda"
                                  else "naive"), device=device)
        group = comm.group
    n, rank = C.axis_size_of(group), C.axis_index(group)
    if args.batchsize % n:
        raise ValueError(f"--batchsize {args.batchsize} must divide over "
                         f"{n} ranks")
    if rank == 0:
        print(f"moe: {n} experts, top-{args.topk} routing, capacity "
              f"x{args.capacity_factor}", flush=True)
    dense, experts = params or init_weights(n, args.width)
    # fresh leaves: the caller's tensors are never trained in place
    dense = {k: torch.as_tensor(v).detach().float().to(device, copy=True)
             .requires_grad_() for k, v in dense.items()}
    mine = {k: torch.as_tensor(v)[rank].detach().float().to(
        device, copy=True).requires_grad_() for k, v in experts.items()}
    opt_d = torch.optim.Adam(dense.values(), lr=args.lr)
    opt_e = torch.optim.Adam(mine.values(), lr=args.lr)
    rng = np.random.RandomState(0)
    maps = rng.randn(10, 20, 20).astype(np.float32) * 0.5
    centers = rng.randn(10, 20).astype(np.float32) * 2
    b = args.batchsize // n
    losses, accs = [], []
    for it in range(1, args.iterations + 1):
        y = rng.randint(0, 10, size=args.batchsize)
        base = centers[y] + 0.3 * rng.randn(args.batchsize, 20).astype(
            np.float32)
        x = np.einsum("bi,bij->bj", base, maps[y]) + base
        xl = torch.from_numpy(x[rank * b:(rank + 1) * b]).to(device)
        yl = torch.from_numpy(y[rank * b:(rank + 1) * b]).long().to(device)
        h = torch.tanh(xl @ dense["w_in"])
        # the aux loss regularises the router distribution the layer
        # dispatched with: the pre-residual activations
        aux = load_balancing_loss(h @ dense["router"])
        h = h + moe_layer_local(
            h, dense["router"], expert_fn, mine, group,
            capacity_factor=args.capacity_factor, k=args.topk,
            dispatch_impl=args.dispatch_impl)
        logits = h @ dense["w_out"]
        task = F.cross_entropy(logits, yl)
        acc = (logits.argmax(-1) == yl).float().mean()
        leaves = list(dense.values()) + list(mine.values())
        grads = torch.autograd.grad(task + args.aux_weight * aux, leaves)
        # the dense gradients, task and accuracy averaged over the ranks
        # in one all-reduce; the expert gradients are each rank's own
        nd = len(dense)
        flat = torch.cat([g.reshape(-1) for g in grads[:nd]]
                         + [task.detach().reshape(1), acc.reshape(1)])
        flat = C._all_reduce(flat, C.as_group(group), "mean")
        for t, g in zip(leaves, list(flat[:-2].split(
                [p.numel() for p in dense.values()])) + list(grads[nd:])):
            t.grad = g.view_as(t)
        opt_d.step()
        opt_e.step()
        losses.append(float(flat[-2]))
        accs.append(float(flat[-1]))
        if rank == 0 and it % 50 == 0:
            print(f"iter {it}/{args.iterations} loss={losses[-1]:.4f} "
                  f"acc={accs[-1]:.4f}", flush=True)
    if rank == 0:
        print(f"final: loss={losses[-1]:.4f} acc={accs[-1]:.4f}", flush=True)
    return {"losses": losses, "accs": accs}


def main(argv: Optional[Sequence[str]] = None) -> float:
    """Train; prints the final loss and returns the final accuracy, as
    the JAX example does."""
    return run(argv)["accs"][-1]


if __name__ == "__main__":
    main()
