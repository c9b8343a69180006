"""Pipeline-parallel training, the port's twin of
``examples/pipeline/train_pipeline_mlp.py``: a deep residual MLP split
into ``n_stages`` stages, one a rank, through the port's engines
(:mod:`chainermn_tpu_torch.parallel.pipeline`).

``--schedule gpipe`` (the default) runs :func:`make_pipeline` with the
embed (``w_in``) before and the head (``w_out``) after the conveyor on
every rank, and autograd's backward; ``1f1b`` runs
:func:`make_pipeline_1f1b`, the embed training through the engine's
input gradients and the softmax head through its head gradients (the
accuracy from a :func:`make_pipeline` forward, as the JAX example
measures it); ``hetero`` runs :func:`make_pipeline_hetero` with the
embed as stage 0's function and the head as the last stage's (at least
two stages). The task (10-blob classification from
``np.random.RandomState(0)``), the flags, the weights (drawn by
:mod:`chainermn_tpu_torch.utils.prng` as ``jax.random`` draws them, to a
few ulps) and Adam are the JAX example's; each rank trains its own
stage and the replicated embed and head, whose gradients the engines'
boundary makes equal on every rank.

``--device`` defaults to the CUDA card (and raises without one), and
``--communicator`` to ``pure_nccl`` there, ``naive`` (gloo) on the CPU;
stages = the world size. One rank on the card::

    python -m chainermn_tpu_torch.examples.pipeline.train_pipeline_mlp

n gloo ranks on the CPU: a ``run_distributed`` worker that calls
``main(["--device", "cpu", ...])`` (or :func:`run`, which returns every
iteration's loss and accuracy), or :func:`chainermn_tpu_torch.testing.
launch_ranks` with ranks that call ``init_rank_from_env`` first.
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
from chainermn_tpu_torch.parallel.pipeline import (
    make_pipeline,
    make_pipeline_1f1b,
    make_pipeline_hetero,
)
from chainermn_tpu_torch.utils import prng


def _parser():
    p = argparse.ArgumentParser(
        description="GPipe/1F1B pipeline parallelism (the port's twin)")
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=128)
    p.add_argument("--iterations", type=int, default=150)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--microbatches", type=int, default=None,
                   help="default: 2x the stage count")
    p.add_argument("--remat-stages", action="store_true",
                   help="recompute stage-internal activations in the "
                        "backward")
    p.add_argument("--schedule", choices=("gpipe", "1f1b", "hetero"),
                   default="gpipe")
    return p


def stage_fn(params, x):
    """One residual block per stage: homogeneous in/out shape [mb, W]."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def init_weights(n_stages: int, width: int):
    """The JAX example's draws: per stage ``w1``, ``b1``, ``w2`` from
    ``split(key(0), n_stages)`` (``w2`` from ``fold_in(k, 1)``), and the
    embed and head from ``key(1)`` and ``key(2)``."""
    W = width
    stages = []
    for k in prng.split(prng.PRNGKey(0), n_stages):
        stages.append({
            "w1": prng.normal(k, (W, W)) * (1.0 / math.sqrt(W)),
            "b1": torch.zeros(W),
            "w2": prng.normal(prng.fold_in(k, 1), (W, W))
            * (0.5 / math.sqrt(W))})
    w_in = prng.normal(prng.PRNGKey(1), (784, W)) * 0.05
    w_out = prng.normal(prng.PRNGKey(2), (W, 10)) * 0.05
    return stages, w_in, w_out


def run(argv: Optional[Sequence[str]] = None, *, group=None) -> dict:
    """Train; returns ``{"losses": [...], "accs": [...]}``, every
    iteration's loss and accuracy (the same on every rank). ``group``,
    a process group, replaces the communicator as the stage group (two
    ranks on one card over gloo)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if group is None:
        comm = create_communicator(
            args.communicator or ("pure_nccl" if device.type == "cuda"
                                  else "naive"), device=device)
        group = comm.group
    n_stages, rank = C.axis_size_of(group), C.axis_index(group)
    n_micro = args.microbatches or 2 * n_stages
    if rank == 0:
        print(f"pipeline: {n_stages} stages x {n_micro} microbatches "
              f"(remat={args.remat_stages}, schedule={args.schedule})",
              flush=True)
    stages, w_in, w_out = init_weights(n_stages, args.width)

    def leaf(t):
        return t.to(device).requires_grad_()

    w_in, w_out = leaf(w_in), leaf(w_out)
    if args.schedule == "hetero":
        # embed and head INSIDE the pipeline, every stage's params on
        # every rank; the middle stages are the first n - 2 blocks
        def embed_fn(p, x):
            return torch.tanh(x @ p["w_in"])

        def head_fn(p, h):
            return h @ p["w_out"]

        params = ([{"w_in": w_in}]
                  + [{k: leaf(v) for k, v in p.items()}
                     for p in stages[:n_stages - 2]]
                  + [{"w_out": w_out}])
        trained = [t for p in params for t in p.values()]
        pipe = make_pipeline_hetero(
            [embed_fn] + [stage_fn] * (n_stages - 2) + [head_fn], group,
            n_microbatches=n_micro, remat_stages=args.remat_stages)
    else:
        own = {k: leaf(v) for k, v in stages[rank].items()}
        trained = list(own.values()) + [w_in, w_out]
        pipe = make_pipeline(stage_fn, group, n_microbatches=n_micro,
                             remat_stages=args.remat_stages)
    opt = torch.optim.Adam(trained, lr=args.lr)

    def head_loss_grad(w, h_mb, y_mb):
        with torch.enable_grad():
            w = w.detach().requires_grad_()
            h = h_mb.detach().requires_grad_()
            loss = F.cross_entropy(h @ w, y_mb)
            dw, dh = torch.autograd.grad(loss, (w, h))
        return loss.detach(), (dw, dh)

    engine = make_pipeline_1f1b(stage_fn, head_loss_grad, group,
                                n_microbatches=n_micro)
    rng = np.random.RandomState(0)
    centers = rng.randn(10, 784).astype(np.float32)
    losses, accs = [], []
    for it in range(1, args.iterations + 1):
        y_np = rng.randint(0, 10, size=args.batchsize)
        x_np = centers[y_np] + 0.5 * rng.randn(args.batchsize, 784).astype(
            np.float32)
        x = torch.from_numpy(x_np).to(device)
        y = torch.from_numpy(y_np).long().to(device)
        opt.zero_grad()
        if args.schedule == "gpipe":
            logits = pipe(own, torch.tanh(x @ w_in)) @ w_out
            loss = F.cross_entropy(logits, y)
            loss.backward()
        elif args.schedule == "hetero":
            logits = pipe(params, x)
            loss = F.cross_entropy(logits, y)
            loss.backward()
        else:  # 1f1b: the engine is the forward and the backward
            h = torch.tanh(x @ w_in)
            loss, g_stage, g_head, dh = engine(
                own, h.detach(), y, w_out.detach(), collect_input_grads=True)
            (w_in.grad,) = torch.autograd.grad(h, w_in, dh)
            w_out.grad = g_head
            for k, t in own.items():
                t.grad = g_stage[k]
            with torch.no_grad():  # the accuracy, before the update
                logits = pipe(own, h) @ w_out
        acc = (logits.argmax(-1) == y).float().mean()
        opt.step()
        losses.append(float(loss.detach()))
        accs.append(float(acc))
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
