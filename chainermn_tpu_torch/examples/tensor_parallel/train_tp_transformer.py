"""Tensor-parallel transformer block training, Megatron-style, the port's
twin of ``examples/tensor_parallel/train_tp_transformer.py``.

A transformer block with heads-sharded attention and hidden-sharded MLP
(:func:`~chainermn_tpu_torch.parallel.tensor.tp_attention`,
:func:`~chainermn_tpu_torch.parallel.tensor.tp_mlp`) over ``dp x tp``
ranks, one process per rank: rank ``d * tp + m`` holds shard ``m`` of
the weights and rows ``d`` of the batch. Each column->row pair makes one
all-reduce over the rank's tensor-parallel group (the ranks of its
``d``); the shards' gradients are exact per shard and are averaged over
the data-parallel group (the ranks of its ``m``), as the JAX example's
``pmean`` over ``'data'`` does.

The task and the flags are the JAX example's: next-token-style
regression onto a fixed random teacher block (teacher seed 123, student
seed 0, weights drawn by :mod:`chainermn_tpu_torch.utils.prng` as
``jax.random`` draws them, to a few ulps), ``np.random.RandomState(0)``
batches, Adam.

``--device`` defaults to the CUDA card (and raises without one), and
``--communicator`` to ``pure_nccl`` there, ``naive`` (gloo) on the CPU.
One rank on the card::

    python -m chainermn_tpu_torch.examples.tensor_parallel.train_tp_transformer

n gloo ranks on the CPU: a ``run_distributed`` worker that calls
``main(["--device", "cpu", ...])``, or :func:`chainermn_tpu_torch.testing.
launch_ranks` with ranks that call ``init_rank_from_env`` first.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.ops.attention import dot_product_attention
from chainermn_tpu_torch.parallel.tensor import (
    stack_tp_params,
    tp_attention,
    tp_mlp,
)
from chainermn_tpu_torch.utils import prng

#: the six weights in the order the JAX example draws them, with the dim
#: each is split along (column layers 1, row layers 0)
WEIGHTS = (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0), ("w1", 1), ("w2", 0))


def _parser():
    p = argparse.ArgumentParser(
        description="Megatron-style tensor parallelism (the port's twin)")
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--d-model", type=int, default=32)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel width; the model axis gets the rest "
                        "(default: 2 when the world size allows, else 1)")
    return p


def init_full(seed: int, d: int) -> dict:
    """The JAX example's ``init_full``: normal draws scaled by
    ``1/sqrt(fan_in)`` from ``split(key(seed), 6)``."""
    keys = prng.split(prng.PRNGKey(seed), 6)
    ff = 4 * d
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
              "w1": (d, ff), "w2": (ff, d)}
    return {name: prng.normal(keys[i], shapes[name])
            * (1.0 / np.sqrt(shapes[name][0]))
            for i, (name, _) in enumerate(WEIGHTS)}


def teacher_block(t: dict, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The full-width block that makes the targets."""
    B, T, D = x.shape
    hd = D // n_heads
    q, k, v = ((x @ t[w]).reshape(B, T, n_heads, hd)
               for w in ("wq", "wk", "wv"))
    h = x + dot_product_attention(q, k, v, causal=True).reshape(B, T, D) \
        @ t["wo"]
    return h + F.gelu(h @ t["w1"], approximate="tanh") @ t["w2"]


def _groups(n: int, dp: int, tp: int, backend: str):
    """This rank's tensor-parallel group (the ranks of its data index)
    and data-parallel group (the ranks of its model index); every rank
    creates every group, in the same order."""
    rank = dist.get_rank()
    if n == 1:
        return dist.group.WORLD, dist.group.WORLD
    tp_group = dp_group = None
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)], backend=backend)
        if rank // tp == d:
            tp_group = g
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)], backend=backend)
        if rank % tp == m:
            dp_group = g
    return tp_group, dp_group


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Train; returns ``{"losses": [...], "final": ...}``, the loss of
    every iteration (averaged over all ranks, as the JAX example's
    ``pmean`` over both axes)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    comm = create_communicator(
        args.communicator or ("pure_nccl" if device.type == "cuda"
                              else "naive"), device=device)
    global_except_hook._add_hook()
    n = comm.size
    if args.dp is None:
        args.dp = 2 if n % 2 == 0 and n > 1 else 1
    if n % args.dp:
        raise SystemExit(f"--dp {args.dp} must divide the world size {n}")
    tp = n // args.dp
    if args.n_heads % tp:
        raise SystemExit(f"--n-heads {args.n_heads} must divide by tp={tp}")
    if comm.rank == 0:
        print(f"tensor parallel: dp={args.dp} x tp={tp}, {args.n_heads} "
              f"heads, d_model={args.d_model}", flush=True)
    tp_group, dp_group = _groups(n, args.dp, tp, comm.backend)
    d_idx, m_idx = comm.rank // tp, comm.rank % tp
    D = args.d_model

    full = init_full(0, D)
    params = {name: stack_tp_params(full[name], tp, dim)[m_idx].to(device)
              .requires_grad_() for name, dim in WEIGHTS}
    teacher = {k: v.to(device) for k, v in init_full(123, D).items()}
    opt = torch.optim.Adam(params.values(), lr=args.lr)

    def block(p, x):
        h = x + tp_attention(x, p["wq"], p["wk"], p["wv"], p["wo"],
                             group=tp_group, n_heads=args.n_heads,
                             causal=True)
        return h + tp_mlp(h, p["w1"], None, p["w2"], None, group=tp_group)

    rows = args.batchsize // args.dp
    rng = np.random.RandomState(0)
    losses = []
    for it in range(1, args.iterations + 1):
        x = torch.from_numpy(rng.randn(args.batchsize, args.seq_len, D)
                             .astype(np.float32)).to(device)
        with torch.no_grad():
            t = teacher_block(teacher, x, args.n_heads)
        xs = x[d_idx * rows:(d_idx + 1) * rows]
        ts = t[d_idx * rows:(d_idx + 1) * rows]
        loss = torch.mean((block(params, xs) - ts) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        # the TP shards' gradients are exact per shard: average over data
        for p in params.values():
            dist.all_reduce(p.grad, group=dp_group)
            p.grad /= args.dp
        opt.step()
        mean = loss.detach().clone()
        dist.all_reduce(mean, group=comm.group)
        losses.append(float(mean) / n)
        if comm.rank == 0 and it % 50 == 0:
            print(f"iter {it}/{args.iterations} loss={losses[-1]:.4f}",
                  flush=True)
    if comm.rank == 0:
        print(f"final: loss={losses[-1]:.4f}", flush=True)
    return {"losses": losses, "final": losses[-1]}


if __name__ == "__main__":
    main()
