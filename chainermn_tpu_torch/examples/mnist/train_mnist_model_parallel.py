"""Model-parallel MNIST, the port's twin of
``examples/mnist/train_mnist_model_parallel.py`` (the reference's
``examples/mnist/train_mnist_model_parallel.py`` †, SURVEY.md §2.8).

The three-layer MLP is split across two ranks joined by differentiable
send/recv: rank 0 holds ``w0, b0, w1, b1`` and rank 1 holds the head
``w2, b2``, as two components of a
:class:`~chainermn_tpu_torch.links.MultiNodeChainList`. The terminal
logits are broadcast to both ranks (``build(replicate_output=True)``),
every rank computes the same loss, and the backward crosses the stage
boundary once; each rank's SGD (momentum 0.9) updates its own stage. The
data, the batches (``np.random.RandomState(1)`` over ``get_mnist``'s
training set, the same batch on every rank) and the flags are the JAX
example's.

``--device`` defaults to the CUDA card (and raises without one); the
communicator defaults to ``pure_nccl`` there and to ``naive`` (gloo) on
the CPU. Two gloo ranks on the CPU::

    from chainermn_tpu_torch.testing import run_distributed
    run_distributed(worker, 2, {...})   # worker calls main(["--device", "cpu", ...])

or through :func:`chainermn_tpu_torch.testing.launch_ranks`, whose
ranks join the group with ``init_rank_from_env`` before ``main``.
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
from chainermn_tpu_torch.examples.mnist.train_mnist import get_mnist
from chainermn_tpu_torch.links import MultiNodeChainList


def _parser():
    p = argparse.ArgumentParser(description="model-parallel MNIST")
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=128)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--n-units", type=int, default=256)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights' generator")
    return p


def stage0_fn(params, x):
    h = torch.relu(x @ params["w0"] + params["b0"])
    return torch.relu(h @ params["w1"] + params["b1"])


def stage1_fn(params, h):
    return h @ params["w2"] + params["b2"]


def build_model(comm, n_units: int) -> MultiNodeChainList:
    """The two stages, with the JAX example's initializers (normal scaled
    by ``1 / sqrt(fan_in)``, zero biases)."""

    def stage0_init(gen, x):
        d = x.shape[-1]
        return {"w0": torch.randn(d, n_units, generator=gen) / math.sqrt(d),
                "b0": torch.zeros(n_units),
                "w1": (torch.randn(n_units, n_units, generator=gen)
                       / math.sqrt(n_units)),
                "b1": torch.zeros(n_units)}

    def stage1_init(gen, h):
        d = h.shape[-1]
        return {"w2": torch.randn(d, 10, generator=gen) / math.sqrt(d),
                "b2": torch.zeros(10)}

    model = MultiNodeChainList(comm)
    model.add_link(stage0_fn, rank=0, rank_out=1, init_fn=stage0_init)
    model.add_link(stage1_fn, rank=1, rank_in=0, init_fn=stage1_init)
    return model


def main(argv: Optional[Sequence[str]] = None, *, params=None) -> dict:
    """Train; returns ``{"losses": [...], "final_acc": ...}``. ``params``
    (a list of two dicts of arrays, e.g. the JAX example's through
    :func:`chainermn_tpu_torch.convert.chain_params_from_flax`) replaces
    the seeded initial weights."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    comm = create_communicator(
        args.communicator or ("pure_nccl" if device.type == "cuda"
                              else "naive"), device=device)
    if comm.rank == 0:
        print(f"communicator: {comm} (2-stage model parallel)", flush=True)
    train, _ = get_mnist()
    model = build_model(comm, args.n_units)
    x0 = torch.zeros(args.batchsize, 784)
    if params is None:
        params = model.init(args.seed, x0)
    params = [{k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
               .to(device).requires_grad_() for k, v in p.items()}
              for p in params]
    # each rank trains the stage it holds
    own = [t for comp, p in zip(model.components, params)
           if comp.rank == comm.rank for t in p.values()]
    opt = torch.optim.SGD(own, lr=args.lr, momentum=0.9)
    fwd = model.build(replicate_output=True)

    items = train
    rng = np.random.RandomState(1)
    losses = []
    acc = 0.0
    for it in range(args.iterations):
        idx = rng.randint(0, len(items), size=args.batchsize)
        x = torch.from_numpy(np.stack([items[i][0] for i in idx])).to(device)
        y = torch.from_numpy(np.stack([items[i][1] for i in idx])
                             ).long().to(device)
        logits = fwd(params, x)
        loss = F.cross_entropy(logits, y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
        acc = float((logits.argmax(-1) == y).float().mean())
        if comm.rank == 0 and (it + 1) % 25 == 0:
            print(f"iter {it + 1}/{args.iterations} loss={losses[-1]:.4f} "
                  f"acc={acc:.4f}", flush=True)
    if comm.rank == 0:
        print(f"final acc={acc:.4f}", flush=True)
    return {"losses": losses, "final_acc": acc}


if __name__ == "__main__":
    main()
