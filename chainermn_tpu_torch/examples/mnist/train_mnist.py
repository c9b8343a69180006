"""Distributed MNIST training, the port's twin of
``examples/mnist/train_mnist.py``: the same synthetic data (``get_mnist``),
shards, iterator seeds, optimizer and evaluation.

    python -m chainermn_tpu_torch.examples.mnist.train_mnist
    python -m chainermn_tpu_torch.examples.mnist.train_mnist \\
        --device cpu --iterations 100

``--device`` defaults to the CUDA card (and raises without one); the
communicator defaults to ``pure_nccl`` there and to ``naive`` (gloo) on
the CPU. Several ranks: one process each, launched by
:func:`chainermn_tpu_torch.testing.run_distributed` on the CPU (or by any
launcher that initialises the default process group first).

``--checkpoint DIR`` snapshots every ``--checkpoint-interval``
iterations through the async native writer and resumes from the newest
snapshot all ranks share, as the JAX example does; ``--checkpoint-backend
orbax`` stores through ``torch.distributed.checkpoint`` instead (the
JAX example's choice names run unchanged)::

    python -m chainermn_tpu_torch.examples.mnist.train_mnist \
        --device cpu --checkpoint ckpt --checkpoint-interval 50 \
        --iterations 100   # then again with --iterations 200: resumes at 100

``--local-sgd H`` averages the parameters every H steps instead of
reducing the gradients each step (``--outer-momentum``: DiLoCo's outer
heavy-ball momentum); ``--reduction-schedule flat|two_level|zero`` or a
composition signature over the communicator's axes (``'rs(data)>ag(data)'``,
sliced ``'rs(data)[s0..3]>ag(data)'``; ``inter``/``intra`` under the
topology communicators) pins the gradient reduction; ``--error-feedback``
feeds the int8 wire's rounding back (``--allreduce-grad-dtype int8``).
``--reduction-schedule auto`` exits naming ROADMAP queue 8.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.communicators import example_communicator
from chainermn_tpu_torch.datasets import scatter_dataset
from chainermn_tpu_torch.extensions import (
    create_dcp_checkpointer,
    create_multi_node_checkpointer,
    create_multi_node_evaluator,
)
from chainermn_tpu_torch.iterators import create_synchronized_iterator
from chainermn_tpu_torch.models.mlp import MLP
from chainermn_tpu_torch.optimizers import (
    create_local_sgd,
    create_multi_node_optimizer,
)
from chainermn_tpu_torch.parallel.reduction_schedule import check_schedule
from chainermn_tpu_torch.training import (
    Trainer,
    create_train_state,
    default_collate,
    make_eval_step,
    make_train_step,
)
from chainermn_tpu_torch.training.prefetch import to_device

def get_mnist(n_train=8192, n_test=1024, seed=0):
    """Synthetic stand-in with MNIST shapes: 10 gaussian blobs in 784-d,
    the JAX example's data number for number."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 784).astype(np.float32)

    def make(n):
        y = rng.randint(0, 10, size=n)
        x = centers[y] + 0.5 * rng.randn(n, 784).astype(np.float32)
        return [(x[i], np.int32(y[i])) for i in range(n)]

    return make(n_train), make(n_test)


def _parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: MNIST")
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=256,
                   help="per-rank batch size")
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--double-buffering", action="store_true")
    p.add_argument("--local-sgd", type=int, default=0, metavar="H",
                   help="periodic parameter averaging every H steps "
                        "instead of the per-step gradient allreduce; "
                        "0 = off")
    p.add_argument("--outer-momentum", type=float, default=0.0,
                   help="DiLoCo outer heavy-ball momentum on the sync "
                        "deltas")
    p.add_argument("--allreduce-grad-dtype", default=None)
    p.add_argument("--reduction-schedule", default=None, metavar="SCHED",
                   help="gradient-reduction schedule: flat | two_level | "
                        "zero | a composition signature, e.g. "
                        "'rs(data)[s0..3]>ag(data)'; default: the "
                        "communicator's own strategy")
    p.add_argument("--error-feedback", action="store_true",
                   help="EF-SGD residual feedback over the int8 wire "
                        "(requires --allreduce-grad-dtype int8)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="fault-tolerant snapshots every "
                        "--checkpoint-interval iterations (async native "
                        "writer); resumes from the newest snapshot all "
                        "ranks share")
    p.add_argument("--checkpoint-interval", type=int, default=50)
    p.add_argument("--checkpoint-backend", default="npz",
                   choices=("npz", "orbax"),
                   help="npz: per-rank snapshot files; orbax: the JAX "
                        "example's name for its framework-standard "
                        "backend, which here stores through "
                        "torch.distributed.checkpoint with the same "
                        "cross-rank resume agreement (so a JAX command "
                        "line runs unchanged)")
    p.add_argument("--prefetch", type=int, default=0,
                   help="batches copied to the device ahead of the step "
                        "(0 = off)")
    return p


def _cross_entropy(logits, y):
    return F.cross_entropy(logits.float(), y.long())


def loss_fn(model, batch):
    x, y = batch
    logits = model(x)
    acc = (logits.argmax(-1) == y).float().mean()
    return _cross_entropy(logits, y), {"accuracy": acc}


def metric_fn(model, batch):
    x, y = batch
    logits = model(x)
    return {"val_loss": _cross_entropy(logits, y),
            "val_acc": (logits.argmax(-1) == y).float().mean()}


def _evaluate(eval_step, dataset, batchsize, comm):
    """Mean of the eval step's metrics over this rank's full batches; every
    rank runs the same number of batches (its eval step is collective)."""
    def fn(state):
        items = list(dataset)
        n_batches = max(0, (len(items) - batchsize) // batchsize + 1)
        if comm.size > 1:
            n_batches = min(comm.allgather_obj(n_batches))
        totals: dict = {}
        for b in range(n_batches):
            i = b * batchsize
            batch = to_device(default_collate(items[i:i + batchsize]),
                              comm.device)
            for k, v in eval_step(state.model, batch).items():
                totals[k] = totals.get(k, 0.0) + float(v)
        return {k: v / max(n_batches, 1) for k, v in totals.items()}

    return fn


def main(argv=None):
    """Train; returns the final evaluation ``{'val_loss', 'val_acc'}``."""
    p = _parser()
    args = p.parse_args(argv)
    if args.local_sgd:
        bad = [f for f, on in (
            ("--double-buffering", args.double_buffering),
            ("--error-feedback", args.error_feedback),
            ("--allreduce-grad-dtype", args.allreduce_grad_dtype),
            ("--reduction-schedule", args.reduction_schedule),
        ) if on]
        if bad:
            p.error(f"--local-sgd replaces the per-step gradient wire; "
                    f"{', '.join(bad)} would be silently ignored")
    try:  # 'auto' is ROADMAP queue 8's; a signature must parse
        check_schedule(args.reduction_schedule)
    except (NotImplementedError, ValueError) as e:
        p.error(str(e))
    device = resolve_device(args.device)
    try:
        comm = example_communicator(
            args.communicator, device,
            allreduce_grad_dtype=args.allreduce_grad_dtype)
    except NotImplementedError as e:  # the 'auto' wire: ROADMAP queue 8
        p.error(str(e))
    global_except_hook._add_hook()
    if comm.rank == 0:
        print(f"communicator: {comm}")

    train, test = get_mnist()
    train = scatter_dataset(train, comm, shuffle=True, seed=42)
    test = scatter_dataset(test, comm)

    model = MLP(seed=0, device=device)
    inner = torch.optim.SGD(model.parameters(), lr=args.lr, momentum=0.9)
    if args.local_sgd:
        optimizer = create_local_sgd(inner, comm, sync_every=args.local_sgd,
                                     outer_momentum=args.outer_momentum)
    else:
        try:  # a refused composition (a sharded update, the int8 wire)
            optimizer = create_multi_node_optimizer(
                inner, comm, double_buffering=args.double_buffering,
                error_feedback=args.error_feedback,
                reduction_schedule=args.reduction_schedule)
        except ValueError as e:
            p.error(str(e))
    state = create_train_state(model, optimizer, comm)
    step = make_train_step(loss_fn, optimizer, comm)
    evaluator = create_multi_node_evaluator(
        _evaluate(make_eval_step(metric_fn, comm), test, args.batchsize,
                  comm), comm)

    ckpt = None
    start_iteration = 0
    if args.checkpoint:
        make = (create_dcp_checkpointer if args.checkpoint_backend == "orbax"
                else create_multi_node_checkpointer)
        ckpt = make("mnist", comm, path=args.checkpoint)
        state, restored_it = ckpt.maybe_load(state)
        if restored_it is not None:
            start_iteration = restored_it
            if comm.rank == 0:
                print(f"resumed from iteration {restored_it}")

    train_iter = create_synchronized_iterator(train, args.batchsize, comm,
                                              seed=1)
    trainer = Trainer(step, state, train_iter, comm, log_interval=50,
                      prefetch=args.prefetch)

    def run_eval(tr):
        metrics = evaluator(tr.state)
        if comm.rank == 0:
            print("  eval:", {k: round(v, 4) for k, v in metrics.items()})

    trainer.extend(run_eval, interval=100)
    if ckpt is not None:
        def snapshot(tr):
            # async: copied to host bytes now, written and fsynced on the
            # native writer's thread
            ckpt.save(tr.state, start_iteration + tr.iteration, block=False)

        trainer.extend(snapshot, interval=args.checkpoint_interval)
    state = trainer.run(max(0, args.iterations - start_iteration))
    if ckpt is not None:
        # labelled with the true iteration: when a restore already reached
        # --iterations, run() took no step and the weights are still
        # start_iteration's
        ckpt.save(state, start_iteration + trainer.iteration, block=False)
        ckpt.close()  # drain the async saves and release the backend
    final = evaluator(state)
    if comm.rank == 0:
        print("final:", {k: round(v, 4) for k, v in final.items()})
    return final


if __name__ == "__main__":
    main()
