"""Distributed ImageNet training, the port's twin of
``examples/imagenet/train_imagenet.py``: ResNet-50 by default, per-rank
batch 64 of 224x224 synthetic images from ``np.random.default_rng(0)``,
SGD(0.1, momentum 0.9) behind the multi-node optimizer, the bf16 wire,
and sync-BN over the communicator.

    python -m chainermn_tpu_torch.examples.imagenet.train_imagenet \\
        --iterations 100 [--double-buffering] [--profile DIR]
    python -m chainermn_tpu_torch.examples.imagenet.train_imagenet \\
        --device cpu --arch resnet18 --image-size 32 --batchsize 2 \\
        --iterations 3

``--device`` defaults to the CUDA card (and raises without one): there the
communicator is ``pure_nccl``, compute bf16 and memory channels_last; with
``--device cpu`` it is ``naive`` (gloo) and compute fp32. Every rank draws
the global batch (``batchsize x size`` images) from the same generator
and takes its own contiguous slice, the shard the JAX mesh gives it.
Besides the JAX example's ``resnet50``, ``--arch`` takes the other ResNet
depths (``resnet18`` for small runs). ``--profile DIR`` writes a
``torch.profiler`` trace of iterations 10-20.

``--optimizer lars|lamb`` takes :class:`~chainermn_tpu_torch.optimizers.
LARS`/:class:`~chainermn_tpu_torch.optimizers.LAMB` (``optax.lars``/
``optax.lamb`` with their defaults) in place of SGD with momentum;
``--local-sgd H`` averages the parameters every H steps instead of the
per-step gradient reduction (and so refuses ``--double-buffering`` and
``--error-feedback``, as the JAX example does); ``--error-feedback`` feeds the int8 wire's
rounding back (``--allreduce-grad-dtype int8``).

Left for later, each refused with an error naming its ROADMAP item:
``--arch alex|googlenet|googlenetbn|vit_s16``, ``--native-loader`` and
``--train-root`` (queue 9); ``--remat`` and ``--stem space_to_depth``
(queue 1, item 3.6).
"""

from __future__ import annotations

import argparse
import os
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.communicators import example_communicator
from chainermn_tpu_torch.models import resnet
from chainermn_tpu_torch.optimizers import (
    LAMB,
    LARS,
    create_local_sgd,
    create_multi_node_optimizer,
)
from chainermn_tpu_torch.training import create_train_state, make_train_step
from chainermn_tpu_torch.training.prefetch import to_device

ARCHS = {"resnet18": resnet.ResNet18, "resnet34": resnet.ResNet34,
         "resnet50": resnet.ResNet50, "resnet101": resnet.ResNet101,
         "resnet152": resnet.ResNet152}
_LATER_ARCHS = ("alex", "googlenet", "googlenetbn", "vit_s16")
_LATER = {
    "native_loader": "ROADMAP queue 9 (native/: the C++ loader)",
    "train_root": "ROADMAP queue 9 (the real-data input path)",
    "remat": "ROADMAP queue 1, item 3.6 (the ResNet remat)",
}


def synthetic_batch(rng, batch, size):
    """The JAX example's batch: NHWC fp32 images, int32 labels."""
    x = rng.standard_normal((batch, size, size, 3), np.float32)
    y = rng.integers(0, 1000, size=(batch,)).astype(np.int32)
    return x, y


def local_batch(rng, batchsize, image_size, rank, size):
    """This rank's contiguous slice of the next global batch
    (``batchsize x size`` images drawn by :func:`synthetic_batch`)."""
    x, y = synthetic_batch(rng, batchsize * size, image_size)
    lo = rank * batchsize
    return x[lo:lo + batchsize], y[lo:lo + batchsize]


def to_model_input(batch, device):
    """An NHWC numpy batch as NCHW tensors on ``device``: the permuted
    view has channels_last strides, which the copy keeps."""
    x, y = batch
    return to_device((torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(y)), device)


def loss_fn(model, batch):
    x, y = batch
    logits = model(x)
    acc = (logits.argmax(-1) == y).float().mean()
    return F.cross_entropy(logits, y.long()), {"accuracy": acc}


def _parser():
    p = argparse.ArgumentParser(
        description="chainermn_tpu_torch example: ImageNet")
    p.add_argument("--arch", default="resnet50",
                   choices=sorted(ARCHS) + list(_LATER_ARCHS))
    p.add_argument("--communicator", default=None,
                   help="default: pure_nccl on cuda, naive on cpu")
    p.add_argument("--device", default=None,
                   help="default: the current CUDA card")
    p.add_argument("--batchsize", type=int, default=64,
                   help="per-rank batch size")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--iterations", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "lars", "lamb"],
                   help="sgd+momentum (default) or the large-batch "
                        "layer-adaptive optimizers")
    p.add_argument("--double-buffering", action="store_true")
    p.add_argument("--local-sgd", type=int, default=0, metavar="H")
    p.add_argument("--allreduce-grad-dtype", default="bfloat16")
    p.add_argument("--error-feedback", action="store_true")
    p.add_argument("--stem", default="standard",
                   choices=["standard", "space_to_depth"])
    p.add_argument("--remat", nargs="?", const="full", default=None,
                   choices=["full", "conv", "dots", "nothing"])
    p.add_argument("--profile", default=None,
                   help="directory for a torch.profiler trace of iters "
                        "10-20")
    p.add_argument("--train-root", default=None)
    p.add_argument("--native-loader", default=None, metavar="FILE.bin")
    return p


def setup(argv=None) -> SimpleNamespace:
    """Parse ``argv`` and build the run: ``args``, ``comm``, ``device``,
    ``model``, ``state``, ``step`` and ``next_batch()``
    (this rank's slice of the next global batch, NHWC numpy)."""
    p = _parser()
    args = p.parse_args(argv)
    for flag, item in _LATER.items():
        if getattr(args, flag):
            p.error(f"--{flag.replace('_', '-')} is not ported yet ({item})")
    if args.local_sgd and (args.double_buffering or args.error_feedback):
        p.error("--local-sgd replaces the per-step gradient wire; "
                "--double-buffering/--error-feedback would be silently "
                "ignored")
    if args.arch in _LATER_ARCHS:
        p.error(f"--arch {args.arch} is not ported yet (ROADMAP queue 9: "
                "models/imagenet.py and models/vit.py)")
    device = resolve_device(args.device)
    try:
        comm = example_communicator(
            args.communicator, device,
            allreduce_grad_dtype=args.allreduce_grad_dtype or None)
    except NotImplementedError as e:  # the 'auto' wire: ROADMAP queue 8
        p.error(str(e))
    global_except_hook._add_hook()
    if comm.rank == 0:
        print(f"communicator: {comm}  arch: {args.arch}")
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if device.type == "cuda":
        # every step has the same shapes: let cuDNN pick its algorithms
        torch.backends.cudnn.benchmark = True
    model = ARCHS[args.arch](bn_comm=comm, compute_dtype=compute_dtype,
                             stem=args.stem, seed=0, device=device)
    inner = {"sgd": lambda ps: torch.optim.SGD(ps, lr=args.lr,
                                               momentum=0.9),
             "lars": lambda ps: LARS(ps, lr=args.lr),
             "lamb": lambda ps: LAMB(ps, lr=args.lr)}[args.optimizer](
        model.parameters())
    if args.local_sgd:
        optimizer = create_local_sgd(inner, comm, sync_every=args.local_sgd)
    else:
        optimizer = create_multi_node_optimizer(
            inner, comm, double_buffering=args.double_buffering,
            error_feedback=args.error_feedback)
    state = create_train_state(model, optimizer, comm)
    step = make_train_step(loss_fn, optimizer, comm)
    rng = np.random.default_rng(0)

    def next_batch():
        return local_batch(rng, args.batchsize, args.image_size, comm.rank,
                           comm.size)

    return SimpleNamespace(args=args, comm=comm, device=device, model=model,
                           state=state, step=step, next_batch=next_batch)


def main(argv=None):
    """Train; returns the last step's metrics (0-dim tensors)."""
    run = setup(argv)
    args, comm = run.args, run.comm
    global_batch = args.batchsize * comm.size
    state, metrics, prof = run.state, None, None
    t0 = time.perf_counter()
    for it in range(args.iterations):
        if args.profile and it == 10:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if run.device.type == "cuda" else [])])
            prof.__enter__()
        batch = to_model_input(run.next_batch(), run.device)
        state, metrics = run.step(state, batch)
        if prof is not None and it == 20:
            float(metrics["loss"])  # waits for the step
            prof.__exit__(None, None, None)
            os.makedirs(args.profile, exist_ok=True)
            path = os.path.join(args.profile, f"trace_rank{comm.rank}.json")
            prof.export_chrome_trace(path)
            prof = None
            if comm.rank == 0:
                print(f"profile written to {path}")
        if comm.rank == 0 and ((it + 1) % 10 == 0
                               or it + 1 == args.iterations):
            loss = float(metrics["loss"])  # waits for the step
            ips = global_batch * (it + 1) / (time.perf_counter() - t0)
            print(f"iter {it + 1}/{args.iterations} loss={loss:.4f} "
                  f"acc={float(metrics['accuracy']):.4f} ({ips:.1f} img/s)")
    if prof is not None:
        prof.__exit__(None, None, None)
    if comm.rank == 0 and metrics is not None:
        float(metrics["loss"])
        total = time.perf_counter() - t0
        print(f"done: {args.iterations} iters, "
              f"{global_batch * args.iterations / total:.1f} images/sec")
    return metrics


if __name__ == "__main__":
    main()
