"""Rank workers of the port's multi-rank tests.

``chainermn_tpu_torch.testing.run_distributed`` runs each of these in
``size`` spawned gloo processes; a child imports this module before it
runs anything, so it imports no JAX. Each worker runs every case of its
test file in one launch and returns flat ``{name: ndarray}`` results.
"""

from __future__ import annotations

import contextlib
import io
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chainermn_tpu_torch import global_except_hook
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.datasets import scatter_dataset
from chainermn_tpu_torch.extensions import (
    AllreducePersistent,
    create_multi_node_evaluator,
)
from chainermn_tpu_torch.iterators import (
    create_multi_node_iterator,
    create_synchronized_iterator,
)
from chainermn_tpu_torch.links import MultiNodeBatchNormalization
from chainermn_tpu_torch.models import MLP, ResNet18
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.training import (
    Trainer,
    create_train_state,
    make_train_step,
)


#: torch threads in a test process that runs these tests: the suite
#: runs several test processes at once, and the port's CPU tests are
#: small
TEST_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Run a test module that imports this fixture on TEST_THREADS torch
    threads, then restore the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(TEST_THREADS, before))
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def kept_excepthook():
    """Put ``sys.excepthook`` and the port's installed-hook flag back as
    they were when the block ends. The example twins install the port's
    hook for the life of the process, as the JAX examples install
    theirs; a later test in the same process (the JAX package's own hook
    test among them) must find the hook it had."""
    hook, installed = sys.excepthook, global_except_hook._hook_installed
    try:
        yield
    finally:
        sys.excepthook = hook
        global_except_hook._hook_installed = installed


@pytest.fixture(autouse=True)
def restore_excepthook():
    """Run each test of a module that imports this fixture inside
    :func:`kept_excepthook`."""
    with kept_excepthook():
        yield


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _share(a: np.ndarray, rank: int, size: int) -> np.ndarray:
    """This rank's contiguous slice of a global batch."""
    b = a.shape[0] // size
    return a[rank * b:(rank + 1) * b]


def _state(inputs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items()
            if k.startswith(prefix)}


# ------------------------------------------------------------- datasets


def datasets_worker(inputs: dict) -> dict:
    comm = create_communicator("naive")
    rank, size = comm.rank, comm.size
    data = list(range(int(inputs["n_items"])))
    out = {}
    for shuffle in (False, True):
        for force in (False, True):
            sd = scatter_dataset(data, comm, shuffle=shuffle,
                                 seed=7 if shuffle else None,
                                 force_equal_length=force)
            out[f"shard/{int(shuffle)}{int(force)}"] = sd.indices
    # seed=None: drawn on rank 0 and broadcast, so the shards still tile
    # one permutation
    drawn = scatter_dataset(data, comm, shuffle=True)
    out["unseeded"] = np.concatenate(
        comm.allgather_obj(drawn.indices.tolist()))
    shard = scatter_dataset(data, comm, shuffle=True, seed=42)
    it = create_synchronized_iterator(shard, int(inputs["batch"]), comm,
                                      seed=1)
    out["sync"] = np.array([b for _ in range(2) for b in it])
    mn = create_multi_node_iterator(data, 4, comm, seed=3)
    out["multi_node"] = np.array([b for b in mn])
    out["bcast"] = np.array(comm.bcast_obj(
        {"v": 10 * rank + 1} if rank == size - 1 else None,
        root=size - 1)["v"])
    gathered = comm.gather_obj(rank * 3)
    out["gather"] = np.array(gathered if gathered is not None else [-1])
    out["allgather"] = np.array(comm.allgather_obj(rank * rank))
    red = comm.allreduce_obj({"a": float(rank), "b": [rank, 1]})
    out["allreduce_a"], out["allreduce_b"] = np.array(red["a"]), \
        np.array(red["b"])
    out["host_size"] = np.array(comm.host.size)
    mean = create_multi_node_evaluator(
        lambda: {"acc": float(rank), "n": rank + 1}, comm)()
    total = create_multi_node_evaluator(lambda: {"hits": rank + 1}, comm,
                                        reduce="sum")()
    out["eval_mean"], out["eval_sum"] = np.array(mean["acc"]), \
        np.array(total["hits"])
    bn = MultiNodeBatchNormalization(3, device="cpu")
    bn.running_mean.fill_(float(rank))
    AllreducePersistent(comm)(bn)
    out["persistent"] = _np(bn.running_mean)
    return out


# ------------------------------------------------------------- sync-BN


def sync_bn_worker(inputs: dict) -> dict:
    comm = create_communicator("naive")
    rank, size = comm.rank, comm.size
    out = {}
    for case in ("2d", "4d"):
        x = _share(inputs[f"{case}/x"], rank, size)
        dy = _share(inputs[f"{case}/dy"], rank, size)
        bn = MultiNodeBatchNormalization(x.shape[1], comm, momentum=0.9,
                                         device="cpu")
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(inputs[f"{case}/w"]))
            bn.bias.copy_(torch.from_numpy(inputs[f"{case}/b"]))
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(dy)).sum().backward()
        out.update({f"{case}/y": _np(y), f"{case}/dx": _np(xt.grad),
                    f"{case}/dw": _np(bn.weight.grad),
                    f"{case}/db": _np(bn.bias.grad),
                    f"{case}/mean": _np(bn.running_mean),
                    f"{case}/var": _np(bn.running_var)})
        bn.eval()
        out[f"{case}/y_eval"] = _np(bn(torch.from_numpy(x)))
    return out


# ------------------------------------------------------------- ResNet


def resnet_worker(inputs: dict) -> dict:
    """ResNet18 with sync-BN on this rank's share: fp32 logits, loss,
    gradients (this rank's) and running statistics after one train-mode
    forward; bf16 logits."""
    comm = create_communicator("naive")
    rank, size = comm.rank, comm.size
    x = torch.from_numpy(_share(inputs["x"], rank, size))
    y = torch.from_numpy(_share(inputs["y"], rank, size)).long()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        model = ResNet18(num_classes=10, num_filters=8, compute_dtype=dtype,
                         bn_comm=comm, device="cpu")
        model.load_state_dict(_state(inputs, "sd/"))
        logits = model(x)
        out[f"{tag}/logits"] = _np(logits)
        if dtype == torch.float32:
            loss = F.cross_entropy(logits, y)
            loss.backward()
            out["loss"] = _np(loss)
            for n, p in model.named_parameters():
                out["grad/" + n] = _np(p.grad)
            for n, b in model.named_buffers():
                out["stats/" + n] = _np(b)
    return out


# ------------------------------------------------------- data-parallel steps


def _train(model, comm, opt, batches, loss_fn, rank, size):
    state = create_train_state(model, opt, comm)
    step = make_train_step(loss_fn, opt, comm)
    losses = []
    for batch in batches:
        state, metrics = step(state, tuple(
            torch.from_numpy(_share(b, rank, size)) for b in batch))
        losses.append(float(metrics["loss"]))
    return losses


def mlp_loss(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y.long())


def resnet_loss(model, batch):
    x, y = batch
    return F.cross_entropy(model(x), y.long()), ({}, {})


def dp_training_worker(inputs: dict) -> dict:
    """Three MLP steps on each wire and with double buffering, and the
    ResNet18 sync-BN steps under SGD(0.1) and SGD(0.1, momentum 0.9)."""
    rank = torch.distributed.get_rank()
    size = torch.distributed.get_world_size()
    out = {}
    mlp_batches = [(inputs[f"mlp/x{i}"], inputs[f"mlp/y{i}"])
                   for i in range(3)]
    for case, wire, db in (("fp32", None, False), ("bf16", "bfloat16", False),
                           ("db", None, True)):
        comm = create_communicator("naive", allreduce_grad_dtype=wire)
        model = MLP(n_units=32, n_out=10, in_features=16, device="cpu")
        model.load_state_dict(_state(inputs, "mlp/sd/"))
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            comm, double_buffering=db)
        out[f"mlp/{case}/losses"] = np.array(_train(
            model, comm, opt, mlp_batches, mlp_loss, rank, size))
        for n, p in model.named_parameters():
            out[f"mlp/{case}/{n}"] = _np(p)
    rn_batches = [(inputs[f"rn/x{i}"], inputs[f"rn/y{i}"]) for i in range(2)]
    comm = create_communicator("naive")
    for case, momentum, steps in (("sgd", 0.0, 1), ("momentum", 0.9, 2)):
        model = ResNet18(num_classes=10, num_filters=8,
                         compute_dtype=torch.float32, bn_comm=comm,
                         device="cpu")
        model.load_state_dict(_state(inputs, "rn/sd/"))
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=momentum),
            comm)
        out[f"rn/{case}/losses"] = np.array(_train(
            model, comm, opt, rn_batches[:steps], resnet_loss, rank, size))
        for n, t in model.state_dict().items():
            out[f"rn/{case}/{n}"] = _np(t)
    # the Trainer over the synchronized iterator: each rank's loss is
    # the rank-mean, so all ranks log the same values
    comm = create_communicator("naive")
    model = MLP(n_units=32, n_out=10, in_features=16, device="cpu")
    model.load_state_dict(_state(inputs, "mlp/sd/"))
    opt = create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.05), comm)
    data = scatter_dataset(list(zip(inputs["mlp/x0"], inputs["mlp/y0"])),
                           comm)
    trainer = Trainer(make_train_step(mlp_loss, opt, comm),
                      create_train_state(model, opt, comm),
                      create_synchronized_iterator(data, 2, comm, seed=0),
                      comm, log_interval=1, out=io.StringIO())
    seen = []
    trainer.extend(lambda tr: seen.append(tr.observation["loss"]))
    trainer.run(3)
    out["trainer/losses"] = np.array(seen)
    return out


# ------------------------------------------------------- example twins


def examples_worker(inputs: dict) -> dict:
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    from chainermn_tpu_torch.examples.mnist import train_mnist

    final = train_mnist.main(["--device", "cpu", "--batchsize",
                              str(int(inputs["mnist_batch"])), "--iterations",
                              str(int(inputs["mnist_iterations"]))])
    metrics = train_imagenet.main(
        ["--device", "cpu", "--arch", "resnet18", "--image-size", "32",
         "--batchsize", "2", "--iterations", "3"])
    return {"mnist/val_acc": np.array(final["val_acc"]),
            "mnist/val_loss": np.array(final["val_loss"]),
            "imagenet/loss": _np(metrics["loss"])}


# ------------------------------------------------------- the launcher


def failing_worker(inputs: dict) -> dict:
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()
    return {}


def hanging_worker(inputs: dict) -> dict:
    """Rank 1 never returns."""
    if torch.distributed.get_rank() == 1:
        time.sleep(3600)
    return {"x": inputs["x"] * 2}


# ------------------------------------------------- checkpoint agreement


def checkpoint_worker(inputs: dict) -> dict:
    """Every rank in one shared directory: (1) different iteration sets,
    resumed at the newest common one; (2) no common iteration; (3) rank
    1's async write fails, every rank raises at ``maybe_load``; (4) at 2
    ranks a replicated state is saved at iteration 7, at 4 ranks it is
    restored with ``allow_world_resize=True``."""
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer

    comm = create_communicator("naive")
    rank, size = comm.rank, comm.size
    root = str(inputs["dir"])
    out = {}
    ckpt = create_multi_node_checkpointer("agree", comm, path=root, keep=10)
    state = {"w": torch.full((2,), float(rank))}
    for it in (10, 20, 30, 40):
        if (it == 40 and rank == size - 1) or (it == 30 and rank == 0):
            continue
        ckpt.save(state, it)
    _, out["agree"] = ckpt.maybe_load(state)
    ckpt = create_multi_node_checkpointer("disjoint", comm, path=root)
    ckpt.save(state, 100 + rank)
    restored, it = ckpt.maybe_load(state)
    out["disjoint_none"] = np.array(it is None and restored is state)
    ckpt = create_multi_node_checkpointer("drain", comm, path=root, keep=0)
    if rank == 1:
        ckpt.path = f"{root}/missing/deeper"
    ckpt.save(state, 1, block=False)
    try:
        ckpt.maybe_load(state)
        out["drain_raised"] = np.array("")
    except RuntimeError as e:
        out["drain_raised"] = np.array(str(e))
    resize = create_multi_node_checkpointer("resize", comm,
                                            path=str(inputs["resize_dir"]))
    full = {"w": torch.arange(12.0).reshape(3, 4), "step": 3,
            "opt": {"lr": 0.5, "betas": (0.9, 0.999)}}
    if size == 2:
        resize.save(full, 7)
    else:
        template = {"w": torch.zeros(3, 4), "step": 0,
                    "opt": {"lr": 0.0, "betas": (0.0, 0.0)}}
        got, it = resize.maybe_load(template, allow_world_resize=True)
        out["resize_it"] = np.array(it)
        out["resize_w"] = got["w"].numpy()
        out["resize_ok"] = np.array(got["step"] == 3 and got["opt"] == {
            "lr": 0.5, "betas": (0.9, 0.999)})
    return out


# ------------------------------------- observation aggregator, dcp adapter


def aggregator_dcp_worker(inputs: dict) -> dict:
    """(1) This rank's observations through ``ObservationAggregator`` at
    interval 1 and windowed, then a final partial-window flush; (2) the
    dcp adapter over the ranks: a round trip of a replicated state,
    retention of the newest ``keep`` steps, a resave that overwrites,
    and divergent state refused."""
    import json

    from chainermn_tpu_torch.extensions import (
        ObservationAggregator,
        create_dcp_checkpointer,
    )

    comm = create_communicator("naive")
    rank = comm.rank
    out = {}
    per_rank = json.loads(str(inputs["observations"]))[rank]
    for interval in (1, 3):
        agg = ObservationAggregator(comm, interval=interval)
        got = [agg(obs) for obs in per_rank] + [agg.flush()]
        out[f"agg{interval}"] = np.array(json.dumps(got))
    ckpt = create_dcp_checkpointer("job", comm, path=str(inputs["dir"]),
                                   keep=2)
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 7}
    for it in (1, 2, 3):
        ckpt.save({**state, "step": it}, it, block=it != 2)
    ckpt.wait_async()
    out["kept"] = np.array(ckpt._local_iterations())
    ckpt.save({"w": torch.ones(2, 3), "step": 30}, 3)
    got, it = ckpt.maybe_load({"w": torch.zeros(2, 3), "step": 0})
    out["it"] = np.array(it)
    out["w"] = got["w"].numpy()
    out["step"] = np.array(got["step"])
    try:
        ckpt.save({"w": torch.full((2, 3), float(rank))}, 4)
        out["divergent_refused"] = np.array(False)
    except ValueError as e:
        out["divergent_refused"] = np.array("contract violated" in str(e))
    ckpt.close()
    return out
