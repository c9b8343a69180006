"""Rank workers of the port's communicator, wire, reduction-schedule,
error-feedback and local-SGD tests (``tests/test_torch_topology_comm.py``,
``test_torch_wires.py``, ``test_torch_reduction_schedule.py``,
``test_torch_error_feedback.py``, ``test_torch_local_sgd.py``).

``chainermn_tpu_torch.testing.run_distributed`` runs each worker in
``size`` spawned gloo processes; a child imports this module before it
runs anything, so it imports no JAX. Each worker runs every case of its
test file in one launch and returns flat ``{name: ndarray}`` results;
the test files compute the JAX package's side on the CPU mesh. The
2 x 2 layout is ``make_mesh(('inter', 'intra'), (2, 2))``: rank ``r`` at
``(r // 2, r % 2)``, as device ``r`` of the JAX mesh
``devices[:4].reshape(2, 2)``.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import ANY_SOURCE, create_communicator
from chainermn_tpu_torch.parallel import collectives as C
from chainermn_tpu_torch.parallel.mesh import make_mesh
from torch_cross_rank_workers import counted_dist_calls

#: the ``torch.distributed`` calls the wire cases count, in this order
COUNTED = ("all_reduce", "reduce_scatter_tensor", "all_gather",
           "all_to_all_single", "batch_isend_irecv")
#: the topology names the CPU tests create, over gloo
TOPOLOGY = ("hierarchical", "two_dimensional", "single_node",
            "non_cuda_aware")


def run_once(key: str, compute, tmp_path_factory, timeout: float = 600.0):
    """``compute()`` once per test run: under pytest-xdist every worker
    that runs a test of a module builds its module fixtures, so the first
    worker to ask for ``key`` launches the ranks and leaves the results
    (or its error) in the directory the workers' temporary directories
    share (pytest keeps and removes it with them), and the others load
    them. Without xdist, ``compute()``."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    path = str(tmp_path_factory.getbasetemp().parent / (key + ".pkl"))
    try:
        os.close(os.open(path + ".lock", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{key}: no result after {timeout} s")
            time.sleep(0.2)
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        if not ok:
            raise RuntimeError(f"{key} failed in another worker:\n{value}")
        return value
    try:
        value, ok = compute(), True
    except Exception as e:  # the waiting workers get the error too
        value, ok = f"{type(e).__name__}: {e}", False
    with open(path + ".tmp", "wb") as f:
        pickle.dump((ok, value), f)
    os.replace(path + ".tmp", path)
    if not ok:
        raise RuntimeError(value)
    return value


def shared_launch(key: str, tmp_path_factory, worker, size: int,
                  inputs=None, **kw):
    """``run_distributed(worker, size, inputs, **kw)`` once per test run
    (:func:`run_once`): under pytest-xdist the workers that run a
    module's tests share one launch of its ranks instead of each making
    its own."""
    from chainermn_tpu_torch.testing import run_distributed

    return run_once(key, lambda: run_distributed(worker, size, inputs, **kw),
                    tmp_path_factory)


def comm_2x2(name="two_dimensional", **kw):
    """A topology communicator over gloo on the 2 x 2 layout."""
    mesh = make_mesh(("inter", "intra"), (2, 2), device="cpu")
    return create_communicator(name, backend="gloo", device="cpu",
                               mesh=mesh, **kw)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# communicators: names, topology, array and object calls, p2p, split
# ---------------------------------------------------------------------------

def _topology_of(comm):
    return [comm.rank, comm.size, comm.intra_rank, comm.intra_size,
            comm.inter_rank, comm.inter_size]


def topology_worker(inputs):
    r = dist.get_rank()
    out = {}
    naive = create_communicator("naive")
    out["topo/naive"] = _topology_of(naive)
    for name in TOPOLOGY:
        c = create_communicator(name, backend="gloo", device="cpu")
        out[f"topo/{name}"] = _topology_of(c)
        out[f"axes/{name}"] = [C.axes_size(a) for a in c.grad_axes]
        out[f"two_level/{name}"] = c.two_level_axes is not None
    for name in ("xla", "flat", "pure_nccl"):
        try:
            create_communicator(name)
            out[f"nccl_raised/{name}"] = False
        except RuntimeError as e:
            out[f"nccl_raised/{name}"] = "no CUDA device" in str(e)
    c = comm_2x2("hierarchical")
    out["topo/mesh2x2"] = _topology_of(c)
    try:
        create_communicator("two_dimensional", backend="gloo", device="cpu",
                            mesh=make_mesh(("data",), device="cpu"))
        out["two_d_1axis_raised"] = False
    except ValueError:
        out["two_d_1axis_raised"] = True

    # array collectives, this rank's row of the stacked inputs
    x = torch.from_numpy(inputs["x"][r])
    for op in ("sum", "mean", "max", "min"):
        out[f"allreduce/{op}"] = _np(c.allreduce(x, op))
    out["bcast"] = _np(c.bcast(x, root=2))
    out["allgather"] = _np(c.allgather(x))
    out["alltoall"] = _np(c.alltoall(torch.from_numpy(inputs["a2a"][r])))
    out["scatter"] = _np(c.scatter(torch.from_numpy(inputs["sc"][r]), root=1))
    out["scatter_obj"] = c.scatter_obj(
        [f"to{i}" for i in range(4)] if r == 3 else None, root=3) == f"to{r}"
    out["bcast_obj"] = c.bcast_obj({"r": r}, root=1) == {"r": 1}
    out["allreduce_obj"] = c.allreduce_obj({"n": 1, "v": [r, 2]}) == {
        "n": 4, "v": [6, 8]}

    # tagged point to point, exact dtypes
    if r == 1:
        c.send((torch.tensor([2 ** 40 + 1, -3], dtype=torch.int64),
                torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
                np.arange(3, dtype=np.float16), torch.tensor(7.0)), 0, tag=5)
        c.send(np.array([2 ** 50], np.int64), 0, tag=6)
    if r in (1, 2, 3):  # three concurrent senders under one tag
        c.send_obj({"from": r}, 0, tag=9)
    c.send_obj(("self", r), r, tag=4)  # to this rank itself
    c.barrier()
    if r == 0:
        out["probe_before"] = [c.probe(1, 5), c.probe(1, 5), c.probe(3, 5),
                               c.probe(ANY_SOURCE, 9), c.probe(0, 4)]
        got6 = c.recv(1, tag=6)  # tag 6 before tag 5: tags match exactly
        got5 = c.recv(1, tag=5)
        out["p2p/tag6"] = got6.tolist() == [2 ** 50] and got6.dtype == np.int64
        a, b, h, s0 = got5
        out["p2p/int64"] = (a.dtype == torch.int64
                            and a.tolist() == [2 ** 40 + 1, -3])
        out["p2p/bf16"] = (b.dtype == torch.bfloat16
                           and b.float().tolist() == [1.5, -2.25])
        out["p2p/f16"] = h.dtype == np.float16 and h.tolist() == [0, 1, 2]
        out["p2p/0dim"] = s0.shape == () and float(s0) == 7.0
        srcs = sorted(c.recv_any_obj(tag=9)[0] for _ in range(3))
        out["p2p/any_sources"] = srcs
        out["probe_after"] = [c.probe(ANY_SOURCE, 9), c.probe(1, 5)]
    out["p2p/self"] = c.recv_obj(r, tag=4) == ("self", r)

    # split 2 + 2: independent group calls, in opposite orders
    sub = c.split(r // 2)
    if r // 2 == 0:
        got = sub.bcast_obj({"from": r}, root=0)
        total = sub.allreduce_obj({"n": 1})
    else:
        total = sub.allreduce_obj({"n": 1})
        got = sub.bcast_obj({"from": r}, root=0)
    out["split/topo"] = [sub.rank, sub.size]
    out["split/bcast_from"] = got["from"]
    out["split/total"] = total["n"]
    out["split/allreduce"] = _np(sub.allreduce(torch.tensor([float(r)])))
    if r // 2 == 1:  # p2p inside the split, by the group's ranks
        if sub.rank == 0:
            sub.send_obj("hi", 1, tag=1)
        else:
            out["split/p2p"] = sub.recv_obj(0, tag=1) == "hi"
    try:
        c.split(0, key=-r)
        out["split_key_raised"] = False
    except ValueError:
        out["split_key_raised"] = True
    odd = c.sub_communicator([1, 3])
    out["sub/none"] = odd is None
    if odd is not None:
        out["sub/topo"] = [odd.rank, odd.size]
        out["sub/sum"] = _np(odd.allreduce(torch.tensor([float(r)])))
    return out


# ---------------------------------------------------------------------------
# the wires of parallel/collectives.py
# ---------------------------------------------------------------------------

def wire_cases(c, x, res):
    """``name -> result`` of every wire on this rank's ``x`` over the
    2 x 2 communicator ``c`` (inter, intra)."""
    inter, intra = both = c.grad_axes
    flat = x.reshape(-1)
    srs = C.staged_reduce_scatter(flat, both)
    fb_mean, fb_rt = C.int8_allreduce_mean_with_feedback(x, both)
    tl_mean, tl_res = C.int8_two_level_allreduce_mean_with_feedback(
        x, res, intra, inter)
    return {
        "two_level": C.two_level_allreduce(x, intra, inter),
        "two_level_sum": C.two_level_allreduce(x, intra, inter, op="sum"),
        "decomposed": C.decomposed_allreduce(x, both),
        "decomposed_intra": C.decomposed_allreduce(x, (intra,)),
        "staged_rs": srs,
        "staged_rs_intra": C.staged_reduce_scatter(flat, (intra,)),
        "staged_ar": C.staged_allreduce(x, both),
        "staged_ag": C.staged_allgather(srs, both, flat.numel()),
        "int8": C.int8_allreduce_mean(x, both),
        "int8_intra": C.int8_allreduce_mean(x, (intra,)),
        "int8_decomposed": C.int8_decomposed_allreduce_mean(x, both),
        "int8_two_level": C.int8_two_level_allreduce_mean(x, intra, inter),
        "int8_fb_mean": fb_mean, "int8_fb_rt": fb_rt,
        "int8_tl_fb_mean": tl_mean, "int8_tl_fb_res": tl_res,
        "bcast_intra_root1": C.staged_broadcast(x, (intra,), root=1),
    }


def wires_worker(inputs):
    r = dist.get_rank()
    c = comm_2x2()
    inter, intra = c.grad_axes
    out = {"axes_size": C.axes_size(c.grad_axes),
           "axes_index": C.axes_index(c.grad_axes),
           "axes_index_intra": C.axes_index((intra,))}
    x = torch.from_numpy(inputs["x"][r])
    res = torch.from_numpy(inputs["res"][r])
    both = c.grad_axes
    cases = {**wire_cases(c, x, res),
             "bcast_r2_root2": C.staged_broadcast(x, both, radix=2, root=2),
             "bcast_r3_root1": C.staged_broadcast(x, both, radix=3, root=1)}
    for k, v in cases.items():
        out[k] = _np(v)
    # the merged collectives over the axes without their product raise
    plain = (inter, intra)
    for name, fn in (
            ("staged_ar", lambda: C.staged_allreduce(x, plain)),
            ("staged_rs", lambda: C.staged_reduce_scatter(x, plain)),
            ("int8", lambda: C.int8_allreduce_mean(x, plain)),
            ("bcast", lambda: C.staged_broadcast(x, plain))):
        try:
            fn()
            out[f"plain_raised/{name}"] = False
        except ValueError as e:
            out[f"plain_raised/{name}"] = "product group" in str(e)
    # how many calls each wire makes (the product path)
    for name, fn in (
            ("int8", lambda: C.int8_allreduce_mean(x, c.grad_axes)),
            ("two_level", lambda: C.two_level_allreduce(x, intra, inter)),
            ("bcast_r2", lambda: C.staged_broadcast(x, c.grad_axes)),
            ("int8_two_level",
             lambda: C.int8_two_level_allreduce_mean(x, intra, inter))):
        with counted_dist_calls(COUNTED) as calls:
            fn()
        out[f"count/{name}"] = [calls[k] for k in COUNTED]
    # straight-through gradients: the exact mean of the cotangents
    ct = torch.from_numpy(inputs["ct"][r])
    for name, fn in (("int8", lambda v: C.int8_allreduce_mean(v, both)),
                     ("int8_two_level",
                      lambda v: C.int8_two_level_allreduce_mean(
                          v, intra, inter)),
                     ("two_level", lambda v: C.two_level_allreduce(
                         v, intra, inter))):
        v = x.clone().requires_grad_()
        (fn(v) * ct).sum().backward()
        out[f"grad/{name}"] = _np(v.grad)
    # stage 1's codes on this rank's rows
    q, scale = C.quantize_int8(C._rows(x.reshape(-1), 4))
    out["codes"] = _np(q).astype(np.int32)
    out["scale"] = float(scale)
    # n == 1: the value itself, unrounded (a one-rank group a rank)
    one = c.split(r)
    out["n1/int8"] = _np(C.int8_allreduce_mean(x, one.group))
    m, rt = C.int8_allreduce_mean_with_feedback(x, one.group)
    out["n1/int8_rt"] = _np(rt)
    m2, res2 = C.int8_two_level_allreduce_mean_with_feedback(
        x, torch.zeros(C.two_level_shard_len(x.numel(), 2)), intra,
        one.group)  # an inter level of one rank rounds nothing
    out["n1/tl_mean"] = _np(m2)
    out["n1/tl_res"] = _np(res2)
    return out


# ---------------------------------------------------------------------------
# reduction schedules, the optimizer's schedules, the overlapped reducer
# ---------------------------------------------------------------------------

#: the gradient leaves of the schedule and error-feedback cases
LEAVES = (("a", (5, 7)), ("b", (3,)), ("c", (0,)), ("d", (11, 3)))
#: a bucket size that splits LEAVES into several buckets
SMALL_BUCKET = 96


def schedule_worker(inputs):
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.parallel.reduction_schedule import (
        OverlappedBucketReducer,
        reduce_tree,
    )

    r = dist.get_rank()
    out = {}
    c = comm_2x2()
    naive = create_communicator("naive")
    grads = [torch.from_numpy(inputs[f"g/{k}"][r]) for k, _ in LEAVES]
    for cname, comm in (("2x2", c), ("flat", naive)):
        for sched in ("flat", "two_level"):
            for wire in (None, "bfloat16", "int8"):
                for bb in (None, SMALL_BUCKET):
                    dt = None if wire is None else getattr(torch, wire)
                    got = reduce_tree(grads, schedule=sched,
                                      axes=comm.grad_axes, compress_dtype=dt,
                                      bucket_bytes=bb)
                    for (k, _), g in zip(LEAVES, got):
                        out[f"rt/{cname}/{sched}/{wire}/{bb}/{k}"] = _np(g)
    red = OverlappedBucketReducer(c, bucket_bytes=SMALL_BUCKET, slices=3)
    n_b = red.dispatch(grads)
    out["overlap/in_flight"] = red.in_flight
    try:
        red.dispatch(grads)
        out["overlap/double_raised"] = False
    except RuntimeError:
        out["overlap/double_raised"] = True
    out["overlap/buckets"] = n_b
    for (k, _), g in zip(LEAVES, red.collect()):
        out[f"overlap/{k}"] = _np(g)

    # the optimizer's schedules: SGD with momentum, 3 steps
    params0 = [torch.from_numpy(inputs[f"p/{k}"]) for k, _ in LEAVES]
    for sched, wire in (("flat", None), ("flat", "int8"),
                        ("two_level", None), ("two_level", "int8"),
                        ("two_level", "bfloat16"), ("zero", None),
                        ("zero", "bfloat16")):
        for cname, comm in (("2x2", c), ("flat", naive)):
            ps = [p.clone().requires_grad_() for p in params0]
            opt = create_multi_node_optimizer(
                torch.optim.SGD(ps, lr=0.1, momentum=0.9), comm,
                allreduce_grad_dtype=wire, reduction_schedule=sched)
            for s in range(3):
                opt.zero_grad()
                for (k, _), p in zip(LEAVES, ps):
                    p.grad = torch.from_numpy(inputs[f"gs/{k}"][s, r]).clone()
                opt.step()
            for (k, _), p in zip(LEAVES, ps):
                out[f"opt/{cname}/{sched}/{wire}/{k}"] = _np(p)

    # the stale-update loop: double buffering against a hand-rolled bank
    steps = inputs["stale"].shape[0]
    p = torch.zeros(6, requires_grad=True)
    opt = create_multi_node_optimizer(torch.optim.SGD([p], lr=1.0), naive,
                                      double_buffering=True)
    bank = torch.zeros(6)
    ref = torch.zeros(6)
    for s in range(steps):
        g = torch.from_numpy(inputs["stale"][s, r])
        p.grad = g.clone()
        opt.step()
        ref = ref - 1.0 * bank
        bank = naive.allreduce(g, "mean")
    out["stale/params"] = _np(p)
    out["stale/ref"] = _np(ref)
    out["stale/bank"] = _np(opt.state_dict()["bank"][0])
    out["stale/last_mean"] = _np(bank)
    return out


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

#: the planted error-feedback faults: what the residual is replaced by
#: before each step
EF_FAULTS = {"nofb": torch.zeros_like, "negfb": torch.neg}


def ef_worker(inputs):
    from chainermn_tpu_torch.extensions import create_multi_node_checkpointer
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.training import TrainState

    r = dist.get_rank()
    out = {}
    comms = {"flat": create_communicator("naive"),
             "hier": comm_2x2("hierarchical"),
             "shard": comm_2x2("two_dimensional")}
    params0 = [torch.from_numpy(inputs[f"p/{k}"]) for k, _ in LEAVES]
    cases = [(cname, bb, None) for cname in comms
             for bb in (None, SMALL_BUCKET)]
    # planted faults, which the tests' comparison must reject: the
    # residual dropped from the next message, or fed back negated
    cases += [(cname, None, fault) for cname in ("flat", "shard")
              for fault in EF_FAULTS]
    for cname, bb, fault in cases:
        tag = f"ef/{cname}/{bb}" + ("" if fault is None else f"/{fault}")
        ps = [p.clone().requires_grad_() for p in params0]
        opt = create_multi_node_optimizer(
            torch.optim.SGD(ps, lr=0.1), comms[cname],
            allreduce_grad_dtype="int8", error_feedback=True)
        if bb is not None:
            opt.bucket_bytes = bb
            opt._residual = opt._init_residual()
        for s in range(3):
            if fault is not None:
                opt._residual = [EF_FAULTS[fault](e) for e in opt._residual]
            for (k, _), p in zip(LEAVES, ps):
                p.grad = torch.from_numpy(inputs[f"gs/{k}"][s, r]).clone()
            opt.step()
            for (k, _), p in zip(LEAVES, ps):
                out[f"{tag}/step{s}/{k}"] = _np(p)
            for i, e in enumerate(opt.state_dict()["residual"]):
                out[f"{tag}/step{s}/res{i}"] = _np(e)
        out[f"{tag}/n_res"] = len(opt.state_dict()["residual"])

    # a resumed run gives each rank its own residual back
    tmp = str(inputs["tmp"])

    def fresh():
        model = torch.nn.Linear(5, 3)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(inputs["lin/w"]))
            model.bias.zero_()
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            comms["shard"], allreduce_grad_dtype="int8", error_feedback=True)
        return TrainState(model=model, optimizer=opt, step=0)

    def train(state, steps):
        for s in steps:
            x = torch.from_numpy(inputs["lin/x"][s, r])
            state.optimizer.zero_grad()
            state.model(x).square().mean().backward()
            state.optimizer.step()
        return state

    st = train(fresh(), range(2))
    ckpt = create_multi_node_checkpointer("ef", comms["shard"],
                                          path=os.path.join(tmp, "ckpt"))
    ckpt.save(st, 2)
    saved_res = [e.clone() for e in st.optimizer.state_dict()["residual"]]
    st = train(st, range(2, 4))
    straight = [p.detach().clone() for p in st.model.parameters()]
    st2, it = ckpt.maybe_load(fresh())
    ckpt.close()
    out["resume/iteration"] = it
    out["resume/res_equal"] = all(torch.equal(a, b) for a, b in zip(
        st2.optimizer.state_dict()["residual"], saved_res))
    out["resume/res0"] = _np(saved_res[0])
    st2 = train(st2, range(2, 4))
    out["resume/params_equal"] = all(torch.equal(a, b.detach()) for a, b in
                                     zip(straight, st2.model.parameters()))
    return out


# ---------------------------------------------------------------------------
# local SGD
# ---------------------------------------------------------------------------

def local_sgd_worker(inputs):
    from chainermn_tpu_torch.optimizers import create_local_sgd

    r = dist.get_rank()
    out = {}
    for cname, comm in (("flat", create_communicator("naive")),
                        ("2x2", comm_2x2("hierarchical"))):
        for label, make, every, steps, olr, om in (
                ("adam3", lambda ps: torch.optim.Adam(ps, lr=0.1), 3, 3,
                 1.0, 0.0),
                ("sgd_outer", lambda ps: torch.optim.SGD(ps, lr=0.5), 2, 6,
                 0.7, 0.9)):
            p = torch.from_numpy(inputs[f"p0/{label}"]).clone()
            p.requires_grad_()
            opt = create_local_sgd(make([p]), comm, sync_every=every,
                                   outer_lr=olr, outer_momentum=om)
            for s in range(steps):
                p.grad = torch.from_numpy(inputs["g"][s % 3, r]).clone()
                opt.step()
                out[f"{cname}/{label}/step{s}"] = _np(p)
            sd = opt.state_dict()
            out[f"{cname}/{label}/anchor"] = _np(sd["anchor"][0])
            out[f"{cname}/{label}/velocity"] = _np(sd["velocity"][0])
            out[f"{cname}/{label}/step"] = sd["step"]
    return out


def twins_worker(inputs):
    """The twins' new flags at a small size over the ranks."""
    from chainermn_tpu_torch.examples.mnist import train_mnist
    from torch_rank_workers import kept_excepthook

    base = ["--device", "cpu", "--iterations", "40", "--batchsize", "64"]
    out = {}
    with kept_excepthook():
        for label, flags in (
                ("local_sgd", ["--local-sgd", "4", "--outer-momentum",
                               "0.5", "--lr", "0.02"]),
                ("two_level", ["--communicator", "two_dimensional",
                               "--reduction-schedule", "two_level"]),
                ("zero", ["--reduction-schedule", "zero"]),
                ("int8_ef", ["--communicator", "two_dimensional",
                             "--allreduce-grad-dtype", "int8",
                             "--error-feedback"])):
            final = train_mnist.main(base + flags)
            out[f"mnist/{label}/val_acc"] = final["val_acc"]
            out[f"mnist/{label}/val_loss"] = final["val_loss"]
    return out

