"""Rank workers of the port's composition, cost-model and async-reducer
tests (``tests/test_torch_composition_ranks.py``,
``tests/test_torch_async_host.py``).

Two launches, each shared by the test files through :func:`shared`:
:func:`worker8`, 8 gloo ranks on the 2 x 2 x 2 layout (``hierarchical``
over ``mesh=make_mesh(('a0', 'a1', 'a2'), (2, 2, 2))``, rank ``r`` at
the row-major position ``r``, as device ``r`` of the JAX mesh
``devices[:8].reshape(2, 2, 2)``), and :func:`worker4`, 4 gloo ranks on
the 2 x 2 ``('inter', 'intra')`` layout. A child imports this module
before it runs anything, so it imports no JAX; the test files compute
the JAX package's side on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.parallel import composition as K
from chainermn_tpu_torch.parallel.mesh import make_mesh
from torch_comm_workers import COUNTED, run_once
from torch_cross_rank_workers import counted_dist_calls

AXES3 = ("a0", "a1", "a2")
SIZES3 = {a: 2 for a in AXES3}
#: the dyadic leaves of the reduce_composed cases (elements a rank)
LEAVES = (("w", (40, 8)), ("b", (9,)))
#: the int8 wire's leaf (elements a rank)
INT8_ELEMS = 67
#: the calls the cases count (the wire's, and the ZeRO chain's gather)
CALLS = COUNTED + ("all_gather_into_tensor",)
#: the optimizer and plan problem: 16 rows over the ranks
OPT_ROWS, OPT_STEPS, OPT_LR = 16, 3, 1e-2

_MEMO: dict = {}


def shared(key, compute, tmp_path_factory):
    """:func:`~torch_comm_workers.run_once`, remembered in this process
    too: the test files that share a launch then launch it once in a
    run, with pytest-xdist or without."""
    if key not in _MEMO:
        _MEMO[key] = run_once(key, compute, tmp_path_factory)
    return _MEMO[key]


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def reduction_cases() -> list:
    """Signatures of the reduce_composed cases on the 2 x 2 x 2 mesh:
    every derived composition, sliced (contiguous and zigzag), one whose
    small leaf degrades below its slice count, an expanded spelling, and
    merged stages written out of mesh order."""
    two = K.two_level_composition(AXES3)
    derived = K.derive_compositions(AXES3)
    ladder = next(c for c in derived if len(c.stages) == 5)
    out = [c.signature() for c in derived]
    out += [K.sliced_composition(two, s).signature() for s in (2, 4)]
    out += [K.sliced_composition(ladder, 3).signature()]
    out += [K.sliced_composition(two, s, layout="zigzag").signature()
            for s in (2, 4)]
    out += [K.sliced_composition(two, 16).signature()]  # b: 9 slices
    out += [">".join(s.signature() for s in K.expand_slices(
        K.sliced_composition(two, 2)))]
    out += ["rs(a2+a1)>ar(a0)>ag(a2+a1)",
            "rs(a1+a0)>rs(a2)>ag(a2)>ag(a1+a0)"]
    return out


#: the merged scatters of the shard cases: each axis set in mesh order
#: and written out of it
SHARD_CASES = (("a1", "a2"), ("a2", "a1"), ("a0", "a1"), ("a1", "a0"),
               ("a0", "a1", "a2"), ("a2", "a0", "a1"))

#: the sharded-update compositions whose prefix and suffix run around an
#: identity update: the gather must put back what the scatter cut
SPLIT_CASES = ("rs(a2)>ar(a0+a1)>su>ag(a2)", "rs(a2+a1)>ar(a0)>su>ag(a2+a1)")

#: the broadcast cases (op='sum': each member gets the root's buffer)
BROADCAST_CASES = ("bc(a0+a1+a2)", "bc(a0+a1+a2)@4", "bc(a0+a1)@4>bc(a2)")


def optimizer_cases() -> list:
    """The optimizer's schedules over 3 steps: every derived composition,
    a sliced and a zigzag spelling, and ``'zero'``."""
    two = K.two_level_composition(AXES3)
    return ([c.signature() for c in K.derive_compositions(AXES3)]
            + [K.sliced_composition(two, 4).signature(),
               K.sliced_composition(two, 3, layout="zigzag").signature(),
               "zero"])


def int8_cases() -> list:
    """The int8 wire's renderings: flat and two_level, sliced 4 ways
    contiguous and zigzag."""
    out = []
    for name in ("flat", "two_level"):
        base = K.compile_schedule(name, AXES3)
        out += [name, K.sliced_composition(base, 4).signature(),
                K.sliced_composition(base, 4, layout="zigzag").signature()]
    return out


def _counts(calls) -> np.ndarray:
    return np.array([calls[k] for k in CALLS])


def _raises(fn, exc, text) -> np.ndarray:
    try:
        fn()
    except exc as e:
        return np.array(text in str(e))
    return np.array(False)


def _ce_loss(w, b, x, y):
    return torch.nn.functional.cross_entropy(x @ w + b, y)


def _mse(w, x, y):
    return ((x @ w - y) ** 2).mean()


# ---------------------------------------------------------------------------
# 8 ranks, 2 x 2 x 2
# ---------------------------------------------------------------------------

def worker8(inputs):
    from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.parallel.reduction_schedule import reduce_tree

    r = dist.get_rank()
    out = {}
    mesh = make_mesh(AXES3, (2, 2, 2), device="cpu")
    comm = create_communicator("hierarchical", backend="gloo", device="cpu",
                               mesh=mesh)
    out["topo"] = np.array([comm.inter_rank, comm.inter_size,
                            comm.intra_rank, comm.intra_size])
    out["axis_names"] = np.array(comm.axis_names)

    # reduce_composed on every case, mean, calls counted leaf by leaf
    for sig in reduction_cases() + list(BROADCAST_CASES):
        comp = K.compile_schedule(sig, comm.axis_names)
        op = "sum" if sig.startswith("bc") else "mean"
        for name, _ in LEAVES:
            x = torch.from_numpy(inputs[f"x/{name}"][r])
            with counted_dist_calls(CALLS) as calls:
                y = K.reduce_composed(x, comp, comm, op=op)
            out[f"rc/{sig}/{name}"] = _np(y)
            out[f"calls/{sig}/{name}"] = _counts(calls)
    # the summed shard a rank holds after a merged scatter (the chunk a
    # sharded update would own)
    for axes in SHARD_CASES:
        stage = K.Stage("reduce_scatter", axes)
        for name, _ in LEAVES:
            x = torch.from_numpy(inputs[f"x/{name}"][r])
            out[f"shard/{'+'.join(axes)}/{name}"] = _np(
                K.run_reduce_prefix(x, [stage], comm, total=1))
    # run_reduce_prefix > run_gather_suffix around an identity update
    for sig in SPLIT_CASES:
        prefix, suffix = K.parse_signature(sig).split_update()
        for name, _ in LEAVES:
            x = torch.from_numpy(inputs[f"x/{name}"][r])
            chunk = K.run_reduce_prefix(x, prefix, comm, total=8)
            out[f"split/{sig}/{name}"] = _np(K.run_gather_suffix(
                chunk, x, suffix, prefix, comm))
    # the menu names and their signatures are one program
    grads = [torch.from_numpy(inputs[f"x/{n}"][r]) for n, _ in LEAVES]
    for name in ("flat", "two_level"):
        for spell in (name, K.signature_for(name, 3)):
            with counted_dist_calls(CALLS) as calls:
                got = reduce_tree(grads, schedule=spell, axes=comm)
            for (leaf, _), g in zip(LEAVES, got):
                out[f"rt/{spell}/{leaf}"] = _np(g)
            out[f"rtcalls/{spell}"] = _counts(calls)

    # the int8 wire's sliced renderings, and its refusal
    x8 = torch.from_numpy(inputs["int8/x"][r])
    for sig in int8_cases():
        with counted_dist_calls(CALLS) as calls:
            (got,) = reduce_tree([x8], schedule=sig, axes=comm,
                                 compress_dtype=torch.int8)
        out[f"int8/{sig}"] = _np(got)
        out[f"int8calls/{sig}"] = _counts(calls)
    ladder = K.derive_compositions(AXES3)[0].signature()
    out["refuse/int8_ladder"] = _raises(
        lambda: reduce_tree([x8], schedule=ladder, axes=comm,
                            compress_dtype=torch.int8), ValueError,
        "int8 two-phase wire")
    out["refuse/int8_ladder_sliced"] = _raises(
        lambda: reduce_tree(
            [x8], schedule=K.sliced_composition(
                K.parse_signature(ladder), 2).signature(), axes=comm,
            compress_dtype=torch.int8), ValueError, "int8 two-phase wire")

    # MultiNodeOptimizer, Adam 1e-2, this rank's rows of one batch
    rows = OPT_ROWS // 8
    x = torch.from_numpy(inputs["opt/x"][r * rows:(r + 1) * rows])
    y = torch.from_numpy(inputs["opt/y"][r * rows:(r + 1) * rows]).long()
    for sched in optimizer_cases():
        w = torch.from_numpy(inputs["opt/w"]).clone().requires_grad_()
        b = torch.from_numpy(inputs["opt/b"]).clone().requires_grad_()
        opt = create_multi_node_optimizer(
            torch.optim.Adam([w, b], lr=OPT_LR), comm,
            reduction_schedule=sched)
        for s in range(OPT_STEPS):
            opt.zero_grad()
            loss = _ce_loss(w, b, x, y)
            loss.backward()
            with counted_dist_calls(CALLS) as calls:
                opt.step()
            out[f"opt/{sched}/loss{s}"] = np.array(float(loss))
        out[f"opt/{sched}/w"] = _np(w)
        out[f"opt/{sched}/b"] = _np(b)
        out[f"opt/{sched}/calls"] = _counts(calls)

    # refusals at construction
    sgd = torch.optim.SGD([torch.zeros(3, requires_grad=True)], lr=0.1)
    out["refuse/su"] = _raises(lambda: create_multi_node_optimizer(
        sgd, comm, reduction_schedule="rs(a0+a1+a2)>su>ag(a0+a1+a2)"),
        ValueError, "sharded_update")
    out["refuse/unreduced"] = _raises(lambda: create_multi_node_optimizer(
        sgd, comm, reduction_schedule="rs(a2)>ag(a2)"), ValueError,
        "reduction_schedule")
    out["refuse/foreign"] = _raises(lambda: create_multi_node_optimizer(
        sgd, comm, reduction_schedule="ar(inter+intra)"), ValueError,
        "neither on the mesh")
    out["refuse/ef"] = _raises(lambda: create_multi_node_optimizer(
        sgd, comm, reduction_schedule=ladder, allreduce_grad_dtype="int8",
        error_feedback=True), ValueError, "error_feedback")
    out["refuse/int8_opt"] = _raises(lambda: create_multi_node_optimizer(
        sgd, comm, reduction_schedule=ladder, allreduce_grad_dtype="int8"),
        ValueError, "int8 two-phase wire")
    out["refuse/zero_tree"] = _raises(lambda: reduce_tree(
        [x8], schedule="zero", axes=comm), ValueError, "('flat', "
        "'two_level')")
    out["refuse/ring"] = _raises(lambda: reduce_tree(
        [x8], schedule="ring", axes=comm), ValueError, "unknown schedule")

    # the plan's grad_reduction=
    px = torch.from_numpy(inputs["plan/x"])
    py = torch.from_numpy(inputs["plan/y"])
    pw = torch.from_numpy(inputs["plan/w"])

    def plan_run(axes, grad_reduction, make_inner, tag):
        plan = ParallelPlan(axes, device="cpu",
                            grad_reduction=grad_reduction)
        params = {"w": pw}
        state = plan.create_train_state(params, make_inner)
        step = plan.compile_train_step(lambda p, bt: _mse(p["w"], *bt),
                                       make_inner, params)
        batch = plan.local_batch((px, py))
        with counted_dist_calls(CALLS) as calls:
            state, m = step(state, batch)
        state, m = step(state, batch)
        out[f"plan/{tag}/w"] = _np(plan.global_params(state)["w"])
        out[f"plan/{tag}/loss"] = np.array(float(m["loss"]))
        out[f"plan/{tag}/calls"] = _counts(calls)
        d = plan.describe()
        out[f"plan/{tag}/describe"] = np.array(repr((
            d.get("grad_reduction"), d["collectives"])))

    def adam(ps):
        return torch.optim.Adam(ps, lr=OPT_LR)

    def sgd5(ps):
        return torch.optim.SGD(ps, lr=0.5)

    for tag, axes, gr, inner in (
            ("dp/base", {"data": 8}, None, adam),
            ("dp/flat", {"data": 8}, "flat", adam),
            ("dp/ar", {"data": 8}, "ar(data)", adam),
            ("dp/rsag", {"data": 8}, "rs(a0)>ag(a0)", sgd5),
            ("dp/rsag_base", {"data": 8}, None, sgd5),
            ("dpz/base", {"data": 2, "zero": 4}, None, adam),
            ("dpz/ladder", {"data": 2, "zero": 4},
             "rs(a1)>rs(a0)>ag(a0)>ag(a1)", adam),
            ("dpz/sliced", {"data": 2, "zero": 4},
             "rs(a1)[s0..1]>rs(a0)>ag(a0)>ag(a1)", adam)):
        plan_run(axes, gr, inner, tag)
    out["plan/refuse/zero"] = _raises(lambda: ParallelPlan(
        {"data": 8}, device="cpu", grad_reduction="zero"), ValueError,
        "sharded_update")
    out["plan/refuse/no_dp"] = _raises(lambda: ParallelPlan(
        {"model": 8}, device="cpu", grad_reduction="flat"), ValueError,
        "needs a data-parallel")
    out["plan/refuse/unreduced"] = _raises(lambda: ParallelPlan(
        {"data": 2, "zero": 4}, device="cpu",
        grad_reduction="rs(zero)>ag(zero)"), K.CompositionError,
        "never reduced")
    out["plan/refuse/zsg"] = _raises(lambda: ParallelPlan(
        {"zero": 4, "model": 2}, device="cpu", zero_stacked_groups=True,
        grad_reduction="flat"), ValueError, "mutually exclusive")
    return out


# ---------------------------------------------------------------------------
# 4 ranks, 2 x 2
# ---------------------------------------------------------------------------

#: the async reducer's steps
ASYNC_STEPS = 5
#: MeasuredComposedReducer's schedules on the 2 x 2 layout
MEASURED_CASES = ("two_level", "rs(intra)[s0..2]>ar(inter)>ag(intra)",
                  "rs(inter+intra)[z0..1]>ag(inter+intra)")


def worker4(inputs):
    from chainermn_tpu_torch.parallel.async_host import (
        AsyncHostGradReducer,
    )
    from chainermn_tpu_torch.parallel.cost_model import calibrate
    from chainermn_tpu_torch.parallel.reduction_schedule import (
        MeasuredComposedReducer,
        reduce_tree,
    )

    r = dist.get_rank()
    out = {}
    mesh = make_mesh(("inter", "intra"), (2, 2), device="cpu")
    comm = create_communicator("two_dimensional", backend="gloo",
                               device="cpu", mesh=mesh)
    grads = [torch.from_numpy(inputs[f"x/{n}"][r]) for n, _ in LEAVES]
    for sig in MEASURED_CASES:
        red = MeasuredComposedReducer(comm, schedule=sig)
        with counted_dist_calls(CALLS) as calls:
            got = red.reduce(grads)
        for (leaf, _), g in zip(LEAVES, got):
            out[f"measured/{sig}/{leaf}"] = _np(g)
        out[f"measured/{sig}/calls"] = _counts(calls)
        out[f"measured/{sig}/stages"] = np.array(
            [f"{s['stage']}|{s['op']}|{s['nbytes']}|{s.get('slice', -1)}"
             for s in red.stages])
        out[f"measured/{sig}/dur_ok"] = np.array(
            all(s["dur_s"] >= 0 for s in red.stages))
    flat = reduce_tree(grads, schedule="flat", axes=comm)
    for (leaf, _), g in zip(LEAVES, flat):
        out[f"flat/{leaf}"] = _np(g)
    out["measured/refuse_su"] = _raises(
        lambda: MeasuredComposedReducer(comm, schedule="zero"),
        K.CompositionError, "sharded_update")

    model = calibrate(comm, payload_mb=1 / 64, repeats=3)
    out["cal/shape"] = np.array(model.world_shape)
    out["cal/coeffs"] = np.array(model.alphas + model.betas)
    out["cal/rows"] = np.array(model.fit_rows)
    out["cal/source"] = np.array(model.source)
    out["cal/repeats_refused"] = _raises(
        lambda: calibrate(comm, repeats=2), ValueError, ">= 3")

    # the staleness-1 loop over the host plane against reduce_sync
    red = AsyncHostGradReducer(comm)
    for s in range(ASYNC_STEPS):
        g = [torch.from_numpy(inputs[f"async/{k}"][s, r]) for k in "uv"]
        stale = red.exchange(g)
        out[f"async/in_flight{s}"] = np.array(red.in_flight)
        if stale is None:
            out[f"async/none{s}"] = np.array(True)
        else:
            for k, t in zip("uv", stale):
                out[f"async/stale{s}/{k}"] = _np(t)
        # the reduction in flight owns the group: nothing else runs here
    for k, t in zip("uv", red.flush()):
        out[f"async/flush/{k}"] = _np(t)
    out["async/drained"] = np.array(not red.in_flight)
    for s in range(ASYNC_STEPS):
        g = [torch.from_numpy(inputs[f"async/{k}"][s, r]) for k in "uv"]
        for k, t in zip("uv", red.reduce_sync(g)):
            out[f"async/sync{s}/{k}"] = _np(t)
    total = AsyncHostGradReducer(comm, average=False).reduce_sync(
        [torch.from_numpy(inputs["async/u"][0, r])])
    out["async/sum0"] = _np(total[0])
    return out


def launch8(inputs, tmp_path_factory):
    from chainermn_tpu_torch.testing import run_distributed

    return shared("composition_worker8", lambda: run_distributed(
        worker8, 8, inputs, timeout=400), tmp_path_factory)


def launch4(inputs, tmp_path_factory):
    from chainermn_tpu_torch.testing import run_distributed

    return shared("composition_worker4", lambda: run_distributed(
        worker4, 4, inputs, timeout=300), tmp_path_factory)


def inputs8() -> dict:
    """The 8-rank launch's inputs, from fixed seeds: dyadic leaves (small
    integers over 8, exact in every sum), the int8 leaf, the optimizer's
    and the plan's problems."""
    rs = np.random.RandomState(11)
    out = {f"x/{n}": (rs.randint(-16, 16, (8,) + shape) / 8.0).astype(
        np.float32) for n, shape in LEAVES}
    out["int8/x"] = rs.randn(8, INT8_ELEMS).astype(np.float32)
    out["opt/w"] = rs.randn(5, 3).astype(np.float32)
    out["opt/b"] = rs.randn(3).astype(np.float32)
    out["opt/x"] = rs.randn(OPT_ROWS, 5).astype(np.float32)
    out["opt/y"] = (np.arange(OPT_ROWS) % 3).astype(np.int32)
    out["plan/w"] = (rs.randint(-8, 8, (8, 8)) / 8.0).astype(np.float32)
    out["plan/x"] = (rs.randint(-8, 8, (16, 8)) / 8.0).astype(np.float32)
    out["plan/y"] = (rs.randint(-8, 8, (16, 8)) / 8.0).astype(np.float32)
    return out


def inputs4() -> dict:
    """The 4-rank launch's inputs: dyadic leaves and the async loop's
    gradients (not dyadic: the sums' order is what is held)."""
    rs = np.random.RandomState(12)
    out = {f"x/{n}": (rs.randint(-16, 16, (4,) + shape) / 8.0).astype(
        np.float32) for n, shape in LEAVES}
    out["async/u"] = rs.randn(ASYNC_STEPS, 4, 6, 5).astype(np.float32)
    out["async/v"] = rs.randn(ASYNC_STEPS, 4, 7).astype(np.float32)
    return out


__all__ = ["AXES3", "ASYNC_STEPS", "BROADCAST_CASES", "LEAVES",
           "MEASURED_CASES", "inputs4", "inputs8", "int8_cases", "launch4",
           "launch8", "optimizer_cases", "reduction_cases", "shared",
           "worker4", "worker8"]

