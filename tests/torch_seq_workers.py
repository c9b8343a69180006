"""Rank workers of the port's sequence-parallel tests
(``tests/test_torch_sequence_parallel.py``).

``chainermn_tpu_torch.testing.run_distributed`` runs :func:`seq_worker`
in 8 and in 4 spawned gloo processes; each launch runs every case of its
world size on this rank (ring, zigzag, Ulysses, sliding-window attention,
the plan's ring and the data x seq / seq x model plans) and returns flat
``{name: ndarray}`` results. A child imports this module before it runs
anything, so it imports no JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from torch_cross_rank_workers import counted_dist_calls
from torch_plan_workers import _raises, tensor_tree

#: the shape of the JAX tests: T sharded 8 ways -> T_local 4
B, T, H, D = 2, 32, 8, 16
#: the TransformerLM of tests/test_sequence_parallel.py::TestSeqPlanAxis
LM_KW = dict(vocab_size=32, num_layers=2, num_heads=4, d_model=16, d_ff=32,
             max_len=64, compute_dtype=torch.float32, pos_encoding="rope",
             return_hidden=True)
LR = 0.1


def _t(inputs, name, grad=True):
    t = torch.from_numpy(np.array(inputs[name]))
    return t.requires_grad_() if grad and t.is_floating_point() else t


def _global_case(out, name, fn, q, k, v, *extra, grad=True):
    """``fn`` over global tensors that every rank holds: the output and,
    with ``grad``, the gradients of ``(out ** 2).sum()``."""
    o = fn(q, k, v, *extra)
    out[f"{name}/out"] = o.detach().float().numpy()
    out[f"{name}/dtype"] = np.array(str(o.dtype))
    if grad:
        dq, dk, dv = torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))
        for key, g in zip(("dq", "dk", "dv"), (dq, dk, dv)):
            out[f"{name}/{key}"] = g.numpy()


def _local_case(out, name, fn, q, k, v, r, n, *, grad=True, seg=None):
    """``fn`` on this rank's contiguous shard: the local output and the
    local gradients of ``(o ** 2).sum()`` (the sum over the ranks'
    losses), and the transfers of the forward and of the backward."""
    t = q.shape[1] // n
    ql, kl, vl = (x.detach()[:, r * t:(r + 1) * t].clone().requires_grad_()
                  for x in (q, k, v))
    kw = {} if seg is None else {"segment_ids": seg[:, r * t:(r + 1) * t]}
    with counted_dist_calls(("batch_isend_irecv",)) as fwd:
        o = fn(ql, kl, vl, **kw)
    out[f"{name}/out"] = o.detach().numpy()
    out[f"{name}/fwd_transfers"] = np.array(fwd["batch_isend_irecv"])
    if grad:
        with counted_dist_calls(("batch_isend_irecv",)) as bwd:
            g = torch.autograd.grad((o ** 2).sum(), (ql, kl, vl))
        out[f"{name}/bwd_transfers"] = np.array(bwd["batch_isend_irecv"])
        for key, gi in zip(("dq", "dk", "dv"), g):
            out[f"{name}/{key}"] = gi.numpy()


def _attention_cases(inputs, out, n, r):
    from chainermn_tpu_torch.ops.attention import blockwise_attention
    from chainermn_tpu_torch.parallel import ring_attention as ra
    from chainermn_tpu_torch.parallel.local_attention import (
        sliding_window_attention_local,
    )
    from chainermn_tpu_torch.parallel.ulysses import (
        make_ulysses_attention,
        ulysses_attention_local,
    )

    def qkv(name, grad=True):
        return [_t(inputs, f"{name}/{x}", grad) for x in "qkv"]

    seg = _t(inputs, "seg", False)
    seg_u = _t(inputs, "seg_u", False)
    seg_w = _t(inputs, "seg_w", False)

    # ring: both impls, causal and not; zigzag; segments; GQA; bf16
    for impl in ("einsum", "flash"):
        for causal in (False, True):
            fn = ra.make_ring_attention(causal=causal, impl=impl)
            _global_case(out, f"ring/{impl}/{int(causal)}", fn, *qkv("a"),
                         grad=causal)
    _global_case(out, "ring_seg/contiguous", ra.make_ring_attention(
        causal=True, with_segments=True), *qkv("a"), seg)
    _global_case(out, "ring_gqa/contiguous", ra.make_ring_attention(
        causal=True), *qkv("gqa"))
    _global_case(out, "ring_bf16", ra.make_ring_attention(),
                 *[x.detach().bfloat16() for x in qkv("a", False)],
                 grad=False)

    # Ulysses
    for causal in (False, True):
        _global_case(out, f"uly/{int(causal)}", make_ulysses_attention(
            causal=causal), *qkv("a"), grad=causal)
    six = torch.zeros(B, T, 6, D)
    out["uly/reject_heads"] = np.array(_raises(
        lambda: make_ulysses_attention()(six, six, six), ValueError,
        "not divisible") and _raises(
        lambda: make_ulysses_attention()(six, six, six), ValueError,
        f"heads 6 not divisible by axis 'seq' size {n}"))
    _global_case(out, "uly_seg", make_ulysses_attention(
        causal=True, with_segments=True), *qkv("a"), seg_u)
    _global_case(out, "uly_gqa", make_ulysses_attention(causal=True),
                 *qkv("ugqa"))
    q16 = _t(inputs, "ugqa/q", False)
    k2 = torch.zeros(B, T, 2, D)
    out["uly/reject_kv"] = np.array(_raises(
        lambda: make_ulysses_attention(causal=True)(q16, k2, k2), ValueError,
        "kv heads"))
    _global_case(out, "uly_win", make_ulysses_attention(
        causal=True, window=5), *qkv("a"))
    zq = torch.zeros(B, T // n, H, D)
    out["uly/reject_window_fn"] = np.array(_raises(
        lambda: ulysses_attention_local(zq, zq, zq, causal=True, window=4,
                                        attn_fn=blockwise_attention),
        ValueError, "flash kernel"))

    # sliding window on this rank's shard
    q, k, v = qkv("a")
    for window in (1, 2, 3, 4, 5, 6, 9, 13, T + 5):
        _local_case(out, f"win/{window}", functools.partial(
            sliding_window_attention_local, window=window), q, k, v, r, n)
    _local_case(out, "win_gqa", functools.partial(
        sliding_window_attention_local, window=4), *qkv("gqa"), r, n)
    _local_case(out, "win_seg", functools.partial(
        sliding_window_attention_local, window=4), q, k, v, r, n, seg=seg_w)


def _zigzag_ring_cases(inputs, out, n, r):
    """The zigzag ring and the plan's ring (4 ranks: the zigzag chunks and
    the unrolled ring stay short on the JAX side)."""
    from chainermn_tpu_torch.parallel import ring_attention as ra

    def qkv(name, grad=True):
        return [_t(inputs, f"{name}/{x}", grad) for x in "qkv"]

    seg = _t(inputs, "seg", False)
    q, k, v = qkv("a")
    _global_case(out, "zigzag", ra.make_ring_attention(
        causal=True, layout="zigzag"), *qkv("a"))
    _global_case(out, "ring_seg/zigzag", ra.make_ring_attention(
        causal=True, layout="zigzag", with_segments=True), *qkv("a"), seg)
    _global_case(out, "ring_gqa/zigzag", ra.make_ring_attention(
        causal=True, layout="zigzag"), *qkv("gqa"))
    z = torch.zeros(1, 4, 1, 8)
    out["zigzag/reject"] = np.array([
        _raises(lambda: ra.ring_attention_local(z, z, z, causal=False,
                                                layout="zigzag"),
                ValueError, "zigzag"),
        _raises(lambda: ra.ring_attention_local(z, z, z, causal=True,
                                                impl="einsum",
                                                layout="zigzag"),
                ValueError, "zigzag")])

    # the plan's ring on this rank's shard, and the K1/K2 entries it made
    calls = {"fwd": 0, "bwd": 0}
    keep = ra.flash_block_fwd, ra.flash_block_bwd

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    ra.flash_block_fwd = counted("fwd", keep[0])
    ra.flash_block_bwd = counted("bwd", keep[1])
    try:
        _local_case(out, "seq_ring", ra.seq_ring_attention_local, q, k, v,
                    r, n)
        out["seq_ring/block_calls"] = np.array([calls["fwd"], calls["bwd"]])
    finally:
        ra.flash_block_fwd, ra.flash_block_bwd = keep
    _local_case(out, "seq_ring_gqa", ra.seq_ring_attention_local,
                *qkv("gqa"), r, n)


def _lm_plan_case(inputs, out, name, axes, impl, kv_heads):
    """tests/test_sequence_parallel.py::test_data_seq_plan_values_and_grads
    on this rank: one SGD step of the data x seq plan over the tiny LM,
    the loss, the parameters after it, and the transfers of the forward
    and of the step."""
    from torch.func import functional_call

    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.parallel.plan import ParallelPlan

    plan = ParallelPlan(axes, device="cpu")
    n = plan.axis_size("seq")
    attn_fn, rec = plan.seq_attention(heads=4, kv_heads=kv_heads,
                                      t_local=32 // n, impl=impl)
    out[f"{name}/record"] = np.array(
        rec["winner"] == impl and rec["source"] == "explicit"
        and plan.decisions[-1] == rec
        and plan.describe()["seq_attn_impl"] == impl)
    model = TransformerLM(**LM_KW, num_kv_heads=kv_heads,
                          attention_fn=attn_fn, device="cpu")
    params = tensor_tree(inputs, f"lm{kv_heads or 0}/")
    tokens = torch.from_numpy(inputs["tokens"])
    pos = plan.seq_local_positions(32 // n)

    def loss_fn(p, batch):
        h = functional_call(model, p, (batch,), {"positions": pos})
        return (h.float() ** 2).mean()

    make = functools.partial(torch.optim.SGD, lr=LR)
    state = plan.create_train_state(params, make)
    step = plan.compile_train_step(loss_fn, make, params)
    local = plan.local_batch(tokens)
    calls = ("batch_isend_irecv", "all_to_all_single", "all_reduce")
    zcalls = ("reduce_scatter_tensor", "all_gather_into_tensor")
    with torch.no_grad(), counted_dist_calls(calls) as fwd:
        loss_fn(state.params, local)
    with counted_dist_calls(calls) as total, \
            counted_dist_calls(zcalls) as ztotal:
        state, m = step(state, local)
    out[f"{name}/loss"] = np.array(float(m["loss"]))
    out[f"{name}/fwd_calls"] = np.array([fwd[c] for c in calls])
    out[f"{name}/step_calls"] = np.array([total[c] for c in calls])
    out[f"{name}/zero_calls"] = np.array([ztotal[c] for c in zcalls])
    for k, v in state.params.items():
        out[f"{name}/p/{k}"] = v.detach().numpy().copy()


def _seq_model_case(inputs, out):
    """tests/test_sequence_parallel.py::
    test_seq_model_plan_zero_extra_collectives on this rank: the seq x
    model plan's step, its values, and its calls."""
    from chainermn_tpu_torch.parallel import stack_tp_params, tp_mlp
    from chainermn_tpu_torch.parallel.plan import ParallelPlan
    from chainermn_tpu_torch.parallel.plan_specs import P

    plan = ParallelPlan({"seq": 2, "model": 2}, device="cpu")
    attn_fn, _ = plan.seq_attention(heads=2, t_local=8, impl="ring")
    g_model = plan.group("model")
    d, Hh, Dh = 8, 2, 4
    sm = tensor_tree(inputs, "sm/")
    params = {"wq": sm["wq"], "w1": stack_tp_params(sm["w1"], 2, 1),
              "w2": stack_tp_params(sm["w2"], 2, 0), "b2": torch.zeros(d)}
    specs = {"wq": P(), "w1": P("model"), "w2": P("model"), "b2": P()}

    def loss_fn(p, batch):
        xb, yb = batch
        Bb, Tb, _ = xb.shape
        q = (xb @ p["wq"]).reshape(Bb, Tb, Hh, Dh)
        a = attn_fn(q, q, q, causal=True, scale=Dh ** -0.5)
        o = tp_mlp(a.reshape(Bb * Tb, d), p["w1"], None, p["w2"], p["b2"],
                   group=g_model)
        return ((o.reshape(Bb, Tb, d) - yb) ** 2).mean()

    make = functools.partial(torch.optim.SGD, lr=LR)
    state = plan.create_train_state(params, make, param_specs=specs)
    step = plan.compile_train_step(loss_fn, make, params, param_specs=specs)
    calls = ("batch_isend_irecv", "all_reduce", "all_to_all_single",
             "reduce_scatter_tensor", "all_gather_into_tensor", "all_gather")
    batch = plan.local_batch((sm["x"], torch.zeros(2, 16, d)))
    with counted_dist_calls(calls) as got:
        state, m = step(state, batch)
    out["sm/calls"] = np.array([got[c] for c in calls])
    out["sm/loss"] = np.array(float(m["loss"]))
    for k, v in plan.global_params(state, specs).items():
        out[f"sm/p/{k}"] = v.numpy().copy()


def seq_worker(inputs: dict) -> dict:
    """The cases of this world size (8: ring, Ulysses, the sliding window,
    the ring plans and data x zero x seq; 4: the zigzag ring, the plan's
    ring, the Ulysses plans and seq x model)."""
    import torch.distributed as dist

    n, r = dist.get_world_size(), dist.get_rank()
    out = {}
    if n == 8:
        _attention_cases(inputs, out, n, r)
        for kv in (None, 2):
            _lm_plan_case(inputs, out, f"plan/ring/{kv or 0}",
                          {"data": 2, "seq": 4}, "ring", kv)
        # two dp axes and seq: the step's groups over (data, zero) and
        # (data, zero, seq), made in one order on every rank
        _lm_plan_case(inputs, out, "plan/dzs/ring/0",
                      {"data": 2, "zero": 2, "seq": 2}, "ring", None)
    else:
        _zigzag_ring_cases(inputs, out, n, r)
        for kv in (None, 2):
            _lm_plan_case(inputs, out, f"plan/ulysses/{kv or 0}",
                          {"data": 2, "seq": 2}, "ulysses", kv)
        _seq_model_case(inputs, out)
    return out
