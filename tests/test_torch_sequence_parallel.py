"""The port's sequence parallelism (``chainermn_tpu_torch.parallel.
ring_attention``, ``.ulysses``, ``.local_attention`` and the plan's ``seq``
axis) against the JAX package's, case for case with
tests/test_sequence_parallel.py, at 8 and 4 gloo ranks
(``tests/torch_seq_workers.py::seq_worker``, one launch a world size)
against the JAX functions on the CPU mesh (the Pallas kernels in
interpret mode, as the JAX tests run them), on the same numpy-seeded
inputs:

- ring attention, both impls, causal and not; zigzag; packed segments
  (contiguous and zigzag); GQA; bf16 inputs with fp32 accumulation; the
  zigzag refusals;
- Ulysses: values and gradients, GQA, the head divisibility (both numbers
  named), segments, the window and its refusal with a custom attn_fn;
- the sliding window narrower than, wider than and covering the shard,
  window 1 with no transfer, GQA, packed segments across a boundary, and
  gradients;
- the plan's ring (``seq_ring_attention_local``): values, gradients, GQA;
- data x seq plans over the TransformerLM (ring and Ulysses, with GQA),
  data x zero x seq (two dp axes beside seq: the step's process groups
  made in one order on every rank) and the seq x model plan: the loss and
  the parameters after one SGD step.

The JAX HLO pins become counts of ``torch.distributed`` calls: the ring
makes ``n - 1`` transfers a layer a forward pass and ``(n - 1) + n`` a
backward; rank ``r`` of the causal contiguous ring calls the block entry
(K1 on the card) ``r + 1`` times; the sliding window makes one transfer a
neighbour distance forward (none at window 1); seq x model adds nothing
beyond the two providers' collectives.

Tolerances: tests/test_sequence_parallel.py's own: values 1e-5 (relative
and absolute), gradients 1e-4, bf16 2e-2; the plans' loss 1e-4 relative
and their SGD deltas 2e-3 relative, 2e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as JP

from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu.parallel.local_attention import (
    sliding_window_attention_local as jax_window_local,
)
from chainermn_tpu.parallel.ring_attention import (
    make_ring_attention as jax_make_ring,
    seq_ring_attention_local as jax_seq_ring_local,
)
from chainermn_tpu.parallel.ulysses import (
    make_ulysses_attention as jax_make_ulysses,
)
from chainermn_tpu_torch.convert import lm_state_from_flax
from torch_comm_workers import shared_launch
from torch_rank_workers import few_threads  # noqa: F401
from torch_seq_workers import B, D, H, LR, T, seq_worker

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
SGD_DELTA = dict(rtol=2e-3, atol=2e-5)
LM_KW = dict(vocab_size=32, num_layers=2, num_heads=4, d_model=16, d_ff=32,
             max_len=64, compute_dtype=jnp.float32, pos_encoding="rope",
             return_hidden=True)


def _mesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("seq",))


def _segments():
    rng = np.random.RandomState(2)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = sorted(rng.choice(np.arange(2, T - 2), 2, replace=False))
        seg[b, cuts[0]:cuts[1]] = 1
        seg[b, cuts[1]:] = 2
    seg_u = np.zeros((B, T), np.int32)
    rng = np.random.RandomState(3)
    for b in range(B):
        seg_u[b, rng.randint(4, T - 4):] = 1
    seg_w = np.zeros((B, T), np.int32)
    seg_w[:, 10:23] = 1  # cuts off the 4-token shard grid
    seg_w[:, 23:] = 2
    return seg, seg_u, seg_w


def _lm_params(kv):
    from chainermn_tpu.models.transformer import TransformerLM

    tok = jnp.zeros((4, 4), jnp.int32)
    return TransformerLM(**LM_KW, num_kv_heads=kv).init(
        jax.random.PRNGKey(4), tok, train=False)["params"]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    inp = {}
    for name, hq, hkv in (("a", H, H), ("gqa", H, 2), ("ugqa", 16, 8)):
        inp[f"{name}/q"] = normal(B, T, hq, D)
        inp[f"{name}/k"] = normal(B, T, hkv, D)
        inp[f"{name}/v"] = normal(B, T, hkv, D)
    inp["seg"], inp["seg_u"], inp["seg_w"] = _segments()
    inp["tokens"] = rng.integers(0, 32, size=(4, 32)).astype(np.int32)
    for kv in (None, 2):
        state = lm_state_from_flax(jax.tree.map(np.asarray, _lm_params(kv)))
        for k, v in state.items():
            inp[f"lm{kv or 0}/{k}"] = v.numpy()
    inp["sm/wq"] = normal(8, 8) * 0.3
    inp["sm/w1"] = normal(8, 8) * 0.3
    inp["sm/w2"] = normal(8, 8) * 0.3
    inp["sm/x"] = normal(2, 16, 8)
    return inp


@pytest.fixture(scope="module")
def ranks8(inputs, tmp_path_factory):
    return shared_launch("seq_worker8", tmp_path_factory, seq_worker, 8,
                         inputs, timeout=300)


@pytest.fixture(scope="module")
def ranks4(inputs, tmp_path_factory):
    return shared_launch("seq_worker4", tmp_path_factory, seq_worker, 4,
                         inputs, timeout=300)


def _qkv(inputs, name):
    return tuple(jnp.asarray(inputs[f"{name}/{x}"]) for x in "qkv")


def _value_and_grads(fwd, q, k, v):
    """``fwd``'s output and the gradients of ``(out ** 2).sum()``, one
    compile."""
    def loss(a, b, c):
        o = fwd(a, b, c)
        return (o.astype(jnp.float32) ** 2).sum(), o

    (_, out), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return out, g


def _jax_global(fn, q, k, v, *extra, grad=True):
    if not grad:
        return fn(q, k, v, *extra), None
    return _value_and_grads(lambda a, b, c: fn(a, b, c, *extra), q, k, v)


def _check_global(ranks, name, out, g):
    for rk in ranks:
        np.testing.assert_allclose(rk[f"{name}/out"], np.asarray(out), **VAL)
        if g is not None:
            for key, gi in zip(("dq", "dk", "dv"), g):
                np.testing.assert_allclose(rk[f"{name}/{key}"],
                                           np.asarray(gi), **GRAD)


def _cat(ranks, key):
    return np.concatenate([rk[key] for rk in ranks], axis=1)


def _jax_local(n, local_fn, q, k, v, seg=None, grad=True):
    """A JAX ``*_local`` function in shard_map over the seq mesh: the
    output and the gradients of the psum of the shards' losses."""
    mesh = _mesh(n)
    s = seg if seg is not None else jnp.zeros((B, q.shape[1]), jnp.int32)

    def fwd(q, k, v):
        return shard_map(lambda a, b, c, d: local_fn(
            a, b, c, None if seg is None else d), mesh=mesh,
            in_specs=(JP(None, "seq"),) * 4, out_specs=JP(None, "seq"),
            check_vma=False)(q, k, v, s)

    if not grad:
        return jax.jit(fwd)(q, k, v), None
    return _value_and_grads(fwd, q, k, v)


def _check_local(ranks, name, out, g):
    np.testing.assert_allclose(_cat(ranks, f"{name}/out"), np.asarray(out),
                               **VAL)
    if g is not None:
        for key, gi in zip(("dq", "dk", "dv"), g):
            np.testing.assert_allclose(_cat(ranks, f"{name}/{key}"),
                                       np.asarray(gi), **GRAD)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(ranks8, inputs, causal, impl):
    fn = jax_make_ring(_mesh(8), "seq", causal=causal, impl=impl)
    out, g = _jax_global(fn, *_qkv(inputs, "a"), grad=causal)
    _check_global(ranks8, f"ring/{impl}/{int(causal)}", out, g)


def test_zigzag_matches_jax(ranks4, inputs):
    fn = jax_make_ring(_mesh(4), "seq", causal=True, layout="zigzag")
    _check_global(ranks4, "zigzag", *_jax_global(fn, *_qkv(inputs, "a")))


def test_zigzag_layout_roundtrip_and_refusals(ranks4):
    import torch

    from chainermn_tpu.parallel.ring_attention import (
        zigzag_indices as jax_zz,
    )
    from chainermn_tpu_torch.parallel.ring_attention import (
        from_zigzag,
        to_zigzag,
        zigzag_indices,
    )

    np.testing.assert_array_equal(zigzag_indices(4, 32), jax_zz(4, 32))
    x = torch.arange(64, dtype=torch.float32).reshape(1, 32, 2)
    assert torch.equal(from_zigzag(to_zigzag(x, 8), 8), x)
    for rk in ranks4:
        assert rk["zigzag/reject"].all()


def _ranks_of(layout, ranks8, ranks4):
    """The zigzag cases run at 4 ranks, the contiguous ones at 8."""
    return ranks4 if layout == "zigzag" else ranks8


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_segment_ids_match_jax(ranks8, ranks4, inputs, layout):
    ranks = _ranks_of(layout, ranks8, ranks4)
    fn = jax_make_ring(_mesh(len(ranks)), "seq", causal=True, layout=layout,
                       with_segments=True)
    out, g = _jax_global(fn, *_qkv(inputs, "a"), jnp.asarray(inputs["seg"]))
    _check_global(ranks, f"ring_seg/{layout}", out, g)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_gqa_matches_jax(ranks8, ranks4, inputs, layout):
    ranks = _ranks_of(layout, ranks8, ranks4)
    fn = jax_make_ring(_mesh(len(ranks)), "seq", causal=True, layout=layout)
    _check_global(ranks, f"ring_gqa/{layout}",
                  *_jax_global(fn, *_qkv(inputs, "gqa")))


def test_ring_bf16_inputs_f32_accumulation(ranks8, inputs):
    fn = jax_make_ring(_mesh(8), "seq")
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(inputs, "a"))
    out = np.asarray(fn(q, k, v), np.float32)
    for rk in ranks8:
        assert str(rk["ring_bf16/dtype"]) == "torch.bfloat16"
        np.testing.assert_allclose(rk["ring_bf16/out"], out, rtol=2e-2,
                                   atol=2e-2)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(ranks8, inputs, causal):
    fn = jax_make_ulysses(_mesh(8), "seq", causal=causal)
    _check_global(ranks8, f"uly/{int(causal)}",
                  *_jax_global(fn, *_qkv(inputs, "a"), grad=causal))


def test_ulysses_head_divisibility_enforced(ranks8):
    for rk in ranks8:
        assert rk["uly/reject_heads"] and rk["uly/reject_kv"]


def test_ulysses_segment_ids_match_jax(ranks8, inputs):
    fn = jax_make_ulysses(_mesh(8), "seq", causal=True, with_segments=True)
    _check_global(ranks8, "uly_seg", *_jax_global(
        fn, *_qkv(inputs, "a"), jnp.asarray(inputs["seg_u"])))


def test_ulysses_gqa_matches_jax(ranks8, inputs):
    fn = jax_make_ulysses(_mesh(8), "seq", causal=True)
    _check_global(ranks8, "uly_gqa", *_jax_global(fn, *_qkv(inputs, "ugqa")))


def test_ulysses_window_matches_jax(ranks8, inputs):
    fn = jax_make_ulysses(_mesh(8), "seq", causal=True, window=5)
    _check_global(ranks8, "uly_win", *_jax_global(fn, *_qkv(inputs, "a")))
    for rk in ranks8:
        assert rk["uly/reject_window_fn"]


# ---------------------------------------------------------------------------
# the sliding window
# ---------------------------------------------------------------------------

def _window_fn(window):
    return lambda q, k, v, s: jax_window_local(
        q, k, v, "seq", window=window, segment_ids=s, block_q=4, block_k=4,
        interpret=True)


@pytest.mark.parametrize("window", [1, 2, 3, 4, 5, 6, 9, 13, T + 5])
def test_sliding_window_matches_jax(ranks8, inputs, window):
    """Narrower than the shard (2-5), wider (6, 9, 13: 2, 2 and 3
    predecessors), covering the whole sequence (T + 5), and window 1,
    which makes no transfer; values and gradients."""
    out, g = _jax_local(8, _window_fn(window), *_qkv(inputs, "a"))
    _check_local(ranks8, f"win/{window}", out, g)
    t_local = T // 8
    m = min(-(-(window - 1) // t_local), 7)
    for rk in ranks8:
        # one transfer a neighbour distance forward; the backward
        # rebuilds the tails and sends each slice's gradient home
        assert int(rk[f"win/{window}/fwd_transfers"]) == m
        assert int(rk[f"win/{window}/bwd_transfers"]) == 2 * m


def test_sliding_window_gqa_matches_jax(ranks8, inputs):
    _check_local(ranks8, "win_gqa",
                 *_jax_local(8, _window_fn(4), *_qkv(inputs, "gqa")))


def test_sliding_window_packed_segments_cross_boundary(ranks8, inputs):
    out, g = _jax_local(8, _window_fn(4), *_qkv(inputs, "a"),
                        seg=jnp.asarray(inputs["seg_w"]))
    _check_local(ranks8, "win_seg", out, g)


def test_window_covering_whole_sequence_is_full_causal(ranks8, inputs):
    q, k, v = _qkv(inputs, "a")
    ref = jax_flash(q, k, v, causal=True, block_q=8, block_k=8,
                    interpret=True)
    np.testing.assert_allclose(_cat(ranks8, f"win/{T + 5}/out"),
                               np.asarray(ref), **VAL)


# ---------------------------------------------------------------------------
# the plan's ring
# ---------------------------------------------------------------------------

def _seq_ring_fn(q, k, v, s):
    return jax_seq_ring_local(q, k, v, "seq", causal=True, block_q=4,
                              block_k=4, interpret=True)


def test_seq_ring_local_matches_jax(ranks4, inputs):
    _check_local(ranks4, "seq_ring",
                 *_jax_local(4, _seq_ring_fn, *_qkv(inputs, "a")))


def test_seq_ring_local_gqa(ranks4, inputs):
    _check_local(ranks4, "seq_ring_gqa",
                 *_jax_local(4, _seq_ring_fn, *_qkv(inputs, "gqa")))


def test_seq_ring_hop_and_block_counts(ranks4):
    """n - 1 transfers forward, (n - 1) + n backward; rank r of the causal
    contiguous ring runs the block forward and backward r + 1 times
    (future blocks launch nothing)."""
    n = len(ranks4)
    for r, rk in enumerate(ranks4):
        assert int(rk["seq_ring/fwd_transfers"]) == n - 1
        assert int(rk["seq_ring/bwd_transfers"]) == (n - 1) + n
        assert rk["seq_ring/block_calls"].tolist() == [r + 1, r + 1]


# ---------------------------------------------------------------------------
# the plan's seq axis
# ---------------------------------------------------------------------------

def _jax_lm_plan(inputs, impl, axes, kv):
    import optax

    from chainermn_tpu.models.transformer import TransformerLM
    from chainermn_tpu.parallel.plan import ParallelPlan

    plan = ParallelPlan(axes, devices=jax.devices("cpu")[
        :int(np.prod(list(axes.values())))])
    seq = axes["seq"]
    attn_fn, _ = plan.seq_attention(heads=4, kv_heads=kv, t_local=32 // seq,
                                    impl=impl)
    model = TransformerLM(**LM_KW, attention_fn=attn_fn, num_kv_heads=kv)
    params = {"params": _lm_params(kv)}
    tok = jnp.asarray(inputs["tokens"])

    def loss(p, batch):
        pos = ParallelPlan.seq_local_positions(batch.shape[1])
        h = model.apply({"params": p["params"]}, batch, positions=pos,
                        train=False)
        return jnp.mean(h.astype(jnp.float32) ** 2)

    state = plan.create_train_state(params, optax.sgd(LR))
    step = plan.compile_train_step(loss, optax.sgd(LR), params)
    state, m = step(state, tok)
    after = lm_state_from_flax(jax.tree.map(np.asarray, jax.device_get(
        state.params)))
    return float(m["loss"]), {k: v.numpy() for k, v in after.items()}


def _check_lm_plan(ranks, inputs, name, impl, axes, kv):
    loss, after = _jax_lm_plan(inputs, impl, axes, kv)
    for rk in ranks:
        assert rk[f"{name}/record"]
        np.testing.assert_allclose(rk[f"{name}/loss"], loss, rtol=1e-4)
        for k, want in after.items():
            p0 = inputs[f"lm{kv or 0}/{k}"]
            np.testing.assert_allclose((p0 - rk[f"{name}/p/{k}"]) / LR,
                                       (p0 - want) / LR, **SGD_DELTA)


@pytest.mark.parametrize("kv", [None, 2])
def test_data_seq_plan_ring_values_and_grads(ranks8, inputs, kv):
    _check_lm_plan(ranks8, inputs, f"plan/ring/{kv or 0}", "ring",
                   {"data": 2, "seq": 4}, kv)


@pytest.mark.parametrize("kv", [None, 2])
def test_data_seq_plan_ulysses_values_and_grads(ranks4, inputs, kv):
    _check_lm_plan(ranks4, inputs, f"plan/ulysses/{kv or 0}", "ulysses",
                   {"data": 2, "seq": 2}, kv)


def test_data_zero_seq_plan_values_and_grads(ranks8, inputs):
    """Two dp axes and ``seq`` ({'data': 2, 'zero': 2, 'seq': 2}): the
    loss and the parameters after one SGD step equal the JAX plan's, and
    the step makes the ring's 3n - 2 transfers a layer, three all-reduces
    (the seq mean of the gradients, the zero chunk's mean over ``data``,
    the metrics) and the zero chain's one reduce-scatter and one
    all-gather."""
    name = "plan/dzs/ring/0"
    _check_lm_plan(ranks8, inputs, name, "ring",
                   {"data": 2, "zero": 2, "seq": 2}, None)
    layers, n = 2, 2
    for rk in ranks8:
        assert rk[f"{name}/step_calls"].tolist() == [layers * (3 * n - 2),
                                                      0, 3]
        assert rk[f"{name}/zero_calls"].tolist() == [1, 1]


def test_data_seq_plan_collective_counts(ranks8, ranks4):
    """Per step of the 2-layer LM: the ring's n - 1 transfers a layer
    forward (3n - 2 a layer with the backward), Ulysses' four all-to-alls
    a layer forward (q, k and v in, the output out; four more backward),
    and three all-reduces (the seq mean of the gradients, the dp mean,
    the metrics)."""
    layers, n = 2, 4
    for kv in (0, 2):
        for rk in ranks8:
            assert rk[f"plan/ring/{kv}/fwd_calls"].tolist() == [
                layers * (n - 1), 0, 0]
            assert rk[f"plan/ring/{kv}/step_calls"].tolist() == [
                layers * (3 * n - 2), 0, 3]
        for rk in ranks4:
            assert rk[f"plan/ulysses/{kv}/fwd_calls"].tolist() == [
                0, layers * 4, 0]
            assert rk[f"plan/ulysses/{kv}/step_calls"].tolist() == [
                0, layers * 8, 3]


def test_seq_model_plan_values_and_zero_extra_collectives(ranks4, inputs):
    """seq x model: the ring's 3n - 2 transfers, the TP pair's forward and
    backward all-reduces, the seq mean of the gradients and the metrics'
    one; no all-to-all, reduce-scatter or all-gather. The loss and the
    parameters after one SGD step equal the JAX plan's."""
    import optax

    from chainermn_tpu.parallel.plan import ParallelPlan
    from chainermn_tpu.parallel.tensor import stack_tp_params, tp_mlp

    plan = ParallelPlan({"seq": 2, "model": 2},
                        devices=jax.devices("cpu")[:4])
    attn_fn, _ = plan.seq_attention(heads=2, t_local=8, impl="ring")
    d, Hh, Dh = 8, 2, 4
    params = {"wq": jnp.asarray(inputs["sm/wq"]),
              "w1": stack_tp_params(jnp.asarray(inputs["sm/w1"]), 2, 1),
              "w2": stack_tp_params(jnp.asarray(inputs["sm/w2"]), 2, 0),
              "b2": jnp.zeros((d,))}
    specs = {"wq": JP(), "w1": JP("model"), "w2": JP("model"), "b2": JP()}

    def loss_fn(p, batch):
        xb, yb = batch
        Bb, Tb, _ = xb.shape
        q = (xb @ p["wq"]).reshape(Bb, Tb, Hh, Dh)
        a = attn_fn(q, q, q, causal=True, scale=Dh ** -0.5)
        out = tp_mlp(a.reshape(Bb * Tb, d), p["w1"], None, p["w2"], p["b2"],
                     axis_name="model")
        return jnp.mean((out.reshape(Bb, Tb, d) - yb) ** 2)

    state = plan.create_train_state(params, optax.sgd(LR), param_specs=specs)
    step = plan.compile_train_step(loss_fn, optax.sgd(LR), params,
                                   param_specs=specs)
    state, m = step(state, (jnp.asarray(inputs["sm/x"]),
                            jnp.zeros((2, 16, d))))
    after = jax.device_get(state.params)
    n = 2
    for rk in ranks4:
        assert rk["sm/calls"].tolist() == [3 * n - 2, 4, 0, 0, 0, 0]
        np.testing.assert_allclose(rk["sm/loss"], float(m["loss"]),
                                   rtol=1e-4)
        for k in params:
            p0 = np.asarray(params[k])
            np.testing.assert_allclose((p0 - rk[f"sm/p/{k}"]) / LR,
                                       (p0 - np.asarray(after[k])) / LR,
                                       **SGD_DELTA)
