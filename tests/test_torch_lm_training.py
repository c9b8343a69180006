"""The port's LM training path against the JAX package's, same weights.

flax parameters are initialised in JAX, carried across with
``convert.lm_state_from_flax`` and both models run at fp32 compute with
flash attention on both sides (the JAX Pallas kernels in interpret mode,
the port's plain versions of K1–K3) over the same packed numpy batches:

- logits with ``segment_ids``, ``lm_loss`` with the cross-document mask,
  and every parameter's gradient;
- three steps of ``make_train_step`` over a world-size-1 communicator
  wrapped in ``create_multi_node_optimizer(adamw(1e-3))`` — the fp32
  wire, the bf16 wire and double buffering — comparing each step's loss
  and the parameters after step 3;
- gradient accumulation against the full batch, and the options the port
  leaves out.

Tolerances: logits, loss and gradients 1e-4 (relative and absolute), as
in ``tests/test_torch_transformer.py`` — fp32 with reductions in other
orders. Parameters after 3 AdamW steps 2e-5 absolute: Adam normalises
each gradient element, so a last-bit difference in a gradient moves an
update by far less than the learning rate (1e-3); on the bf16 wire a
gradient element that lands next to a bf16 rounding boundary can round
the other way on one side, which moves that update by at most ~1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import lm_loss as jax_lm_loss
from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu.training.train_step import (
    create_train_state as jax_create_state,
    make_train_step as jax_make_step,
)
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM, lm_loss
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.optimizers import create_multi_node_optimizer
from chainermn_tpu_torch.training import (
    create_train_state,
    make_train_step,
    normalize_loss_fn,
)
from torch_rank_workers import few_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=0, atol=2e-5)
CFG = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64,
           max_len=32)
B, T = 2, 24


def _jax_attn(q, k, v, *, causal, scale, segment_ids=None):
    return jax_flash(q, k, v, causal=causal, scale=scale,
                     segment_ids=segment_ids, block_q=8, block_k=8,
                     interpret=True)


def _pair(seed=0):
    jm = JaxLM(**CFG, compute_dtype=jnp.float32, attention_fn=_jax_attn)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                       attention_fn=flash_attention)
    tm.load_state_dict(lm_state_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params["params"], tm


def _packed(seed, batch=B):
    """2-3 documents per row: tokens, segment ids, the target mask."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, CFG["vocab_size"], size=(batch, T))
    seg = np.zeros((batch, T), np.int32)
    for b in range(batch):
        for cut in sorted(rs.choice(np.arange(4, T - 4), rs.randint(1, 3),
                                    replace=False)):
            seg[b, cut:] += 1
    valid = np.concatenate([np.ones_like(seg[:, :1]),
                            seg[:, 1:] == seg[:, :-1]], axis=1)
    return tokens.astype(np.int32), seg, valid.astype(np.int32)


def _jax_loss(jm):
    def loss_fn(params, batch):
        tokens, seg, valid = batch
        logits = jm.apply({"params": params}, tokens, segment_ids=seg)
        return jax_lm_loss(logits, tokens, mask=valid)
    return loss_fn


def _port_loss(model, batch):
    tokens, seg, valid = batch
    return lm_loss(model(tokens, segment_ids=seg), tokens, mask=valid)


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def _assert_params_match(tm, jax_params, tol):
    want = lm_state_from_flax(jax.tree.map(np.asarray, jax_params))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   err_msg=name, **tol)


def test_logits_loss_and_every_gradient_match():
    jm, params, tm = _pair()
    batch = _packed(1)
    tokens, seg, _ = batch
    want = jm.apply({"params": params}, jnp.asarray(tokens),
                    segment_ids=jnp.asarray(seg))
    got = tm(torch.from_numpy(tokens), segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    jloss, jgrads = jax.value_and_grad(_jax_loss(jm))(
        params, tuple(map(jnp.asarray, batch)))
    loss = _port_loss(tm, _t(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    loss.backward()
    want_g = lm_state_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("wire,double_buffering", [
    (None, False), ("bfloat16", False), (None, True)],
    ids=["fp32-wire", "bf16-wire", "double-buffering"])
def test_three_train_steps_match(wire, double_buffering):
    jm, params, tm = _pair(seed=2)
    jcomm = chainermn_tpu.create_communicator(
        "naive", devices=jax.devices()[:1], allreduce_grad_dtype=wire)
    jopt = chainermn_tpu.create_multi_node_optimizer(
        optax.adamw(1e-3), jcomm, double_buffering=double_buffering)
    jstate = jax_create_state(params, jopt, jcomm)
    jstep = jax_make_step(_jax_loss(jm), jopt, jcomm)

    comm = create_communicator("naive", allreduce_grad_dtype=wire)
    opt = create_multi_node_optimizer(
        torch.optim.AdamW(tm.parameters(), lr=1e-3, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        comm, double_buffering=double_buffering)
    state = create_train_state(tm, opt, comm)
    step = make_train_step(_port_loss, opt, comm)

    for i in range(3):
        batch = _packed(10 + i)
        jstate, jm_metrics = jstep(jstate, tuple(map(jnp.asarray, batch)))
        state, metrics = step(state, _t(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jm_metrics["loss"]), **TOL)
    assert state.step == 3
    _assert_params_match(tm, jstate.params, PARAM_TOL)


def test_bf16_wire_rounds_in_the_step_for_a_plain_optimizer():
    """A plain optimizer: the step reduces through the communicator's
    wire itself, which equals the wrapper's reduction."""
    _, _, a = _pair(seed=3)
    _, _, b = _pair(seed=3)
    comm = create_communicator("naive", allreduce_grad_dtype="bfloat16")
    batch = _t(_packed(4))

    def adamw(m):
        return torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4)

    wrapped = create_multi_node_optimizer(adamw(a), comm)
    plain = adamw(b)
    sa = create_train_state(a, wrapped, comm)
    sb = create_train_state(b, plain, comm)
    sa, ma = make_train_step(_port_loss, wrapped, comm)(sa, batch)
    sb, mb = make_train_step(_port_loss, plain, comm)(sb, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(pa.grad, pb.grad, rtol=0, atol=0)
        assert torch.equal(pa.grad, pa.grad.bfloat16().float())


def test_gradient_accumulation_equals_the_full_batch():
    _, _, a = _pair(seed=4)
    _, _, b = _pair(seed=4)
    a.attention_fn = b.attention_fn = None
    for blk in (*a.blocks, *b.blocks):
        blk.attention_fn = None
    comm = create_communicator("naive")
    tokens = torch.from_numpy(
        np.random.RandomState(5).randint(0, 64, size=(4, T)))

    def loss_fn(model, toks):
        return lm_loss(model(toks), toks)

    losses = []
    for model, accum in ((a, 1), (b, 2)):
        opt = create_multi_node_optimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4), comm)
        state = create_train_state(model, opt, comm)
        step = make_train_step(loss_fn, opt, comm, accum_steps=accum)
        for _ in range(2):
            state, metrics = step(state, tokens)
            losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[:2], losses[2:], rtol=1e-6)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=1e-6, msg=name)


def test_loss_fn_return_shapes():
    loss = torch.tensor(2.0)
    metrics = {"acc": torch.tensor(0.5)}
    for out in (loss, (loss, metrics), (loss, (metrics, {"bn": 1}))):
        got = normalize_loss_fn(lambda m, b, out=out: out)(None, None)
        assert got[0] is loss
        assert got[1] == ({} if out is loss else metrics)


def test_left_out_options_raise():
    _, _, tm = _pair()
    comm = create_communicator("naive")
    adamw = torch.optim.AdamW(tm.parameters())
    # plan= is the ParallelPlan path (tests/test_torch_plan.py), which
    # refuses the communicator path's knobs
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(_port_loss, adamw, comm, plan=object(),
                        accum_steps=2)
    # error feedback and the schedules are ported: EF needs the int8
    # wire, and the 'auto' schedule names ROADMAP queue 8
    with pytest.raises(ValueError, match="int8"):
        create_multi_node_optimizer(adamw, comm, error_feedback=True)
    assert create_multi_node_optimizer(
        adamw, comm, reduction_schedule="flat").reduction_schedule == "flat"
    with pytest.raises(NotImplementedError, match="ROADMAP queue 8"):
        create_multi_node_optimizer(adamw, comm, reduction_schedule="auto")
    with pytest.raises(ValueError, match="exactly the model's parameters"):
        create_train_state(tm, torch.optim.AdamW(tm.blocks.parameters()),
                           comm)
