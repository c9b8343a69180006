"""The port's tensor-parallel Transformer LM against the JAX package's.

- ``shard_lm_params`` is JAX's, leaf by leaf and exactly, on the same
  weights (the JAX stacks carried into the port's layout with
  ``convert.lm_state_from_flax``), at 1, 2 and 4 shards, with and
  without GQA; ``unshard_lm_params`` gives the weights back exactly
  (tests/test_serving.py's round trip).
- At 2 and 4 gloo ranks (``tests/torch_tp_workers.py::tp_lm_worker``,
  one launch per world size), each rank's shard of the LM (the JAX
  serving tests' widths, fp32, flash attention over packed segments: the
  port's plain K1-K3, the JAX kernels in interpret mode) against JAX's
  ``TransformerLM(tp_axis='model')`` under ``shard_map`` on an n-device
  mesh over the same stacks: the logits and the gradient of every leaf
  of every shard; the shards' gradients are also the matching slices of
  the dense port model's gradient, and the replicated leaves' gradients
  are the same on every rank, without a reduction beyond the blocks'.
- Exactly one all-reduce per column->row pair: ``2 x num_layers`` in the
  forward (and as many in the backward, ``copy_to_tp``'s), nothing else.

Tolerances: logits 1e-5 relative (1e-6 absolute, for logits near zero),
gradients 1e-4 relative and absolute: fp32 on both sides, partial
products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.ops.flash_attention import flash_attention as jax_flash
from chainermn_tpu.serving.engine import shard_lm_params as jax_shard
from chainermn_tpu_torch.convert import lm_state_from_flax
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.ops.flash_attention import flash_attention
from chainermn_tpu_torch.serving import shard_lm_params, unshard_lm_params
from torch_comm_workers import shared_launch
from torch_lm_params import lm_variables
from torch_rank_workers import few_threads  # noqa: F401
from torch_tp_workers import CALLS, LM_CFG, tp_lm_worker

SIZES = (2, 4)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 12


def _jax_attn(q, k, v, *, causal, scale, segment_ids=None):
    return jax_flash(q, k, v, causal=causal, scale=scale,
                     segment_ids=segment_ids, block_q=4, block_k=4,
                     interpret=True)


def _port_state(variables):
    return lm_state_from_flax(jax.tree.map(np.asarray, variables))


def _rank_state(stacked, r):
    return _port_state(jax.tree.map(lambda a: np.asarray(a)[r], stacked))


def _port_lm(state, **kw):
    tm = TransformerLM(**{**LM_CFG, **kw}, compute_dtype=torch.float32,
                       device="cpu")
    tm.load_state_dict(state)
    return tm


@pytest.mark.parametrize("n,kv", [(1, None), (2, None), (4, None),
                                  (1, 2), (2, 2)])
def test_shard_lm_params_is_jax_leaf_by_leaf(n, kv):
    jm = JaxLM(**LM_CFG, num_kv_heads=kv, compute_dtype=jnp.float32)
    variables = lm_variables(jm, seed=n)
    want = jax_shard(jm, variables, n)
    state = _port_state(variables)
    got = shard_lm_params(_port_lm(state, num_kv_heads=kv), state, n)
    for r in range(n):
        mine = _rank_state(want, r)
        assert set(mine) == set(got)
        for name, leaf in mine.items():
            np.testing.assert_array_equal(got[name][r].numpy(),
                                          leaf.numpy(), err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_unshard_round_trip(n):
    jm = JaxLM(**LM_CFG, compute_dtype=jnp.float32)
    state = _port_state(lm_variables(jm, seed=3))
    model = _port_lm(state)
    back = unshard_lm_params(model, shard_lm_params(model, state, n))
    assert set(back) == set(state)
    for name, leaf in state.items():
        np.testing.assert_array_equal(back[name].numpy(), leaf.numpy(),
                                      err_msg=name)


def _packed(rs):
    tokens = rs.randint(0, LM_CFG["vocab_size"], size=(B, T))
    seg = np.zeros((B, T), np.int32)
    seg[0, 5:] = 1
    seg[1, 3:] = 1
    seg[1, 9:] = 2
    return tokens.astype(np.int32), seg


def _jax_side(n, rs):
    full = JaxLM(**LM_CFG, compute_dtype=jnp.float32, attention_fn=_jax_attn)
    variables = lm_variables(full, seed=10 + n)
    stacked = jax_shard(full, variables, n)
    tp = JaxLM(**{**LM_CFG, "num_heads": LM_CFG["num_heads"] // n,
                  "d_ff": LM_CFG["d_ff"] // n},
               head_dim=LM_CFG["d_model"] // LM_CFG["num_heads"],
               tp_axis="model", compute_dtype=jnp.float32,
               attention_fn=_jax_attn)
    tokens, seg = _packed(rs)
    cot = rs.randn(B, T, LM_CFG["vocab_size"]).astype(np.float32)
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("model",))

    def local(st, tokens, seg, cot):
        p = jax.tree.map(lambda a: a[0], st)

        def loss(p):
            logits = tp.apply(p, tokens, segment_ids=seg, train=False)
            return jnp.sum(logits * cot), logits

        (_, logits), g = jax.value_and_grad(loss, has_aux=True)(p)
        return logits[None], jax.tree.map(lambda a: a[None], g)

    logits, grads = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P("model"), P(), P(), P()),
        out_specs=(P("model"), P("model")), check_vma=False))(
            stacked, tokens, seg, cot)
    state = _port_state(variables)
    inputs = {"tokens": tokens, "seg": seg, "cot": cot,
              **{f"state/{k}": v.numpy() for k, v in state.items()}}
    return inputs, state, np.asarray(logits), grads


def _dense_grads(state, inputs):
    tm = _port_lm(state, attention_fn=flash_attention)
    logits = tm(torch.from_numpy(inputs["tokens"]).long(),
                segment_ids=torch.from_numpy(inputs["seg"]))
    (logits * torch.from_numpy(inputs["cot"])).sum().backward()
    return tm, {k: p.grad for k, p in tm.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    res = {}
    for n in SIZES:
        inputs, state, logits, grads = _jax_side(
            n, np.random.RandomState(n))
        outs = shared_launch(f"tp_lm_worker{n}", tmp_path_factory,
                             tp_lm_worker, n, inputs, timeout=180)
        res[n] = (outs, inputs, state, logits, grads)
    return res


@pytest.mark.parametrize("n", SIZES)
def test_tp_logits_match_jax(runs, n):
    outs, _, _, logits, _ = runs[n]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["logits"], logits[r], **LOGIT_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_tp_gradients_match_jax(runs, n):
    outs, _, _, _, grads = runs[n]
    for r, o in enumerate(outs):
        want = _rank_state(grads, r)
        got = {k[len("grad/"):]: v for k, v in o.items()
               if k.startswith("grad/")}
        assert set(got) == set(want)
        for name, g in want.items():
            np.testing.assert_allclose(got[name], g.numpy(), **GRAD_TOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("n", SIZES)
def test_shard_gradients_are_slices_of_the_dense_gradient(runs, n):
    """Each shard's gradient is its slice of the dense model's gradient
    (``ff_down``'s bias, stored ``bias / n``, gets the bias's whole
    gradient), and a replicated leaf's gradient is the dense one on every
    rank: ``copy_to_tp``'s backward already sums it, so no reduction over
    the group is added."""
    outs, inputs, state, _, _ = runs[n]
    tm, dense = _dense_grads(state, inputs)
    sliced = shard_lm_params(tm, dense, n)
    for r, o in enumerate(outs):
        for name, g in dense.items():
            want = g if name.endswith("ff_down.bias") else sliced[name][r]
            np.testing.assert_allclose(o[f"grad/{name}"], want.numpy(),
                                       **GRAD_TOL, err_msg=f"{r} {name}")


@pytest.mark.parametrize("n", SIZES)
def test_replicated_gradients_equal_on_every_rank(runs, n):
    outs = runs[n][0]
    for name in ("tok_emb.weight", "pos_emb", "ln_f.weight",
                 "blocks.0.ln1.weight", "blocks.1.ln2.bias"):
        for o in outs[1:]:
            np.testing.assert_array_equal(o[f"grad/{name}"],
                                          outs[0][f"grad/{name}"])


@pytest.mark.parametrize("n", SIZES)
def test_two_all_reduces_per_layer(runs, n):
    """One all-reduce per column->row pair in the forward (``proj`` and
    ``ff_down``), one per pair in the backward (``copy_to_tp`` before
    ``qkv`` and ``ff_up``), and no other ``torch.distributed`` call."""
    want = dict.fromkeys(CALLS, 0)
    want["all_reduce"] = 2 * LM_CFG["num_layers"]
    for o in runs[n][0]:
        for way in ("forward", "backward"):
            got = dict(zip(CALLS, o[f"calls/{way}"].tolist()))
            assert got == want, (way, got)


def test_clone_to_shard_widths_keeps_the_replicated_leaves():
    tm = TransformerLM(**LM_CFG, compute_dtype=torch.float32, device="cpu")
    local = tm.clone(num_heads=2, num_kv_heads=2, d_ff=16, head_dim=4)
    assert local.tok_emb.weight is tm.tok_emb.weight
    assert local.blocks[0].ln1.weight is tm.blocks[0].ln1.weight
    assert local.blocks[0].qkv.weight.shape == (2 * 3 * 4, 16)
    assert local.blocks[0].ff_down.weight.shape == (16, 16)
    assert (local.num_heads, local.kv_heads, local.head_dim) == (2, 2, 4)
    assert tm.blocks[0].qkv.weight.shape == (4 * 3 * 4, 16)
    same = tm.clone(decode_attend_impl="fused")
    assert same.blocks[0].qkv.weight is tm.blocks[0].qkv.weight


def test_moe_under_tp_and_unknown_fields_are_refused():
    tm = TransformerLM(**LM_CFG, compute_dtype=torch.float32, device="cpu")
    # the MoE fields are ported: a clone takes them (a dense model keeps
    # its FFN, whatever they say)
    for field, value in (("expert_axis", None), ("moe_experts_local", 2)):
        local = tm.clone(**{field: value})
        assert getattr(local, field) == value
        assert local.blocks[0].ff_up.weight.shape == \
            tm.blocks[0].ff_up.weight.shape
    with pytest.raises(ValueError, match="clone"):
        tm.clone(window=4)
