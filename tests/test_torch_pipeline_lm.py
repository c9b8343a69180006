"""The Transformer LM with its blocks pipelined, 2 a stage over 2 gloo
ranks, against JAX's ``make_pipeline`` over the JAX ``TransformerBlock``
on a 2-device CPU mesh: d_model 64, 4 heads, d_ff 128, 4 blocks, B 4 x
T 32 in 2 microbatches, fp32, the plain (blockwise) attention on both
sides. The embedding and the tied head stay outside the conveyor on
every rank. The weights are a seeded flax tree carried across with
``convert.lm_state_from_flax`` and ``convert.blocks_state_from_flax``
(rank programs in ``tests/torch_pipeline_workers.py::lm_worker``).

Compared on every rank: the loss and logits, the rank's blocks'
gradients, and the gradients of the embedding (from the head and the
input), the positions and the final norm. The same step through 1F1B
(the head as ``head_params``, the embedding trained through the input
gradients) is held to the same JAX gradients: equal-sized microbatches
make the mean of the microbatch losses the batch's loss.

Tolerance: fp32, loss and logits rtol 1e-5 atol 1e-5, gradients rtol
1e-4 atol 1e-5 (the two frameworks' attention and matmuls sum in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn
from jax.sharding import Mesh

from chainermn_tpu.models.transformer import (
    TransformerBlock,
    TransformerLM,
    lm_loss,
)
from chainermn_tpu.parallel import pipeline as jpl
from chainermn_tpu_torch.convert import (
    blocks_state_from_flax,
    lm_state_from_flax,
)
from torch_comm_workers import shared_launch
from torch_lm_params import lm_variables
from torch_pipeline_workers import LM, LM_BATCH, LM_MICRO, lm_worker
from torch_rank_workers import few_threads  # noqa: F401

N = 2
PER = LM["num_layers"] // N
VALUES = dict(rtol=1e-5, atol=1e-5)
GRADS = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    module = TransformerLM(**LM, compute_dtype=jnp.float32)
    params = lm_variables(module, seed=3)["params"]
    tokens = np.random.RandomState(4).randint(
        0, LM["vocab_size"], size=(LM_BATCH, LM["max_len"]))
    inputs = {"tokens": tokens}
    for k, t in lm_state_from_flax(params).items():
        inputs[f"state/{k}"] = t.numpy()
    for s in range(N):
        blocks = [params[f"block_{s * PER + i}"] for i in range(PER)]
        for k, t in blocks_state_from_flax(blocks).items():
            inputs[f"stage{s}/{k}"] = t.numpy()
    outs = shared_launch("pipeline_lm_worker", tmp_path_factory, lm_worker,
                         N, inputs, timeout=240)
    return params, tokens, outs


@pytest.fixture(scope="module")
def reference(setup):
    """JAX's loss, logits and gradients: make_pipeline over the stacked
    blocks of each stage, the embedding and head outside."""
    params, tokens, _ = setup
    block = TransformerBlock(num_heads=LM["num_heads"], d_ff=LM["d_ff"],
                             compute_dtype=jnp.float32)
    norm = nn.LayerNorm(dtype=jnp.float32, param_dtype=jnp.float32)

    def stage_fn(p, x):
        for i in range(PER):
            x = block.apply({"params": p[f"b{i}"]}, x)
        return x

    mesh = Mesh(np.array(jax.devices("cpu")[:N]), ("stage",))
    pipe = jpl.make_pipeline(stage_fn, mesh, n_microbatches=LM_MICRO)
    stacked = jpl.stack_stage_params([
        {f"b{i}": params[f"block_{s * PER + i}"] for i in range(PER)}
        for s in range(N)])
    outer = {k: params[k] for k in ("tok_emb", "pos_emb", "LayerNorm_0")}
    tok = jnp.asarray(tokens)

    def loss_fn(stacked, outer):
        emb = outer["tok_emb"]["embedding"]
        x = emb[tok] + outer["pos_emb"][:tok.shape[1]]
        x = pipe(stacked, x)
        x = norm.apply({"params": outer["LayerNorm_0"]}, x)
        logits = x @ emb.T
        return lm_loss(logits, tok), logits

    (loss, logits), (g_stacked, g_outer) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(stacked, outer)
    g_stages = []
    for s in range(N):
        blocks = [jax.tree.map(lambda a: np.asarray(a)[s], g_stacked[f"b{i}"])
                  for i in range(PER)]
        g_stages.append({k: t.numpy() for k, t in
                         blocks_state_from_flax(blocks).items()})
    g_outer = jax.tree.map(np.asarray, g_outer)
    return float(loss), np.asarray(logits), g_stages, {
        "tok_emb.weight": g_outer["tok_emb"]["embedding"],
        "pos_emb": g_outer["pos_emb"],
        "ln_f.weight": g_outer["LayerNorm_0"]["scale"],
        "ln_f.bias": g_outer["LayerNorm_0"]["bias"]}


@pytest.mark.parametrize("engine", ["gpipe", "1f1b"])
def test_loss_matches_jax_on_every_rank(setup, reference, engine):
    loss, logits, _, _ = reference
    for o in setup[2]:
        np.testing.assert_allclose(o[f"{engine}/loss"], loss, **VALUES)
        if engine == "gpipe":
            np.testing.assert_allclose(o["gpipe/logits"], logits, **VALUES)


@pytest.mark.parametrize("engine", ["gpipe", "1f1b"])
def test_stage_block_grads_match_jax(setup, reference, engine):
    g_stages = reference[2]
    for r, o in enumerate(setup[2]):
        names = [k for k in o if k.startswith(f"{engine}/g/stage/")]
        assert len(names) == len(g_stages[r]) == 10 * PER
        for k, want in g_stages[r].items():
            np.testing.assert_allclose(o[f"{engine}/g/stage/{k}"], want,
                                       err_msg=k, **GRADS)


@pytest.mark.parametrize("engine", ["gpipe", "1f1b"])
def test_embedding_and_head_grads_match_jax_on_every_rank(setup, reference,
                                                          engine):
    """The replicated leaves: each rank's gradient is the global one (the
    embedding's from the head and, through the broadcast input
    cotangent, from the input), so the replicas stay equal."""
    g_outer = reference[3]
    outs = setup[2]
    for o in outs:
        for k, want in g_outer.items():
            np.testing.assert_allclose(o[f"{engine}/g/{k}"], want,
                                       err_msg=k, **GRADS)
    for k in g_outer:
        np.testing.assert_array_equal(outs[1][f"{engine}/g/{k}"],
                                      outs[0][f"{engine}/g/{k}"])
