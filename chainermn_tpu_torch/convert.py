"""Carry weights from the JAX package's flax modules into the port.

The flax ``params`` arrive as a nested dict of NUMPY arrays (a caller
holding JAX arrays converts them with ``jax.tree.map(np.asarray, ...)``),
so this module never sees JAX. Dense kernels ``[in, out]`` become
``nn.Linear.weight`` ``[out, in]``; the fused ``q|k|v`` column order is
kept as it is, which is the order the block splits it in.

Only the Transformer LM is converted so far; the ViT, ResNet and MLP
converters land with their models.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def lm_state_from_flax(params: Mapping) -> dict:
    """``state_dict`` of :class:`~chainermn_tpu_torch.models.transformer.
    TransformerLM` from the flax ``TransformerLM`` param tree (the
    ``{'params': ...}`` variables or the inner dict).

    Names: ``tok_emb/embedding`` (also the tied head), ``pos_emb``
    (learned positions only), per ``block_i``: ``LayerNorm_0``/``_1``
    ``{scale, bias}``, ``qkv/kernel``, ``proj/kernel``,
    ``ff_up/{kernel, bias}``, ``ff_down/{kernel, bias}``; the top-level
    ``LayerNorm_0`` is the final norm."""
    p = params.get("params", params)
    state = {"tok_emb.weight": _t(p["tok_emb"]["embedding"]),
             "ln_f.weight": _t(p["LayerNorm_0"]["scale"]),
             "ln_f.bias": _t(p["LayerNorm_0"]["bias"])}
    if "pos_emb" in p:
        state["pos_emb"] = _t(p["pos_emb"])
    n_blocks = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_blocks):
        b = p[f"block_{i}"]
        pre = f"blocks.{i}."
        for ln, name in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            state[pre + name + ".weight"] = _t(b[ln]["scale"])
            state[pre + name + ".bias"] = _t(b[ln]["bias"])
        for name in ("qkv", "proj", "ff_up", "ff_down"):
            state[pre + name + ".weight"] = _t(b[name]["kernel"]).T.contiguous()
            if "bias" in b[name]:
                state[pre + name + ".bias"] = _t(b[name]["bias"])
    return state
