"""Carry weights from the JAX package's flax modules into the port.

The flax ``params`` arrive as a nested dict of NUMPY arrays (a caller
holding JAX arrays converts them with ``jax.tree.map(np.asarray, ...)``),
so this module never sees JAX. Dense kernels ``[in, out]`` become
``nn.Linear.weight`` ``[out, in]``; the fused ``q|k|v`` column order is
kept as it is, which is the order the block splits it in.

Conv kernels ``[H, W, in, out]`` (HWIO) become ``[out, in, H, W]`` (OIHW),
and BatchNorm's ``batch_stats`` become the module's running-statistics
buffers. Converted so far: the Transformer LM, the MLP, the ResNets,
the functional chains of a ``MultiNodeChainList`` (their weights keep
the ``x @ w`` layout), a run of Transformer blocks (dense or MoE: the
``moe_*`` leaves keep JAX's layout), a rank's slice of a pipeline's
stacked stage parameters and of a ``make_expert_params`` stack; the ViT
converter lands with its model.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def lm_state_from_flax(params: Mapping) -> dict:
    """``state_dict`` of :class:`~chainermn_tpu_torch.models.transformer.
    TransformerLM` from the flax ``TransformerLM`` param tree (the
    ``{'params': ...}`` variables or the inner dict).

    Names: ``tok_emb/embedding`` (also the tied head), ``pos_emb``
    (learned positions only), per ``block_i``: ``LayerNorm_0``/``_1``
    ``{scale, bias}``, ``qkv/kernel``, ``proj/kernel``,
    ``ff_up/{kernel, bias}``, ``ff_down/{kernel, bias}`` or, in an MoE
    block, ``moe_router``, ``moe_w_up``, ``moe_b_up``, ``moe_w_down`` and
    ``moe_b_down``; the top-level ``LayerNorm_0`` is the final norm."""
    p = params.get("params", params)
    state = {"tok_emb.weight": _t(p["tok_emb"]["embedding"]),
             "ln_f.weight": _t(p["LayerNorm_0"]["scale"]),
             "ln_f.bias": _t(p["LayerNorm_0"]["bias"])}
    if "pos_emb" in p:
        state["pos_emb"] = _t(p["pos_emb"])
    n_blocks = sum(1 for k in p if k.startswith("block_"))
    state.update(blocks_state_from_flax(
        [p[f"block_{i}"] for i in range(n_blocks)], prefix="blocks."))
    return state


def blocks_state_from_flax(blocks, prefix: str = "") -> dict:
    """``state_dict`` of an ``nn.ModuleList`` of the port's
    :class:`~chainermn_tpu_torch.models.transformer.TransformerBlock`
    from the flax params of a run of JAX ``TransformerBlock``s (one
    ``block_i`` subtree each, in order): keys ``f"{prefix}{i}.{name}"``,
    the names :func:`lm_state_from_flax` gives a block (a pipeline
    stage's blocks, called through ``torch.func.functional_call``)."""
    state = {}
    for i, b in enumerate(blocks):
        pre = f"{prefix}{i}."
        for ln, name in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            state[pre + name + ".weight"] = _t(b[ln]["scale"])
            state[pre + name + ".bias"] = _t(b[ln]["bias"])
        for name in ("qkv", "proj", "ff_up", "ff_down"):
            if name not in b:  # an MoE block has no ff_up/ff_down
                continue
            state[pre + name + ".weight"] = _t(b[name]["kernel"]).T.contiguous()
            if "bias" in b[name]:
                state[pre + name + ".bias"] = _t(b[name]["bias"])
        for name in MOE_LEAVES:
            if name in b:  # [D, E] and [E, ...]: JAX's layout, untransposed
                state[pre + name] = _t(b[name])
    return state


#: an MoE block's leaves, in the port's names and JAX's layout
MOE_LEAVES = ("moe_router", "moe_w_up", "moe_b_up", "moe_w_down",
              "moe_b_down")


def expert_params_from_stack(stacked, rank: Optional[int] = None,
                             n_ranks: int = 1):
    """A JAX ``make_expert_params`` stack (a pytree of numpy arrays with
    a leading ``[E, ...]`` expert dim) as fp32 tensors: the whole stack,
    or with ``rank`` the ``[E / n_ranks, ...]`` slice of experts ``[rank
    * E / n_ranks, (rank + 1) * E / n_ranks)`` that rank ``rank`` of an
    expert group of ``n_ranks`` owns (what ``P('expert')`` hands it)."""
    def leaf(a):
        a = np.asarray(a)
        if rank is None:
            return _t(a)
        if a.shape[0] % n_ranks:
            raise ValueError(f"{a.shape[0]} experts do not divide over "
                             f"{n_ranks} ranks")
        e = a.shape[0] // n_ranks
        return _t(a[rank * e:(rank + 1) * e])

    return pytree.tree_map(leaf, stacked)


def stage_params_from_stack(stacked, rank: int,
                            virtual_stages: int = 1):
    """This rank's slice of a JAX-layout stack of pipeline stage
    parameters (a pytree of numpy arrays ``[n_stages * v, ...]``, the
    layout of ``stack_stage_params`` or ``stack_interleaved_stage_params``)
    as fp32 tensors: index ``rank`` of each leaf, or its ``[v, ...]``
    chunks ``[rank * v, (rank + 1) * v)`` under interleaving — what
    ``P('stage')`` hands device ``rank``."""
    v = virtual_stages

    def leaf(a):
        a = np.asarray(a)
        return _t(a[rank] if v == 1 else a[rank * v:(rank + 1) * v])

    return pytree.tree_map(leaf, stacked)


def chain_params_from_flax(params_list) -> list:
    """A :class:`~chainermn_tpu_torch.links.MultiNodeChainList`'s
    ``params_list`` from the JAX one's (a list of flat dicts of arrays,
    e.g. the model-parallel MNIST example's stages): fp32 tensors, the
    same names and layouts, since both chains compute ``x @ w``."""
    return [{k: _t(v) for k, v in p.items()} for p in params_list]


def _hwio(a) -> torch.Tensor:
    """A flax conv kernel ``[H, W, in, out]`` as ``[out, in, H, W]``."""
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def _dense(state: dict, prefix: str, p: Mapping) -> None:
    state[prefix + ".weight"] = _t(p["kernel"]).T.contiguous()
    state[prefix + ".bias"] = _t(p["bias"])


def mlp_state_from_flax(params: Mapping) -> dict:
    """``state_dict`` of :class:`~chainermn_tpu_torch.models.mlp.MLP` from
    the flax ``MLP`` params: ``Dense_i`` -> ``dense{i}``."""
    p = params.get("params", params)
    state: dict = {}
    for i in range(3):
        _dense(state, f"dense{i}", p[f"Dense_{i}"])
    return state


def resnet_state_from_flax(params: Mapping, batch_stats: Mapping) -> dict:
    """``state_dict`` of :class:`~chainermn_tpu_torch.models.resnet.ResNet`
    from the flax ``ResNet``'s ``params`` and ``batch_stats``.

    Names: ``conv_init``, ``bn_init``, the blocks ``BasicBlock_i`` or
    ``BottleneckBlock_i`` (numbered over all stages) -> ``blocks.i`` with
    ``Conv_j`` -> ``conv{j}``, ``MultiNodeBatchNormalization_j`` ->
    ``norm{j}``, ``conv_proj`` and ``norm_proj`` as they are, and
    ``Dense_0`` -> ``head``. A BN's ``scale``/``bias`` are the module's
    ``weight``/``bias``, its ``mean``/``var`` the ``running_mean``/
    ``running_var`` buffers."""
    p = params.get("params", params)
    stats = batch_stats.get("batch_stats", batch_stats)
    state: dict = {}

    def norm(prefix, pp, st):
        state[prefix + ".weight"] = _t(pp["scale"])
        state[prefix + ".bias"] = _t(pp["bias"])
        state[prefix + ".running_mean"] = _t(st["mean"])
        state[prefix + ".running_var"] = _t(st["var"])

    state["conv_init.weight"] = _hwio(p["conv_init"]["kernel"])
    norm("bn_init", p["bn_init"], stats["bn_init"])
    blocks = sorted((k for k in p if k.startswith(("BasicBlock_",
                                                    "BottleneckBlock_"))),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(blocks):
        b, s = p[name], stats[name]
        for key in b:
            if key.startswith("Conv_"):
                state[f"blocks.{i}.conv{key[5:]}.weight"] = _hwio(
                    b[key]["kernel"])
            elif key == "conv_proj":
                state[f"blocks.{i}.conv_proj.weight"] = _hwio(
                    b[key]["kernel"])
            elif key.startswith("MultiNodeBatchNormalization_"):
                norm(f"blocks.{i}.norm{key.rsplit('_', 1)[1]}", b[key],
                     s[key])
            elif key == "norm_proj":
                norm(f"blocks.{i}.norm_proj", b[key], s[key])
            else:
                raise KeyError(f"unexpected flax module {name}/{key}")
    _dense(state, "head", p["Dense_0"])
    return state
