"""Seeded flax variables of the JAX ``TransformerLM`` for the port's
tensor-parallel tests: the tree's structure from ``jax.eval_shape`` of
the init (integer tokens), every leaf drawn with numpy — kernels at the
lecun scale, norm scales in [0.5, 1.5], biases and the rest small but
non-zero, so that ``ff_down``'s bias (stored ``bias / n`` per shard) and
the norms' gradients are all seen."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def lm_variables(module, seed: int = 0, tokens_shape=(1, 4)) -> dict:
    """``{'params': ...}`` of a JAX ``TransformerLM`` as numpy arrays."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros(tokens_shape, jnp.int32), train=False))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['kernel']"):
            return (rs.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)
        if name.endswith("['scale']"):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['embedding']"):
            return (rs.randn(*shape) / np.sqrt(shape[1])).astype(np.float32)
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
