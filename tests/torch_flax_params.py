"""Seeded flax variables for the port-vs-JAX model tests.

``jax.eval_shape`` gives the flax tree's structure without compiling the
init, and every leaf is drawn with numpy from a seed: kernels at the
lecun scale, BatchNorm scales and running variances in [0.5, 1.5], biases
and running means small but non-zero. Random scales everywhere (flax's
own init zeroes each block's last BN scale, which would zero the
gradients of the convolutions before it) make the gradient checks see
every parameter. Those last scales are drawn small, in [0.1, 0.3], so the
residual branches start near the identity as they do under flax's init:
with unit-size scales there, a 16-block ResNet-50 at 4 filters amplifies
a 1e-7 change of its input to ~3e-4 in its logits, and rounding alone
parts two fp32 implementations by more than the tests' 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(module, x_shape, seed: int = 0, **init_kwargs) -> dict:
    """``{'params': ...}`` (and ``'batch_stats'``) of ``module`` as numpy;
    ``init_kwargs`` go to ``module.init``."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros(x_shape, jnp.float32), **init_kwargs))
    rs = np.random.RandomState(seed)
    last_norm = {}  # block -> name of its last BN
    for path, _ in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [k.key for k in path]
        if len(keys) >= 3 and keys[-2].startswith(
                "MultiNodeBatchNormalization_"):
            last_norm[keys[-3]] = max(
                last_norm.get(keys[-3], keys[-2]), keys[-2])

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        keys = [k.key for k in path]
        shape = leaf.shape
        if (keys[-1] == "scale" and len(keys) >= 3
                and last_norm.get(keys[-3]) == keys[-2]):
            return rs.uniform(0.1, 0.3, shape).astype(np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(shape[:-1]))
            return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith(("['scale']", "['var']")):
            return rs.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
