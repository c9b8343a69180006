"""The flax initialisers the port's models draw from (CPU draws from a
seeded generator, copied to the parameter's device, so a seed gives the
same weights on any card)."""

from __future__ import annotations

import math

import torch

#: the std of a unit normal truncated to [-2, 2]: flax's
#: ``variance_scaling(..., 'truncated_normal')`` divides by it
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: variance ``1 / fan_in``, truncated at two
    standard deviations."""
    draw = torch.empty(w.shape)
    torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return w.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
