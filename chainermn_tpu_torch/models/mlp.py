"""3-layer MLP, the reference's MNIST smoke-test model (counterpart of
``chainermn_tpu/models/mlp.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.models._init import lecun_normal_


class MLP(nn.Module):
    """``n_units`` hidden x2 + ``n_out`` head, ReLU, fp32: the flax
    ``MLP``'s ``Dense_0``/``Dense_1``/``Dense_2`` are ``dense0``/
    ``dense1``/``dense2``. The input is flattened to ``[batch, -1]``;
    ``in_features`` is fixed at construction (784 for MNIST).

    Weights are drawn as flax draws them (lecun-normal kernels, zero
    biases) from a generator seeded with ``seed``, or loaded with
    :func:`chainermn_tpu_torch.convert.mlp_state_from_flax`."""

    def __init__(self, n_units: int = 1000, n_out: int = 10, *,
                 in_features: int = 784, seed: int = 0, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.dense0 = nn.Linear(in_features, n_units, device=device)
        self.dense1 = nn.Linear(n_units, n_units, device=device)
        self.dense2 = nn.Linear(n_units, n_out, device=device)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in (self.dense0, self.dense1, self.dense2):
                lecun_normal_(lin.weight, lin.in_features, gen)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.dense0(x))
        x = F.relu(self.dense1(x))
        return self.dense2(x)
