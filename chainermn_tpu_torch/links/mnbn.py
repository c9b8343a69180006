"""``create_mnbn_model``: a model whose batch normalization is synchronized
over the ranks (counterpart of ``chainermn_tpu/links/mnbn.py``; the
reference ChainerMN's ``links/create_mnbn_model.py`` †).

The reference copied a Chainer link tree and rebuilt it with every
``L.BatchNormalization`` replaced by ``MultiNodeBatchNormalization``. A
torch module tree is static too, so the port does what the reference
did: a deep copy of the model (the original stays as it was), in which
every ``nn.BatchNorm1d``/``2d``/``3d`` becomes the port's
:class:`~chainermn_tpu_torch.links.batch_normalization.
MultiNodeBatchNormalization` over the group, with the layer's weights,
running statistics, ``eps``, train/eval mode and momentum (torch's
``momentum`` is the weight of the new value, the flax one that of the
old: ``1 - momentum``). A ``MultiNodeBatchNormalization`` without a
group gets this one; layers that already synchronize
(``MultiNodeBatchNormalization`` with a group, ``nn.SyncBatchNorm``) stay
as they are.

Names stay a drop-in both ways, as the JAX conversion keeps its scope
(``nn.share_scope``): the converted layer keeps ``weight``, ``bias``,
``running_mean``, ``running_var`` and ``num_batches_tracked``, so the
converted model's ``state_dict`` loads into the unconverted one and the
other way round.

What a converted layer computes is what ``MultiNodeBatchNormalization``
computes, the JAX package's statistics: the biased variance of the global
batch, in the normalization and in the running average (torch's BN puts
the unbiased variance in the running average). A layer without running
statistics (``track_running_stats=False``) or with a cumulative average
(``momentum=None``) has no counterpart there and is refused.

The JAX module's flax version guard (``_warn_if_flax_untested``) has no
counterpart: the conversion rebuilds the module tree and leans on no
framework internals.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
)

_TORCH_BN = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)


class _ConvertedBatchNorm(MultiNodeBatchNormalization):
    """``MultiNodeBatchNormalization`` that also keeps torch BN's
    ``num_batches_tracked`` (counted the same way), so the converted
    model's ``state_dict`` names are the unconverted model's."""

    def __init__(self, num_features: int, **kwargs) -> None:
        super().__init__(num_features, **kwargs)
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long,
                                          device=self.running_mean.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.use_running_average:
            self.num_batches_tracked.add_(1)
        return super().forward(x)


def _from_torch_bn(bn: nn.modules.batchnorm._BatchNorm, group,
                   name: str) -> _ConvertedBatchNorm:
    if bn.momentum is None or not bn.track_running_stats:
        raise ValueError(
            f"{name}: a BatchNorm with momentum=None or "
            "track_running_stats=False has no MultiNodeBatchNormalization "
            "counterpart")
    new = _ConvertedBatchNorm(
        bn.num_features, group=group, momentum=1.0 - bn.momentum,
        epsilon=bn.eps, use_bias=bn.affine, use_scale=bn.affine,
        device=bn.running_mean.device)
    with torch.no_grad():
        if bn.affine:
            new.weight.copy_(bn.weight)
            new.bias.copy_(bn.bias)
        new.running_mean.copy_(bn.running_mean)
        new.running_var.copy_(bn.running_var)
        new.num_batches_tracked.copy_(bn.num_batches_tracked)
    return new.train(bn.training)


def _convert(module: nn.Module, group, prefix: str) -> nn.Module:
    if isinstance(module, MultiNodeBatchNormalization):
        if module.group is None:
            module.group = group
        return module
    if isinstance(module, _TORCH_BN):
        return _from_torch_bn(module, group, prefix or "the model")
    for name, child in module.named_children():
        setattr(module, name, _convert(child, group,
                                       f"{prefix}.{name}" if prefix
                                       else name))
    return module


def create_mnbn_model(model: nn.Module, comm=None, *,
                      group=None) -> nn.Module:
    """A copy of ``model`` with every batch-norm layer synchronized over
    the communicator's group, or over ``group`` (the process group; the
    JAX function's ``axis_name``): pass exactly one.

    The copy is used exactly like the original — the same forward and
    methods, the same ``state_dict`` names — but in training mode its
    batch statistics are those of the GLOBAL batch, summed over the
    group's ranks. At world size 1 it computes the local statistics."""
    if (comm is None) == (group is None):
        raise ValueError("pass exactly one of comm or group")
    if comm is not None:
        group = comm.group
    return _convert(copy.deepcopy(model), group, "")


__all__ = ["create_mnbn_model"]
