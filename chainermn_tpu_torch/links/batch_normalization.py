"""Synchronized (multi-node) batch normalization (counterpart of
``chainermn_tpu/links/batch_normalization.py``).

Written from the JAX body, not from ``nn.BatchNorm2d``/``nn.SyncBatchNorm``,
whose numbers differ: each rank contributes fp32 partial moments
``(sum, sum of squares, count)``; ONE ``all_reduce`` over the
communicator's group gives the global-batch moments; the variance is the
biased ``max(ss/n - mean^2, 0)``, and it is also what enters the running
statistics, through the flax EMA ``m * running + (1 - m) * batch``
(``m`` is ``momentum``; torch's BN ``momentum`` is ``1 - m``). The
normalisation runs in fp32 and the output is cast to ``dtype`` (the
input's dtype by default).

The backward carries the gradient through the all_reduce, as the
transpose of the JAX ``lax.psum`` does: the cotangents of the global
sums are summed over the ranks by a second all_reduce. Without it the
gradients would be right at one rank and wrong at two. The forward and
backward are one ``autograd.Function`` that keeps only the input for
the backward (the fp32 intermediates are recomputed), so a bf16 network
does not hold fp32 copies of its activations.

The feature axis is dim 1 (torch's NCHW and ``[N, C]``); the JAX module
normalises its last axis.
"""

from __future__ import annotations

import copy
import pickle
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch._device import resolve_device


def _reduce_dims(x: torch.Tensor) -> list:
    return [0] + list(range(2, x.dim()))


def _per_feature(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.view([1, -1] + [1] * (x.dim() - 2))


class _SyncBatchNorm(torch.autograd.Function):
    """``y, mean, var`` of a train-mode forward; ``mean`` and ``var``
    (the global batch statistics, for the running averages) carry no
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, epsilon, out_dtype):
        dims = _reduce_dims(x)
        feat = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), float(x.numel() // feat))])
        if group is not None:
            dist.all_reduce(stats, group=group)
        s, ss, total = stats[:feat], stats[feat:2 * feat], stats[2 * feat]
        mean = s / total
        var_raw = ss / total - mean * mean
        var = torch.clamp_min(var_raw, 0.0)
        inv = torch.rsqrt(var + epsilon)
        y = (xf - _per_feature(mean, x)) * _per_feature(inv, x)
        if weight is not None:
            y = y * _per_feature(weight.float(), x)
        if bias is not None:
            y = y + _per_feature(bias.float(), x)
        ctx.save_for_backward(x, weight, mean, inv, var_raw, total)
        ctx.group = group
        ctx.has_bias = bias is not None
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, inv, var_raw, total = ctx.saved_tensors
        dims = _reduce_dims(x)
        dy = dy.float()
        centred = x.float() - _per_feature(mean, x)
        xhat = centred * _per_feature(inv, x)
        dweight = (dy * xhat).sum(dims) if weight is not None else None
        dbias = dy.sum(dims) if ctx.has_bias else None
        dxhat = dy * _per_feature(weight.float(), x) if weight is not None \
            else dy
        # xhat = (x - mean) * inv, inv = rsqrt(var + eps),
        # var = max(ss / n - mean^2, 0), mean = s / n: the cotangents of
        # this rank's share of the global sums s and ss
        dinv = (dxhat * centred).sum(dims)
        dvar = dinv * -0.5 * inv * inv * inv * (var_raw > 0).float()
        dmean = -dxhat.sum(dims) * inv - 2.0 * mean * dvar
        dsums = torch.cat([dmean / total, dvar / total])
        if ctx.group is not None:
            # the transpose of the forward's all_reduce
            dist.all_reduce(dsums, group=ctx.group)
        feat = x.shape[1]
        ds, dss = dsums[:feat], dsums[feat:]
        dx = (dxhat * _per_feature(inv, x) + _per_feature(ds, x)
              + 2.0 * x.float() * _per_feature(dss, x))
        return dx.to(x.dtype), dweight, dbias, None, None, None


class MultiNodeBatchNormalization(nn.Module):
    """BatchNorm whose batch statistics are those of the GLOBAL batch.

    ``comm``: the communicator whose group the moments are summed over,
    or ``group``: the process group itself; neither gives local
    (one-process) BN. ``momentum`` is the flax one (the
    weight of the old running value). The running statistics are the
    buffers ``running_mean``/``running_var``, the flax
    ``batch_stats/mean``/``var``. The eval path (running averages, no
    communication) runs when the module is in eval mode or was built
    with ``use_running_average=True``.

    The group is a handle to the job's processes: a deep copy shares it,
    and a pickle keeps the default group (as a token, bound again when it
    is loaded) and refuses any other.
    """

    def __init__(self, num_features: int, comm=None, *, group=None,
                 momentum: float = 0.99, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True,
                 use_scale: bool = True, scale_init: float = 1.0,
                 use_running_average: bool = False, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_features = num_features
        self.comm = comm
        self.group = group if group is not None else (
            comm.group if comm is not None else None)
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.use_running_average = use_running_average
        self.weight = (nn.Parameter(torch.full((num_features,), scale_init,
                                               device=device))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, device=device))
                     if use_bias else None)
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    @classmethod
    def for_communicator(cls, comm, num_features: int, **kwargs
                         ) -> "MultiNodeBatchNormalization":
        """Sync-BN over ``comm``'s ranks (the JAX module takes the
        communicator's ``bn_axis_name``; here the group is the axis)."""
        return cls(num_features, comm=comm, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        if self.use_running_average or not self.training:
            y = ((x.float() - _per_feature(self.running_mean, x))
                 * _per_feature(torch.rsqrt(self.running_var + self.epsilon),
                                x))
            if self.weight is not None:
                y = y * _per_feature(self.weight.float(), x)
            if self.bias is not None:
                y = y + _per_feature(self.bias.float(), x)
            return y.to(out_dtype)
        y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                            self.group, self.epsilon,
                                            out_dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y

    def extra_repr(self) -> str:
        return (f"{self.num_features}, momentum={self.momentum}, "
                f"epsilon={self.epsilon}, synced={self.group is not None}")

    def __deepcopy__(self, memo):
        for handle in (self.group, self.comm):
            if handle is not None:
                memo.setdefault(id(handle), handle)
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__dict__.update({k: copy.deepcopy(v, memo)
                             for k, v in self.__dict__.items()})
        return new

    def __getstate__(self):
        state = dict(super().__getstate__())
        state["comm"] = None
        if state["group"] is not None:
            if state["group"] is not dist.group.WORLD:
                raise pickle.PicklingError(
                    "a BN synchronized over a subgroup cannot be pickled; "
                    "build it again in the receiving process")
            state["group"] = _WORLD
        return state

    def __setstate__(self, state):
        if state.get("group") == _WORLD:
            state["group"] = (dist.group.WORLD if dist.is_initialized()
                              else None)
        super().__setstate__(state)


#: a pickled BN's token for the default group
_WORLD = "torch.distributed.group.WORLD"
