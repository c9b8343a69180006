"""ResNet family, the data-parallel benchmark model (counterpart of
``chainermn_tpu/models/resnet.py``).

The same network as the flax one, in NCHW (``channels_last`` memory on the
card) with the flax numbers:

- **Padding.** flax's ``nn.Conv`` pads ``'SAME'``. For a stride-2 3x3
  convolution over an even input (56, 28, 14 in ResNet-50) that is
  (0, 1), not (1, 1): ``nn.Conv2d(padding=1)`` would shift every
  downsampling block by one pixel, so each convolution computes its SAME
  pads from its input and pads explicitly when they are uneven. The stem
  pads (3, 3); the max pool pads (1, 1) with -inf.
- **Precision.** Convolutions in ``compute_dtype`` (bf16 by default) from
  fp32 parameters, cast at each use; BatchNorm in fp32 inside, its output
  in ``compute_dtype``; the global mean pool sums in fp32, and the head is
  an fp32 ``Linear`` with fp32 logits.
- **Sync-BN.** Every norm is a
  :class:`~chainermn_tpu_torch.links.MultiNodeBatchNormalization` over
  ``bn_comm``'s group (None: local BN), momentum ``bn_momentum``.
- **Init.** flax's: lecun-normal kernels, unit BN scales but a zero scale
  on each block's last norm (the residual branch starts as the identity),
  zero biases; drawn from a generator seeded with ``seed``, or loaded with
  :func:`chainermn_tpu_torch.convert.resnet_state_from_flax`.

Train and eval mode are the module's own (``model.train()`` /
``model.eval()``): eval normalises with the running averages, the flax
``train=False``.

Left out (ROADMAP queue 1, item 3.6): ``remat``/``remat_policy`` and
``stem='space_to_depth'``, which raise ``NotImplementedError``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch._device import resolve_device
from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
)
from chainermn_tpu_torch.models._init import lecun_normal_


def same_pads(size: int, k: int, stride: int) -> tuple:
    """(low, high) padding of one spatial dim under XLA's ``'SAME'``
    (``lax.padtype_to_pads``): the output is ``ceil(size / stride)`` and
    any odd pad goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A bias-free convolution with flax's ``'SAME'`` padding (or the
    explicit symmetric ``padding``), computed in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, *,
                 dtype: torch.dtype, padding: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        self.k, self.stride, self.dtype, self.padding = k, stride, dtype, \
            padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        if self.padding is not None:
            return F.conv2d(x, w, stride=self.stride, padding=self.padding)
        (hl, hh), (wl, wh) = (same_pads(x.shape[2], self.k, self.stride),
                              same_pads(x.shape[3], self.k, self.stride))
        if hl != hh or wl != wh:
            x = F.pad(x, (wl, wh, hl, hh))
            hl = wl = 0
        return F.conv2d(x, w, stride=self.stride, padding=(hl, wl))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck residual block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, conv: Callable,
                 norm: Callable, strides: int = 1) -> None:
        super().__init__()
        out = filters * 4
        self.conv0, self.norm0 = conv(in_ch, filters, 1), norm(filters)
        self.conv1 = conv(filters, filters, 3, strides)
        self.norm1 = norm(filters)
        self.conv2 = conv(filters, out, 1)
        self.norm2 = norm(out, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_ch != out or strides != 1:
            self.conv_proj = conv(in_ch, out, 1, strides)
            self.norm_proj = norm(out)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.relu(self.norm1(self.conv1(y)))
        y = self.norm2(self.conv2(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, conv: Callable,
                 norm: Callable, strides: int = 1) -> None:
        super().__init__()
        self.conv0 = conv(in_ch, filters, 3, strides)
        self.norm0 = norm(filters)
        self.conv1 = conv(filters, filters, 3)
        self.norm1 = norm(filters, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_ch != filters or strides != 1:
            self.conv_proj = conv(in_ch, filters, 1, strides)
            self.norm_proj = norm(filters)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm0(self.conv0(x)))
        y = self.norm1(self.conv1(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 3.6: the ResNet "
        "remat and the space_to_depth stem)")


class ResNet(nn.Module):
    """Configurable ResNet over NCHW images ``[B, 3, H, W]`` -> fp32
    logits ``[B, num_classes]``.

    ``stage_sizes``: blocks per stage, e.g. ``(3, 4, 6, 3)`` for
    ResNet-50; ``block_cls``: :class:`BottleneckBlock` or
    :class:`BasicBlock`; ``bn_comm``: the communicator BN synchronises
    over (the JAX ``bn_axis_name``), None for local BN.
    ``device=None`` means the CUDA card (channels_last there) and raises
    without one.
    """

    def __init__(self, stage_sizes: Sequence[int], block_cls: type,
                 num_classes: int = 1000, num_filters: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16, bn_comm=None,
                 bn_momentum: float = 0.9, remat: bool = False,
                 remat_policy: Optional[str] = None,
                 stem: str = "standard", *, seed: int = 0,
                 device=None) -> None:
        super().__init__()
        if remat or remat_policy is not None:
            raise _later("remat/remat_policy")
        if stem == "space_to_depth":
            raise _later("stem='space_to_depth'")
        if stem != "standard":
            raise ValueError(f"unknown stem {stem!r}")
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        conv = partial(Conv, dtype=compute_dtype, device=device)
        norm = partial(MultiNodeBatchNormalization, comm=bn_comm,
                       momentum=bn_momentum, epsilon=1e-5,
                       dtype=compute_dtype, device=device)
        self.conv_init = Conv(3, num_filters, 7, 2, dtype=compute_dtype,
                              padding=3, device=device)
        self.bn_init = norm(num_filters)
        blocks, ch = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(ch, filters, conv, norm,
                                        2 if i > 0 and j == 0 else 1))
                ch = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(ch, num_classes, device=device)
        self.init_weights(torch.Generator().manual_seed(seed))
        if device.type == "cuda":
            self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Redraw every weight as flax initialises it."""
        for m in self.modules():
            if isinstance(m, Conv):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
        lecun_normal_(self.head.weight, self.head.in_features, generator)
        self.head.bias.zero_()
        for blk in self.blocks:
            for m in blk.modules():
                if isinstance(m, MultiNodeBatchNormalization):
                    m.weight.fill_(1.0)
            last = blk.norm2 if isinstance(blk, BottleneckBlock) \
                else blk.norm1
            last.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = x.to(self.compute_dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        # flax's jnp.mean: an fp32 sum, the mean in the compute dtype
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.compute_dtype)
        return self.head(x.float()).float()


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3),
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3),
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3),
                    block_cls=BottleneckBlock)
