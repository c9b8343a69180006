"""Allreduce of persistent (non-gradient) values (counterpart of
``chainermn_tpu/extensions/allreduce_persistent.py``): average BatchNorm's
running statistics over the ranks, so that evaluation gives the same
answer whichever rank's copy is used. Sync-BN keeps them equal already;
this covers plain BN and drift."""

from __future__ import annotations

import torch
from torch import nn

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class AllreducePersistent:
    """``ext(model)`` averages every floating buffer of the model over
    the ranks, in place, through ``allreduce_obj`` and returns the model
    (as a Trainer extension: ``lambda tr: ext(tr.state.model)``)."""

    def __init__(self, communicator: CommunicatorBase) -> None:
        self.comm = communicator

    @torch.no_grad()
    def __call__(self, model: nn.Module) -> nn.Module:
        if self.comm.size > 1:
            bufs = [b for b in model.buffers() if b.is_floating_point()]
            summed = self.comm.allreduce_obj(
                [b.detach().cpu().numpy() for b in bufs])
            for b, s in zip(bufs, summed):
                b.copy_(torch.from_numpy(s / self.comm.size))
        return model
