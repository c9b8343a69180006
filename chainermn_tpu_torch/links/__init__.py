"""Links of the port (counterpart of :mod:`chainermn_tpu.links`): the
synchronized batch normalization so far."""

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
)

__all__ = ["MultiNodeBatchNormalization"]
