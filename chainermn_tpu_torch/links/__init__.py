"""Links of the port (counterpart of :mod:`chainermn_tpu.links`): the
synchronized batch normalization, ``create_mnbn_model`` and the
cross-rank ``MultiNodeChainList``."""

from chainermn_tpu_torch.links.batch_normalization import (
    MultiNodeBatchNormalization,
)
from chainermn_tpu_torch.links.mnbn import create_mnbn_model
from chainermn_tpu_torch.links.multi_node_chain_list import (
    MultiNodeChainList,
)

__all__ = ["MultiNodeBatchNormalization", "MultiNodeChainList",
           "create_mnbn_model"]
