"""Extensions of the port (counterpart of :mod:`chainermn_tpu.extensions`):
the multi-node evaluator and the persistent-value allreduce so far."""

from chainermn_tpu_torch.extensions.allreduce_persistent import (
    AllreducePersistent,
)
from chainermn_tpu_torch.extensions.evaluator import (
    create_multi_node_evaluator,
)

__all__ = ["AllreducePersistent", "create_multi_node_evaluator"]
