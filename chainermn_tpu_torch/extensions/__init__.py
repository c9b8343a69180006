"""Extensions of the port (counterpart of :mod:`chainermn_tpu.extensions`):
the multi-node evaluator, the persistent-value allreduce, the
fault-tolerant checkpointer (npz with the native async writer, and a
``torch.distributed.checkpoint`` backend) and the observation
aggregator."""

from chainermn_tpu_torch.extensions.allreduce_persistent import (
    AllreducePersistent,
)
from chainermn_tpu_torch.extensions.checkpoint import (
    MultiNodeCheckpointer,
    agree_max_common_step,
    create_multi_node_checkpointer,
)
from chainermn_tpu_torch.extensions.dcp_adapter import (
    DcpMultiNodeCheckpointer,
    create_dcp_checkpointer,
)
from chainermn_tpu_torch.extensions.evaluator import (
    create_multi_node_evaluator,
)
from chainermn_tpu_torch.extensions.observation_aggregator import (
    ObservationAggregator,
)

__all__ = ["AllreducePersistent", "DcpMultiNodeCheckpointer",
           "MultiNodeCheckpointer", "ObservationAggregator",
           "agree_max_common_step", "create_dcp_checkpointer",
           "create_multi_node_checkpointer", "create_multi_node_evaluator"]
