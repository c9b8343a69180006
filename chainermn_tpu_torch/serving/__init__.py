"""Continuous-batching serving of the port (counterpart of
:mod:`chainermn_tpu.serving`): a paged-KV slot engine with a bucketed
prefill, greedy decode through the paged flash-decoding CUDA kernel, and
an FCFS / prefill-priority admission scheduler with tokens/s and latency
accounting; tensor-parallel decode (``ServingEngine(mesh=)``) over the
shards that :func:`shard_lm_params` cuts."""

from chainermn_tpu_torch.models.transformer import DECODE_ATTEND_IMPLS
from chainermn_tpu_torch.serving.engine import (
    ServingEngine,
    shard_lm_params,
    tp_local_model,
    unshard_lm_params,
)
from chainermn_tpu_torch.serving.kv_blocks import (
    BlockAllocator,
    default_num_blocks,
    init_serving_cache,
)
from chainermn_tpu_torch.serving.scheduler import POLICIES, Request, Scheduler

__all__ = [
    "ServingEngine",
    "Scheduler",
    "Request",
    "BlockAllocator",
    "DECODE_ATTEND_IMPLS",
    "POLICIES",
    "default_num_blocks",
    "init_serving_cache",
    "shard_lm_params",
    "tp_local_model",
    "unshard_lm_params",
]
