"""Differentiable cross-rank functions (counterpart of
:mod:`chainermn_tpu.functions`; the reference ChainerMN's
``chainermn/functions/`` †, SURVEY.md §2.4): the layer that lets the
autograd graph span ranks, for model and pipeline parallelism."""

from chainermn_tpu_torch.functions.collective import (
    allgather,
    allreduce,
    alltoall,
    bcast,
    gather,
    scatter,
)
from chainermn_tpu_torch.functions.point_to_point import (
    pseudo_connect,
    recv,
    send,
    send_recv,
    stream_blocks,
)

__all__ = ["allgather", "allreduce", "alltoall", "bcast", "gather",
           "pseudo_connect", "recv", "scatter", "send", "send_recv",
           "stream_blocks"]
