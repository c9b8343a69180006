"""The parallelism library of the port (counterpart of
:mod:`chainermn_tpu.parallel`), so far: the differentiable collectives
over a process group (:mod:`.collectives`) and the tensor-parallel layers
(:mod:`.tensor`). The rest of the JAX package's ``parallel/`` (ZeRO and
FSDP, the pipeline, the plan, ring/Ulysses/local attention, MoE, the
composition and cost model, the async host plane) is ROADMAP queue 1,
items 6.2-6.8."""

from chainermn_tpu_torch.parallel.collectives import (
    allgather,
    allreduce,
    alltoall,
    axes_bound,
    axis_index,
    axis_size_of,
    bcast,
    gather,
    ppermute,
    reduce_scatter,
    scatter,
    shift,
)
from chainermn_tpu_torch.parallel.tensor import (
    column_parallel_dense,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    row_parallel_dense,
    shard_qkv_columns,
    stack_tp_params,
    tp_attention,
    tp_mlp,
    tp_slice,
)

__all__ = ["allgather", "allreduce", "alltoall", "axes_bound", "axis_index",
           "axis_size_of", "bcast", "column_parallel_dense", "copy_to_tp",
           "gather", "gather_from_tp", "ppermute", "reduce_from_tp",
           "reduce_scatter", "row_parallel_dense", "scatter",
           "shard_qkv_columns", "shift", "stack_tp_params", "tp_attention",
           "tp_mlp", "tp_slice"]
