"""The parallelism library of the port (counterpart of
:mod:`chainermn_tpu.parallel`), so far: the differentiable collectives
over a process group (:mod:`.collectives`), the tensor-parallel layers
(:mod:`.tensor`), ZeRO optimizer-state sharding (:mod:`.zero`) and FSDP
parameter and state sharding on DTensors (:mod:`.fsdp`). The rest of the
JAX package's ``parallel/`` (the pipeline, the plan, ring/Ulysses/local
attention, MoE, the composition and cost model, the async host plane) is
ROADMAP queue 1, items 6.3-6.8."""

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
from chainermn_tpu_torch.parallel.fsdp import (
    create_fsdp_train_state,
    fsdp_shardings,
    make_fsdp_train_step,
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
from chainermn_tpu_torch.parallel.zero import (
    ZeroShardOptimizer,
    zero_shard_optimizer,
)

__all__ = ["ZeroShardOptimizer", "allgather", "allreduce", "alltoall",
           "axes_bound", "axis_index", "axis_size_of", "bcast",
           "column_parallel_dense", "copy_to_tp", "create_fsdp_train_state",
           "fsdp_shardings", "gather", "gather_from_tp",
           "make_fsdp_train_step", "ppermute", "reduce_from_tp",
           "reduce_scatter", "row_parallel_dense", "scatter",
           "shard_qkv_columns", "shift", "stack_tp_params", "tp_attention",
           "tp_mlp", "tp_slice", "zero_shard_optimizer"]
