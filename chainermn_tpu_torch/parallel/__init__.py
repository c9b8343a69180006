"""The parallelism library of the port (counterpart of
:mod:`chainermn_tpu.parallel`), so far: the differentiable collectives
over a process group (:mod:`.collectives`), the tensor-parallel layers
(:mod:`.tensor`), ZeRO optimizer-state sharding (:mod:`.zero`), FSDP
parameter and state sharding on DTensors (:mod:`.fsdp`), rank meshes
(:mod:`.mesh`) and the pipeline engines, GPipe (plain, interleaved,
heterogeneous) and 1F1B (:mod:`.pipeline`). The rest of the JAX
package's ``parallel/`` (the plan and its spec providers, ring/Ulysses/
local attention, MoE, the composition and cost model, the async host
plane) is ROADMAP queue 1, items 6.4-6.8."""

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
from chainermn_tpu_torch.parallel.mesh import (
    MeshTopology,
    best_mesh_shape,
    make_mesh,
)
from chainermn_tpu_torch.parallel.pipeline import (
    make_pipeline,
    make_pipeline_1f1b,
    make_pipeline_hetero,
    pipe_plan_axis,
    pipeline_1f1b_local,
    pipeline_hetero_local,
    pipeline_local,
    pipeline_total_ticks,
    stack_interleaved_stage_params,
    stack_stage_params,
    unscale_replicated_grads,
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

__all__ = ["MeshTopology", "ZeroShardOptimizer", "allgather", "allreduce",
           "alltoall", "axes_bound", "axis_index", "axis_size_of", "bcast",
           "best_mesh_shape", "column_parallel_dense", "copy_to_tp",
           "create_fsdp_train_state", "fsdp_shardings", "gather",
           "gather_from_tp", "make_fsdp_train_step", "make_mesh",
           "make_pipeline", "make_pipeline_1f1b", "make_pipeline_hetero",
           "pipe_plan_axis", "pipeline_1f1b_local", "pipeline_hetero_local",
           "pipeline_local", "pipeline_total_ticks", "ppermute",
           "reduce_from_tp", "reduce_scatter", "row_parallel_dense",
           "scatter", "shard_qkv_columns", "shift",
           "stack_interleaved_stage_params", "stack_stage_params",
           "stack_tp_params", "tp_attention", "tp_mlp", "tp_slice",
           "unscale_replicated_grads", "zero_shard_optimizer"]
