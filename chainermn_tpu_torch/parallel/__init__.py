"""The parallelism library of the port (counterpart of
:mod:`chainermn_tpu.parallel`), so far: the differentiable collectives
over a process group (:mod:`.collectives`), the tensor-parallel layers
(:mod:`.tensor`), ZeRO optimizer-state sharding (:mod:`.zero`), FSDP
parameter and state sharding on DTensors (:mod:`.fsdp`), rank meshes
(:mod:`.mesh`), the pipeline engines, GPipe (plain, interleaved,
heterogeneous) and 1F1B (:mod:`.pipeline`), the ParallelPlan and its
spec layer (:mod:`.plan`, :mod:`.plan_specs`), sequence parallelism:
ring attention (:mod:`.ring_attention`), Ulysses (:mod:`.ulysses`) and
sliding-window attention (:mod:`.local_attention`), expert
parallelism (:mod:`.moe`), the gradient-reduction schedules
(:mod:`.reduction_schedule`; the two-level, staged and int8 wires they
run on are in :mod:`.collectives`), the composition DSL and its executor
(:mod:`.composition`), the α–β cost model of composed schedules
(:mod:`.cost_model`) and the background-thread staleness-1 reducer
(:mod:`.async_host`)."""

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
from chainermn_tpu_torch.parallel.async_host import AsyncHostGradReducer
from chainermn_tpu_torch.parallel.composition import (
    Composition,
    CompositionError,
    Stage,
    compile_schedule,
    derive_compositions,
    parse_signature,
    predicted_collectives,
    reduce_composed,
    schedule_candidates,
    validate_composition,
    zero_composition,
)
from chainermn_tpu_torch.parallel.fsdp import (
    create_fsdp_train_state,
    fsdp_shardings,
    make_fsdp_train_step,
)
from chainermn_tpu_torch.parallel.local_attention import (
    sliding_window_attention_local,
)
from chainermn_tpu_torch.parallel.mesh import (
    MeshTopology,
    best_mesh_shape,
    make_mesh,
)
from chainermn_tpu_torch.parallel.moe import (
    dispatch_einsum,
    dispatch_sort,
    load_balancing_loss,
    make_expert_params,
    moe_capacity,
    moe_layer_local,
    record_moe_dispatch,
    resolve_dispatch_impl,
    resolve_expert_parallel,
    route_slots,
    routing_stats,
    top1_route,
    topk_route,
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
from chainermn_tpu_torch.parallel.plan import (
    ParallelPlan,
    PipelinePlanSpec,
    PlanTrainState,
)
from chainermn_tpu_torch.parallel.plan_specs import (
    CANONICAL_AXES,
    AxisSpec,
    moe_plan_axis,
)
from chainermn_tpu_torch.parallel.reduction_schedule import (
    SCHEDULES,
    MeasuredComposedReducer,
    OverlappedBucketReducer,
    bucket_partition,
    reduce_tree,
    resolve_schedule,
)
from chainermn_tpu_torch.parallel.ring_attention import (
    make_ring_attention,
    ring_attention_local,
    seq_ring_attention_local,
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
    tp_plan_axis,
    tp_slice,
)
from chainermn_tpu_torch.parallel.ulysses import (
    make_ulysses_attention,
    ulysses_attention_local,
)
from chainermn_tpu_torch.parallel.zero import (
    ZeroShardOptimizer,
    zero_gather_updates,
    zero_grad_scatter,
    zero_param_chunk,
    zero_plan_axis,
    zero_shard_optimizer,
    zero_stacked_init,
    zero_state_specs,
)

__all__ = ["AsyncHostGradReducer", "AxisSpec", "CANONICAL_AXES",
           "Composition", "CompositionError", "MeasuredComposedReducer",
           "MeshTopology", "OverlappedBucketReducer", "ParallelPlan",
           "PipelinePlanSpec", "PlanTrainState", "SCHEDULES", "Stage",
           "ZeroShardOptimizer", "compile_schedule", "derive_compositions",
           "parse_signature", "predicted_collectives", "reduce_composed",
           "schedule_candidates", "validate_composition",
           "zero_composition",
           "allgather", "allreduce", "alltoall", "axes_bound", "axis_index",
           "axis_size_of", "bcast", "best_mesh_shape", "bucket_partition",
           "column_parallel_dense", "copy_to_tp", "create_fsdp_train_state",
           "dispatch_einsum", "dispatch_sort", "fsdp_shardings", "gather",
           "gather_from_tp", "load_balancing_loss", "make_expert_params",
           "make_fsdp_train_step", "make_mesh", "make_pipeline",
           "make_pipeline_1f1b", "make_pipeline_hetero",
           "make_ring_attention", "make_ulysses_attention", "moe_capacity",
           "moe_layer_local", "moe_plan_axis", "pipe_plan_axis",
           "pipeline_1f1b_local", "pipeline_hetero_local", "pipeline_local", "pipeline_total_ticks", "ppermute",
           "record_moe_dispatch", "reduce_from_tp", "reduce_scatter",
           "reduce_tree", "resolve_schedule",
           "resolve_dispatch_impl", "resolve_expert_parallel",
           "ring_attention_local", "route_slots", "routing_stats",
           "row_parallel_dense", "scatter", "seq_ring_attention_local",
           "shard_qkv_columns", "shift", "sliding_window_attention_local",
           "stack_interleaved_stage_params", "stack_stage_params",
           "stack_tp_params", "top1_route", "topk_route", "tp_attention",
           "tp_mlp", "tp_plan_axis", "tp_slice", "ulysses_attention_local", "unscale_replicated_grads",
           "zero_gather_updates", "zero_grad_scatter", "zero_param_chunk",
           "zero_plan_axis", "zero_shard_optimizer", "zero_stacked_init",
           "zero_state_specs"]
