"""Device mesh, sharding rules and collectives over torch.distributed
(counterpart of perceptor_tpu/parallel/__init__.py).

Axis conventions (JAX's):
    data     batch / cutouts / the CFG pair  (data parallel)
    tensor   channels / attention heads      (tensor parallel)
    context  flattened H*W image tokens      (sequence/context parallel)
    stage    pipeline stages
"""


from perceptor_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_TENSOR,
    AXIS_CONTEXT,
    AXIS_STAGE,
    create_mesh,
    create_hybrid_mesh,
    global_batch_from_local,
    group_by_granule,
    initialize_distributed,
)
from perceptor_tpu_torch.parallel.pipeline import pipeline, pipeline_body
from perceptor_tpu_torch.parallel.plan import (
    ContextParallelPlan,
    RoutingReport,
    context_parallel,
    current_plan,
    explain,
    plan_for_mesh,
    record_routing,
    shard_spatial,
)
from perceptor_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_self_attention,
)
from perceptor_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_self_attention,
)
from perceptor_tpu_torch.parallel.partition import (
    PartitionRules,
    SD_TENSOR_PARALLEL_RULES,
    partition_params,
    shard_params,
    shard_batch,
    shard_for_sampling,
    replicate,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_TENSOR",
    "AXIS_CONTEXT",
    "create_mesh",
    "create_hybrid_mesh",
    "global_batch_from_local",
    "group_by_granule",
    "initialize_distributed",
    "PartitionRules",
    "SD_TENSOR_PARALLEL_RULES",
    "partition_params",
    "shard_params",
    "shard_batch",
    "shard_for_sampling",
    "replicate",
    "ring_attention",
    "ring_self_attention",
    "ulysses_attention",
    "ulysses_self_attention",
    "AXIS_STAGE",
    "pipeline",
    "pipeline_body",
    "ContextParallelPlan",
    "context_parallel",
    "current_plan",
    "explain",
    "plan_for_mesh",
    "record_routing",
    "RoutingReport",
    "shard_spatial",
]
