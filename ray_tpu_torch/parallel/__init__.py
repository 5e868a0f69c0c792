"""ray_tpu_torch.parallel: mesh-first parallelism over torch.distributed
(port of ray_tpu.parallel).

Strategies are mesh dims plus sharding rules, as in ray_tpu: a
``DeviceMesh`` with named dims (``MeshConfig``), layouts written as
``P`` specs and turned into DTensor placements (``to_placements``),
parameters as DTensors (``shard_params``). DTensor's redistributions do
what GSPMD's inserted collectives do there; the ring and the pipeline
shift tensors between ranks with ``batch_isend_irecv``.
"""

from ray_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPELINE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    BATCH_AXES,
    DEFAULT_AXIS_ORDER,
    MeshConfig,
    batch_sharding,
    mesh_axis_size,
    single_device_mesh,
)
from ray_tpu_torch.parallel.pipeline import (
    pipeline_last_to_all,
    pipeline_stage_params,
    pipelined_apply,
    spmd_pipeline,
)
from ray_tpu_torch.parallel.sharding import (
    P,
    constrain,
    fsdp_spec_for,
    infer_param_specs,
    make_shardings,
    replicated,
    shard_params,
    to_placements,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_EXPERT",
    "AXIS_FSDP",
    "AXIS_PIPELINE",
    "AXIS_SEQUENCE",
    "AXIS_TENSOR",
    "BATCH_AXES",
    "DEFAULT_AXIS_ORDER",
    "MeshConfig",
    "batch_sharding",
    "mesh_axis_size",
    "single_device_mesh",
    "pipeline_last_to_all",
    "pipeline_stage_params",
    "pipelined_apply",
    "spmd_pipeline",
    "P",
    "constrain",
    "fsdp_spec_for",
    "infer_param_specs",
    "make_shardings",
    "replicated",
    "shard_params",
    "to_placements",
]
