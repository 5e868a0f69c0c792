"""ray_tpu_torch.serve: model serving on the actor runtime.

Counterpart of the reference's python/ray/serve (SURVEY.md §3.5):
@serve.deployment classes scale as replica actors under a controller's
reconcile loop; DeploymentHandles route with power-of-two-choices; an
aiohttp proxy provides HTTP ingress; autoscaling follows ongoing-request
load."""

from ray_tpu_torch.serve.api import (
    build,
    delete,
    get_app_handle,
    get_deployment_handle,
    get_grpc_port,
    get_proxy_port,
    run,
    run_from_config,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.deployment import (
    Application,
    AutoscalingConfig,
    Deployment,
    DeploymentConfig,
    deployment,
)
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.replica import ReplicaContext, get_replica_context
from ray_tpu_torch.serve.scheduler import (
    ContinuousBatcher,
    LatencyModel,
    get_request_deadline,
)

__all__ = [
    "batch",
    "ContinuousBatcher",
    "LatencyModel",
    "get_request_deadline",
    "get_multiplexed_model_id",
    "multiplexed",
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_grpc_port",
    "get_proxy_port",
    "get_app_handle",
    "get_replica_context",
    "ReplicaContext",
    "run",
    "run_from_config",
    "build",
    "shutdown",
    "start",
    "status",
]
