"""ray_tpu_torch.train — distributed training over torch.distributed (port
of ray_tpu.train).

    from ray_tpu_torch.train import (TorchTrainer, TorchBackend, TorchConfig,
                                     ScalingConfig, RunConfig, Checkpoint,
                                     report, get_checkpoint, get_context,
                                     torch_utils)

``TorchTrainer`` (ray_tpu's JaxTrainer) runs a loop on a gang of worker
actors of the task/actor core; each worker's ``TorchBackend`` setup
starts its process group, ``report`` sends metrics and checkpoints to
the run's state actor, and ``torch_utils`` syncs parameters and
gradients of a data-parallel loop.
"""

from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train.backend import Backend, BackendConfig, TorchBackend, TorchConfig
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    make_temp_checkpoint_dir,
    report,
)
from ray_tpu_torch.train.trainer import TorchTrainer

__all__ = [
    "Backend",
    "BackendConfig",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchBackend",
    "TorchConfig",
    "TorchTrainer",
    "TrainContext",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "load_pytree",
    "make_temp_checkpoint_dir",
    "report",
    "save_pytree",
    "torch_utils",
]
