"""ray_tpu_torch.train — the Train backend over torch.distributed (port of
ray_tpu.train without the trainer).

    from ray_tpu_torch.train import (TorchBackend, TorchConfig, ScalingConfig,
                                     RunConfig, Checkpoint, CheckpointManager,
                                     get_context, torch_utils)

What needs no runtime is here: the configs, checkpoints and their top-k
manager, the session a loop reads, the backend that sets up a worker's
process group, and the gradient and parameter sync of a data-parallel
loop. ``JaxTrainer``'s counterpart and its worker group start workers as
actors, and ``report`` is an actor call: they come on the task/actor
core (``ray_tpu_torch.init`` / ``remote``) in ROADMAP.md §1 item 6c.
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
