"""Per-worker training session: ranks, the checkpoint to resume from, the
dataset shards and the process group (port of ray_tpu/train/session.py).

``report`` is a synchronous actor call to the run's RunStateActor
(``train.worker_group``), which registers rank 0's checkpoint with the
run's CheckpointManager: the loop stages a checkpoint in a directory of
its own (``make_temp_checkpoint_dir``) and the manager moves it into the
run's storage.
"""

from __future__ import annotations

import tempfile
from typing import Any, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_session: "TrainSession | None" = None


class TrainSession:
    def __init__(
        self,
        rank: int,
        world_size: int,
        local_rank: int,
        collector=None,  # ActorHandle of the run's RunStateActor
        experiment_name: str = "train_run",
        latest_checkpoint: Checkpoint | None = None,
        dataset_shards: dict[str, Any] | None = None,
        start_iteration: int = 0,
        group_name: str | None = None,
        group=None,
    ):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.collector = collector
        self.experiment_name = experiment_name
        self.group_name = group_name or f"train-{experiment_name}"
        # The process group the sync helpers (torch_utils) use: None is the
        # default group, which TorchBackend.on_worker_setup initialises.
        self.group = group
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        # Non-zero after failure recovery so training_iteration stays
        # monotonic across restarts.
        self.iteration = start_iteration

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        import ray_tpu_torch

        if self.collector is None:
            raise RuntimeError("train.report needs the run's state actor: run the "
                               "loop through TorchTrainer.fit")
        ckpt_path = None
        if checkpoint is not None:
            # Only rank 0's checkpoint is kept (a data-parallel run's ranks
            # hold the same state).
            if self.rank == 0:
                ckpt_path = checkpoint.path
            self.latest_checkpoint = checkpoint
        # Synchronous actor call: per-worker ordering and backpressure.
        ray_tpu_torch.get(
            self.collector.report.remote(self.rank, self.iteration, metrics, ckpt_path))
        self.iteration += 1

    def get_checkpoint(self) -> Checkpoint | None:
        return self.latest_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        if name not in self.dataset_shards:
            raise KeyError(f"no dataset {name!r} passed to the trainer")
        return self.dataset_shards[name]


class TrainContext:
    def get_world_size(self) -> int:
        return get_session().world_size

    def get_world_rank(self) -> int:
        return get_session().rank

    def get_local_rank(self) -> int:
        return get_session().local_rank

    def get_local_world_size(self) -> int:
        return get_session().world_size  # single-node: local == world

    def get_node_rank(self) -> int:
        return 0

    def get_experiment_name(self) -> str:
        return get_session().experiment_name


def set_session(session: TrainSession | None) -> None:
    global _session
    _session = session


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active — this API must be called inside "
            "train_loop_per_worker"
        )
    return _session


def in_session() -> bool:
    return _session is not None


# --- public API mirrors (ray.train.*) ---


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_context() -> TrainContext:
    return TrainContext()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


def make_temp_checkpoint_dir() -> str:
    """Scratch dir for assembling a checkpoint before report()."""
    return tempfile.mkdtemp(prefix="rtpu_ckpt_stage_")
