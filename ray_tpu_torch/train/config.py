"""Train configuration dataclasses (port of ray_tpu/train/config.py).

The counterparts of ray.air's ScalingConfig, RunConfig, FailureConfig and
CheckpointConfig, and of the Result a run returns. Field for field the
reference's, with the same defaults and derived values; ``use_tpu`` and
``tpus_per_worker`` keep their names so a config carries across, and
``worker_resources`` asks for them under the same resource key.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


@dataclasses.dataclass
class ScalingConfig:
    """How to scale training.

      - ``num_workers``: worker processes, one rank each in the process
        group the backend sets up (``TorchBackend``).
      - ``use_tpu`` + ``tpus_per_worker``: accelerators reserved per worker
        (the reference's names; the resource key stays "TPU").
      - ``topology="mesh"``: one worker owns every local device and the
        loop runs sharded over a DeviceMesh (``ray_tpu_torch.parallel``);
        "workers": one process per rank.
      - ``min_workers``: the elastic range (None = a fixed-size gang). A
        restart may come back with fewer workers, never fewer than this.
    """

    num_workers: int = 1
    use_tpu: bool = False
    tpus_per_worker: float | None = None
    cpus_per_worker: float | None = None
    resources_per_worker: dict[str, float] | None = None
    topology: str = "workers"  # "workers" | "mesh"
    placement_strategy: str = "PACK"
    min_workers: int | None = None

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None and self.min_workers < self.num_workers

    def worker_resources(self) -> dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", self.cpus_per_worker if self.cpus_per_worker is not None else 1.0)
        if self.use_tpu:
            res.setdefault("TPU", self.tpus_per_worker if self.tpus_per_worker is not None else 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    """max_failures < 0 = retry without limit."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Top-k retention; ``checkpoint_frequency``: save every N iterations
    (0 = only when asked)."""

    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"  # "max" | "min"
    checkpoint_frequency: int = 0


@dataclasses.dataclass
class RunConfig:
    name: str | None = None
    storage_path: str | None = None
    failure_config: FailureConfig | None = None
    checkpoint_config: CheckpointConfig | None = None
    # Stop criterion: {metric: threshold}, or a callable result -> bool.
    stop: Any = None

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.expanduser("~/ray_tpu_results")
        name = self.name or "train_run"
        return os.path.join(base, name)


@dataclasses.dataclass
class Result:
    """Outcome of a run."""

    metrics: dict[str, Any]
    checkpoint: "Any | None"  # Checkpoint
    path: str
    metrics_history: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    error: Exception | None = None
    config: dict[str, Any] | None = None

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []
