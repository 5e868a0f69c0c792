"""Train configuration dataclasses (port of ray_tpu/train/config.py).

The counterparts of ray.air's ScalingConfig, RunConfig, FailureConfig and
CheckpointConfig, and of the Result a run returns. Field for field the
reference's, with the same defaults and derived values, except the
accelerator: ``use_gpu`` and ``gpus_per_worker`` (ray.train's own names,
as ``num_gpus=`` is the core's option) ask for the port's chip resource,
"GPU"; ray_tpu's ``use_tpu`` and ``tpus_per_worker`` are taken as their
aliases, so a config carries across.
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
      - ``use_gpu`` + ``gpus_per_worker``: GPUs reserved per worker (the
        "GPU" resource; the lease pins CUDA_VISIBLE_DEVICES). ``use_tpu``
        and ``tpus_per_worker`` are aliases.
      - ``topology="mesh"``: one worker owns every local device and the
        loop runs sharded over a DeviceMesh (``ray_tpu_torch.parallel``);
        "workers": one process per rank.
      - ``min_workers``: the elastic range (None = a fixed-size gang). A
        restart may come back with fewer workers, never fewer than this.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float | None = None
    cpus_per_worker: float | None = None
    resources_per_worker: dict[str, float] | None = None
    topology: str = "workers"  # "workers" | "mesh"
    placement_strategy: str = "PACK"
    min_workers: int | None = None
    use_tpu: dataclasses.InitVar[bool | None] = None
    tpus_per_worker: dataclasses.InitVar[float | None] = None

    def __post_init__(self, use_tpu, tpus_per_worker):
        if use_tpu is not None:
            self.use_gpu = self.use_gpu or bool(use_tpu)
        if tpus_per_worker is not None and self.gpus_per_worker is None:
            self.gpus_per_worker = tpus_per_worker

    @property
    def elastic(self) -> bool:
        return self.min_workers is not None and self.min_workers < self.num_workers

    def worker_resources(self) -> dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", self.cpus_per_worker if self.cpus_per_worker is not None else 1.0)
        if self.use_gpu:
            res.setdefault("GPU", self.gpus_per_worker if self.gpus_per_worker is not None else 1.0)
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
