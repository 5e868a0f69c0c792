"""TorchTrainer: the data-parallel trainer (the counterpart of
ray_tpu/train/trainer.py's JaxTrainer, named like TorchBackend and
TorchConfig; ray_tpu.train.torch.TorchTrainer, the reference's torch
integration, maps onto it too).

A standalone controller in the manner of Ray Train v2: ``fit()`` starts a
RunStateActor and a WorkerGroup of TrainWorker actors on the task/actor
core, runs ``train_loop_per_worker`` on each, and returns a Result.
FailureConfig restarts an attempt from the latest checkpoint with the
iteration count carried on; with ``min_workers`` a restart re-fits the
gang to what the cluster can place. Each worker's backend setup
(``TorchBackend``) starts its process group: NCCL on the card, gloo on
the CPU (``TorchConfig(device=...)``). Where the config names no
rendezvous, each attempt gets a file store under the run's storage path
(the checkpoints' storage, which every worker reads).
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.worker_group import RunStateActor, WorkerGroup


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: dict | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        backend_config=None,
        datasets: dict[str, Any] | None = None,
    ):
        from ray_tpu_torch.train.backend import TorchConfig

        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config if backend_config is not None else TorchConfig()
        self.datasets = datasets or {}

    # ------------------------------------------------------------------

    def _dataset_shards(self, n: int) -> list[dict[str, Any]] | None:
        """Split datasets across workers (Ray Train's DataConfig +
        streaming_split)."""
        if not self.datasets:
            return None
        shards: list[dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                for i, shard in enumerate(ds.streaming_split(n)):
                    shards[i][name] = shard
            elif hasattr(ds, "split"):
                for i, shard in enumerate(ds.split(n)):
                    shards[i][name] = shard
            else:
                for i in range(n):
                    shards[i][name] = ds
        return shards

    @staticmethod
    def _max_placeable_workers(scaling: ScalingConfig) -> int:
        """How many worker gangs the cluster can place right now, judged
        against TOTAL per-node capacity of alive nodes (Ray Train v2's
        scaling policy)."""
        per_worker = scaling.worker_resources()
        if not any(v > 0 for v in per_worker.values()):
            return scaling.num_workers  # zero-demand workers always fit
        fit = 0
        try:
            for node in ray_tpu_torch.nodes():
                if not node.get("alive", True):
                    continue
                total = dict(node.get("resources", {}))
                while all(total.get(k, 0.0) >= v for k, v in per_worker.items()):
                    for k, v in per_worker.items():
                        total[k] = total.get(k, 0.0) - v
                    fit += 1
        except Exception:
            return scaling.num_workers
        return fit

    def _attempt_backend(self, storage: str, group_name: str):
        """The backend config for one attempt: a TorchConfig that names no
        rendezvous gets a file store of its own under the run's storage
        path (the store is the attempt's: a restart never joins a dead
        attempt's group)."""
        from ray_tpu_torch.train.backend import TorchConfig

        cfg = self.backend_config
        if isinstance(cfg, TorchConfig) and cfg.coordinator_address is None:
            os.makedirs(storage, exist_ok=True)
            store = os.path.join(os.path.abspath(storage), f".rendezvous-{group_name}")
            cfg = dataclasses.replace(cfg, coordinator_address=f"file://{store}")
        return cfg

    def fit(self) -> Result:
        ray_tpu_torch.api.auto_init()
        scaling = self.scaling_config
        if scaling.topology == "mesh" and scaling.num_workers != 1:
            raise ValueError("topology='mesh' uses a single controller worker")
        name = self.run_config.name or f"TorchTrainer_{uuid.uuid4().hex[:6]}"
        storage = self.run_config.resolved_storage_path()
        failure_config = self.run_config.failure_config or FailureConfig()
        ckpt_config = self.run_config.checkpoint_config or CheckpointConfig()

        state = RunStateActor.remote(storage, ckpt_config)
        state.set_run_info.remote(name, scaling.num_workers)
        failures_left = failure_config.max_failures
        latest_ckpt: str | None = None
        start_iteration = 0
        error: Exception | None = None

        while True:
            # Attempt-unique group name: the process group's rendezvous
            # is keyed by it, so a retry never reads the previous (dead)
            # attempt's rendezvous state.
            group_name = f"train-{name}-{uuid.uuid4().hex[:8]}"
            backend_config = self._attempt_backend(storage, group_name)
            group = WorkerGroup(scaling, backend_config, group_name=group_name)
            try:
                refs = group.run(
                    self.train_loop_per_worker,
                    self.train_loop_config,
                    state,
                    name,
                    latest_ckpt,
                    self._dataset_shards(scaling.num_workers),
                    start_iteration,
                )
                ray_tpu_torch.get(refs)
                error = None
                break
            except RayTpuError as e:  # covers actor death, crashes, task errors
                error = e
                latest_ckpt = ray_tpu_torch.get(state.latest_checkpoint_path.remote())
                start_iteration = len(ray_tpu_torch.get(state.get_history.remote()))
                if failures_left == 0:
                    break
                if failures_left > 0:
                    failures_left -= 1
                if scaling.elastic:
                    # Elastic restart (Ray Train v2's scaling policy and
                    # failure handling): re-fit the gang to what the
                    # cluster can place now, down to min_workers. The next
                    # attempt's process group has the new world size.
                    fit = self._max_placeable_workers(scaling)
                    new_n = max(scaling.min_workers, min(scaling.num_workers, fit))
                    if new_n != scaling.num_workers:
                        scaling = dataclasses.replace(scaling, num_workers=new_n)
                time.sleep(0.5)  # let worker-death cleanup settle
            finally:
                group.shutdown()
                _remove_file_store(backend_config)

        state.finish_run.remote("ERRORED" if error is not None else
                                "FINISHED",
                                repr(error) if error is not None else None)
        history = ray_tpu_torch.get(state.get_history.remote())
        best = ray_tpu_torch.get(state.best_checkpoint_path.remote())
        result = Result(
            metrics=history[-1] if history else {},
            checkpoint=Checkpoint(best) if best else None,
            path=storage,
            metrics_history=history,
            error=error,
        )
        if error is not None:
            raise error
        return result


def _remove_file_store(cfg) -> None:
    """Delete an attempt's file-store rendezvous once its workers are gone."""
    addr = getattr(cfg, "coordinator_address", None) or ""
    if addr.startswith("file://"):
        try:
            os.remove(addr[len("file://"):])
        except OSError:
            pass
