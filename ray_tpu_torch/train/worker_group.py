"""Worker group: the gang of training worker actors (port of
ray_tpu/train/worker_group.py).

Counterpart of Ray Train's WorkerGroup and BackendExecutor. Workers are
actors on the task/actor core, gang-scheduled through a placement group
built from ScalingConfig when there is more than one. Each TrainWorker
runs the backend's ``on_worker_setup`` (``TorchBackend``: the process
group, the card of its lease) in its constructor, then the user's loop
in a TrainSession whose ``report`` calls the run's RunStateActor.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import CheckpointConfig, ScalingConfig
from ray_tpu_torch.util.placement_group import PlacementGroup, placement_group, remove_placement_group


@ray_tpu_torch.remote(num_cpus=0)
class RunStateActor:
    """Collects worker reports; owns checkpoint registration (Ray Train's
    result queue and checkpoint handling, folded into one state actor as
    in ray_tpu)."""

    def __init__(self, storage_path: str, ckpt_cfg: CheckpointConfig | None):
        ckpt_cfg = ckpt_cfg or CheckpointConfig()
        self.manager = CheckpointManager(
            storage_path,
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        self.history: list[dict] = []
        self.storage_path = storage_path
        self._run_info: dict | None = None

    def set_run_info(self, name: str, num_workers: int) -> bool:
        """Register this run in the cluster KV so the dashboard's Train
        page can list live/finished runs (reference:
        dashboard/modules/train — run registry fed by the controller)."""
        import time as _time

        self._run_info = {
            "name": name, "status": "RUNNING",
            "num_workers": num_workers, "storage": self.storage_path,
            "started_at": _time.time(), "iterations": 0,
            "last_metrics": {},
        }
        self._publish()
        return True

    def finish_run(self, status: str, error: "str | None" = None) -> bool:
        if self._run_info is not None:
            self._run_info["status"] = status
            if error:
                self._run_info["error"] = error
            self._publish()
        return True

    def _publish(self) -> None:
        import json as _json

        if self._run_info is None:
            return
        info = dict(self._run_info,
                    iterations=len(self.history),
                    last_metrics=self.history[-1] if self.history else {},
                    best_checkpoint=self.best_checkpoint_path())
        try:
            from ray_tpu_torch._private.worker_context import global_runtime

            global_runtime().kv_put(
                info["name"], _json.dumps(info, default=str).encode(),
                ns="__train__")
        except Exception:
            pass  # registry is best-effort observability

    def report(self, rank: int, iteration: int, metrics: dict, ckpt_staging_path: str | None):
        if ckpt_staging_path is not None:
            self.manager.register(ckpt_staging_path, metrics)
        if rank == 0:
            self.history.append(dict(metrics, training_iteration=iteration))
            self._publish()
        return True

    def get_history(self) -> list[dict]:
        return self.history

    def latest_checkpoint_path(self) -> str | None:
        c = self.manager.latest
        return c.path if c else None

    def best_checkpoint_path(self) -> str | None:
        c = self.manager.best
        return c.path if c else None


@ray_tpu_torch.remote
class TrainWorker:
    """One training worker process. Its constructor runs the backend's
    worker setup on the worker's lease (TorchBackend: the rank's env
    vars, its card, the process group)."""

    def __init__(self, rank: int, world_size: int, group_name: str, backend_config=None):
        self.rank = rank
        self.world_size = world_size
        self.group_name = group_name
        if backend_config is not None:
            backend = backend_config.backend_cls()()
            # Dispatch on arity, not exception type: a TypeError raised
            # INSIDE setup must propagate, not trigger a silent re-run.
            params = inspect.signature(backend.on_worker_setup).parameters
            if len(params) >= 4:
                backend.on_worker_setup(rank, world_size, group_name, backend_config)
            else:
                backend.on_worker_setup(rank, world_size, group_name)

    def run(
        self,
        fn: Callable,
        config: dict | None,
        collector,
        experiment_name: str,
        latest_ckpt_path: str | None,
        dataset_shards: dict[str, Any] | None,
        start_iteration: int = 0,
    ):
        from ray_tpu_torch.train import session as session_mod

        session = session_mod.TrainSession(
            rank=self.rank,
            world_size=self.world_size,
            local_rank=self.rank,
            collector=collector,
            experiment_name=experiment_name,
            group_name=self.group_name,
            latest_checkpoint=Checkpoint(latest_ckpt_path) if latest_ckpt_path else None,
            dataset_shards=dataset_shards,
            start_iteration=start_iteration,
        )
        session_mod.set_session(session)
        try:
            sig = inspect.signature(fn)
            if len(sig.parameters) == 0:
                fn()
            else:
                fn(config or {})
        finally:
            session_mod.set_session(None)
        return self.rank


class WorkerGroup:
    def __init__(
        self,
        scaling_config: ScalingConfig,
        backend_config,
        group_name: str,
    ):
        self.scaling_config = scaling_config
        self.group_name = group_name
        n = scaling_config.num_workers
        res = scaling_config.worker_resources()
        self.pg: PlacementGroup | None = None
        if n > 1:
            # Fail fast if the gang can never fit (reference analogue:
            # BackendExecutor's resource validation before PG wait).
            total = ray_tpu_torch.cluster_resources()
            for k, v in res.items():
                if total.get(k, 0.0) < v * n:
                    raise ray_tpu_torch.exceptions.PlacementGroupUnschedulableError(
                        f"ScalingConfig needs {v * n} {k} "
                        f"({n} workers x {v}), cluster has {total.get(k, 0.0)}"
                    )
            self.pg = placement_group([dict(res)] * n, strategy=scaling_config.placement_strategy)
            if not self.pg.wait(120):
                remove_placement_group(self.pg)
                raise ray_tpu_torch.exceptions.PlacementGroupUnschedulableError(
                    f"placement group for {n} training workers not ready after 120s"
                )
        self.workers = []
        for rank in range(n):
            opts: dict = {
                "resources": {k: v for k, v in res.items() if k != "CPU"},
                "num_cpus": res.get("CPU", 1),
            }
            if self.pg is not None:
                opts["scheduling_strategy"] = ray_tpu_torch.PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=rank
                )
            self.workers.append(
                TrainWorker.options(**opts).remote(rank, n, group_name, backend_config)
            )

    def run(self, fn, config, collector, experiment_name, latest_ckpt, shards_per_worker, start_iteration=0):
        return [
            w.run.remote(
                fn,
                config,
                collector,
                experiment_name,
                latest_ckpt,
                shards_per_worker[i] if shards_per_worker else None,
                start_iteration,
            )
            for i, w in enumerate(self.workers)
        ]

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
