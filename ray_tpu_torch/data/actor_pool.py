"""Actor-pool execution for class-UDF map stages (port of
ray_tpu/data/actor_pool.py).

Counterpart of the reference's ActorPoolMapOperator (reference:
python/ray/data/_internal/execution/operators/actor_pool_map_operator.py
— a managed pool of actors running map tasks, with min/max size,
backlog-driven scale-up, idle scale-down, and restart-on-death). The
point of actors here is AMORTIZED SETUP: a class UDF (e.g. a model
loaded onto the card) is constructed once per pool worker and reused
across blocks, instead of once per task.

Pool lifetime is the stage execution (the reference's pool is owned by
its operator the same way); workers die with the stage.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterator

import cloudpickle


@dataclass
class ActorPoolStrategy:
    """compute= argument for Dataset.map_batches (reference:
    ray.data.ActorPoolStrategy)."""

    min_size: int = 1
    max_size: "int | None" = None
    idle_timeout_s: float = 30.0
    max_restarts: int = 2
    # None = wait as long as the block takes (matches the stateless
    # task path); set to bound a stuck UDF.
    block_timeout_s: "float | None" = None
    # Per-actor resource request (e.g. {"GPU": 1} to pin one card per
    # pool worker).
    resources: "dict | None" = None
    num_cpus: float = 1.0


def resolve_strategy(compute) -> ActorPoolStrategy:
    if isinstance(compute, ActorPoolStrategy):
        return compute
    if compute in ("actors", "actor"):
        return ActorPoolStrategy()
    raise ValueError(
        f"compute must be 'actors' or an ActorPoolStrategy, got "
        f"{compute!r}")


class ActorPool:
    """A stage's worker pool: ordered map over inputs with bounded
    in-flight work, backlog-driven growth, idle shrink, and
    restart-on-death resubmission."""

    def __init__(self, strategy: ActorPoolStrategy, stage_ops: tuple,
                 parallelism: int):
        import ray_tpu_torch

        self.strategy = strategy
        self.max_size = strategy.max_size or max(strategy.min_size,
                                                 parallelism)
        self._ops_blob = cloudpickle.dumps(list(stage_ops))
        self._worker_cls = ray_tpu_torch.remote(
            num_cpus=strategy.num_cpus,
            resources=strategy.resources or None,
        )(_StageWorker)
        self._actors: list = []
        self.stats = {"spawned": 0, "killed_idle": 0, "restarts": 0,
                      "peak_size": 0}
        for _ in range(max(1, strategy.min_size)):
            self._spawn()

    def _spawn(self):
        a = self._worker_cls.remote(self._ops_blob)
        self._actors.append(a)
        self.stats["spawned"] += 1
        self.stats["peak_size"] = max(self.stats["peak_size"],
                                      len(self._actors))
        return a

    def map(self, inputs: list) -> Iterator[list]:
        """Yield each input's output block-list in submission order."""
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import (ActorDiedError, RayTpuError,
                                        WorkerCrashedError)

        idle: deque = deque((a, time.monotonic()) for a in self._actors)
        pending: dict[int, tuple] = {}  # idx -> (ref, actor, attempts, src)
        results: dict[int, list] = {}   # harvested out-of-order outputs
        next_submit = next_yield = 0
        n = len(inputs)

        def harvest(idx: int, out) -> None:
            _ref, actor, _att, _src = pending.pop(idx)
            results[idx] = out
            idle.append((actor, time.monotonic()))

        while next_yield < n:
            backlog = n - next_submit
            # Scale up: work outpaces the pool (reference: the pool
            # grows while the operator has queued bundles and capacity).
            if (not idle and backlog > 0
                    and len(self._actors) < self.max_size):
                idle.append((self._spawn(), time.monotonic()))
            # Scale down: actors idle past the timeout (keep min_size).
            while (len(idle) > 0
                   and len(self._actors) > self.strategy.min_size
                   and time.monotonic() - idle[0][1]
                   > self.strategy.idle_timeout_s):
                a, _t = idle.popleft()
                self._kill(a)
                self.stats["killed_idle"] += 1
            while next_submit < n and idle:
                a, _t = idle.popleft()
                pending[next_submit] = (a.run.remote(inputs[next_submit]),
                                        a, 0, inputs[next_submit])
                next_submit += 1
            if next_yield in results:
                yield results.pop(next_yield)
                next_yield += 1
                continue
            # Harvest whatever finished (any order) so completed
            # actors return to idle instead of looking busy behind a
            # slow head-of-line block (which would ratchet redundant
            # spawns up to max_size).
            refs = {pending[i][0]: i for i in pending}
            try:
                ready, _ = ray_tpu_torch.wait(list(refs), num_returns=1,
                                        timeout=self.strategy.block_timeout_s)
            except Exception:
                ready = [pending[next_yield][0]]
            if not ready:
                _ref, a, attempts, _src = pending[next_yield]
                raise RayTpuError(
                    f"actor-pool block exceeded block_timeout_s="
                    f"{self.strategy.block_timeout_s}")
            for r in ready:
                idx = refs[r]
                _ref, a, attempts, src = pending[idx]
                try:
                    out = ray_tpu_torch.get(r)
                except (ActorDiedError, WorkerCrashedError) as e:
                    # Worker died mid-block: replace it and replay the
                    # block (reference: restart_on_death +
                    # resubmission).
                    self._forget(a)
                    if attempts >= self.strategy.max_restarts:
                        raise RayTpuError(
                            f"actor-pool block failed after {attempts} "
                            f"restarts: {e}") from e
                    self.stats["restarts"] += 1
                    na = self._spawn()
                    pending[idx] = (na.run.remote(src), na,
                                    attempts + 1, src)
                    continue
                harvest(idx, out)

    def _forget(self, actor) -> None:
        try:
            self._actors.remove(actor)
        except ValueError:
            pass

    def _kill(self, actor) -> None:
        import ray_tpu_torch

        self._forget(actor)
        try:
            ray_tpu_torch.kill(actor)
        except Exception:
            pass

    def shutdown(self) -> None:
        for a in list(self._actors):
            self._kill(a)


class _StageWorker:
    """One pool worker: holds the stage's fused ops with class UDFs
    instantiated ONCE, then maps blocks through them."""

    def __init__(self, ops_blob: bytes):
        self._ops = cloudpickle.loads(ops_blob)
        self._built = False

    def _build(self) -> None:
        from ray_tpu_torch.data.executor import MapBatches

        for op in self._ops:
            if isinstance(op, MapBatches) and op.fn_constructor is not None:
                inst = op.fn_constructor()
                op.fn = inst if callable(inst) else inst.__call__
                op.fn_constructor = None
        self._built = True

    def run(self, source) -> list:
        from ray_tpu_torch.data.executor import run_fused_stage

        if not self._built:
            self._build()
        return run_fused_stage(source, list(self._ops))
