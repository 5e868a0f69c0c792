"""Tuner + TuneController: the experiment event loop (port of
ray_tpu/tune/tuner.py). ``Tuner(TorchTrainer(...))`` takes the place of
the reference's ``Tuner(JaxTrainer(...))``: each trial runs the trainer's
``fit()`` inside its trial actor, which takes no lease itself; the
trainer's workers take theirs through ``ScalingConfig(use_gpu=True,
gpus_per_worker=...)``.

Counterpart of the reference's Tuner.fit (tune/tuner.py:312) →
TunerInternal (tune/impl/tuner_internal.py:63) → tune.run (tune/tune.py:267)
→ TuneController.step (tune/execution/tune_controller.py:666), which
manages trial actors (_schedule_trial_actor :964) and routes results
through searchers/schedulers. Redesigned: trials are plain ray_tpu_torch actors
driven by an ObjectRef wait-loop — no separate RayTrialExecutor layer.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import FailureConfig, Result, RunConfig
from ray_tpu_torch.tune.schedulers import ExploitDecision, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trainable import DONE, TRAINING_ITERATION, TrialActor

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class TuneConfig:
    """Reference: tune/tune_config.py TuneConfig."""

    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    search_alg: Searcher | None = None
    scheduler: TrialScheduler | None = None
    time_budget_s: float | None = None
    trial_resources: dict[str, float] | None = None
    reuse_actors: bool = False


class Trial:
    """One hyperparameter configuration's lifecycle
    (reference: tune/experiment/trial.py)."""

    def __init__(self, trial_id: str, config: dict, trial_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.trial_dir = trial_dir
        self.status = PENDING
        self.actor = None
        self.last_result: dict = {}
        self.metrics_history: list[dict] = []
        self.checkpoint_path: str | None = None
        self.num_failures = 0
        self.error: Exception | None = None
        self.experiment_trials: list["Trial"] = []  # back-ref, set by controller

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"


class ResultGrid:
    """Reference: tune/result_grid.py."""

    def __init__(self, results: list[Result], trials: list[Trial], metric: str | None, mode: str):
        self._results = results
        self._trials = trials
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    @property
    def errors(self) -> list[Exception]:
        return [t.error for t in self._trials if t.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(self, metric: str | None = None, mode: str | None = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("pass metric= or set TuneConfig(metric=...)")
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics for r in self._results])


class TuneController:
    """The experiment loop (reference: tune/execution/tune_controller.py:68)."""

    def __init__(
        self,
        trainable: Any,
        param_space: dict | None,
        tune_config: TuneConfig,
        run_config: RunConfig,
    ):
        self.trainable = trainable
        self.tune_config = tune_config
        self.run_config = run_config
        self.experiment_dir = run_config.resolved_storage_path()
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(tune_config.metric, tune_config.mode)
        if tune_config.search_alg is not None:
            self.searcher = tune_config.search_alg
            self.searcher.set_search_properties(tune_config.metric, tune_config.mode, param_space or {})
            self._max_trials = tune_config.num_samples
        else:
            self.searcher = BasicVariantGenerator(param_space, tune_config.num_samples)
            self._max_trials = len(self.searcher)
        failure = run_config.failure_config or FailureConfig()
        self.max_failures_per_trial = failure.max_failures
        ckpt_cfg = run_config.checkpoint_config
        self.checkpoint_frequency = ckpt_cfg.checkpoint_frequency if ckpt_cfg else 0
        self.trials: list[Trial] = []
        self._futures: dict[ray_tpu_torch.ObjectRef, Trial] = {}
        self._deadline = (
            time.monotonic() + tune_config.time_budget_s if tune_config.time_budget_s else None
        )
        # Per-trainable annotation (tune.with_resources) overrides the
        # TuneConfig-wide trial_resources.
        trial_res = (getattr(trainable, "_tune_resources", None)
                     or tune_config.trial_resources or {"num_cpus": 0})
        self._remote_actor_cls = ray_tpu_torch.remote(**trial_res)(TrialActor)

    # ------------------------------------------------------------------

    def _next_trial(self) -> Optional[Trial]:
        if len(self.trials) >= self._max_trials:
            return None
        trial_id = f"{len(self.trials):05d}_{uuid.uuid4().hex[:4]}"
        config = self.searcher.suggest(trial_id)
        if config is None:
            self._max_trials = len(self.trials)
            return None
        import os

        trial = Trial(trial_id, config, os.path.join(self.experiment_dir, f"trial_{trial_id}"))
        self.trials.append(trial)
        for t in self.trials:
            t.experiment_trials = self.trials
        self.scheduler.on_trial_add(trial)
        return trial

    def _start_trial(self, trial: Trial, config: dict | None = None, checkpoint: str | None = None) -> None:
        if config is not None:
            trial.config = config
        trial.actor = self._remote_actor_cls.remote(
            self.trainable,
            trial.config,
            trial.trial_id,
            trial.trial_dir,
            checkpoint if checkpoint is not None else trial.checkpoint_path,
        )
        trial.status = RUNNING
        self._schedule_step(trial)

    def _schedule_step(self, trial: Trial) -> None:
        ref = trial.actor.step.remote()
        self._futures[ref] = trial

    def _stop_actor(self, trial: Trial, save: bool = False) -> None:
        if trial.actor is None:
            return
        try:
            if save:
                trial.checkpoint_path = ray_tpu_torch.get(trial.actor.save.remote(), timeout=30)
            else:
                ray_tpu_torch.get(trial.actor.stop.remote(), timeout=10)
        except RayTpuError:
            pass
        try:
            ray_tpu_torch.kill(trial.actor)
        except RayTpuError:
            pass
        trial.actor = None

    # ------------------------------------------------------------------

    def _live(self) -> int:
        return sum(1 for t in self.trials if t.status == RUNNING)

    def _maybe_fill(self) -> None:
        # Scheduler-demanded terminations first (HyperBand rung losers are
        # PAUSED when the cut happens; the scheduler reaps them here).
        pending_stops = getattr(self.scheduler, "pending_stops", None)
        if pending_stops:
            for t in pending_stops(self.trials):
                if t.status == PAUSED:
                    self._complete(t, t.last_result)
        # Scheduler-gated resumes next (synch PBT exploit cycle).
        resume_decisions = getattr(self.scheduler, "resume_decisions", None)
        if resume_decisions:
            for trial, (cfg, ckpt) in resume_decisions(self.trials).items():
                if ckpt:
                    trial.checkpoint_path = ckpt
                self._start_trial(trial, config=cfg)
        may_resume = getattr(self.scheduler, "may_resume", lambda t: True)
        cap = self.tune_config.max_concurrent_trials or 2**31
        while self._live() < cap:
            paused = next(
                (t for t in self.trials if t.status == PAUSED and may_resume(t)), None
            )
            if paused is not None:
                self._start_trial(paused)
                continue
            trial = self._next_trial()
            if trial is None:
                break
            self._start_trial(trial)

    def _complete(self, trial: Trial, result: dict | None, error: Exception | None = None) -> None:
        trial.status = ERROR if error else TERMINATED
        trial.error = error
        if error is None:
            self._take_latest_checkpoint(trial)
        self.scheduler.on_trial_complete(trial, result)
        self.searcher.on_trial_complete(trial.trial_id, result, error=error is not None)
        self._stop_actor(trial, save=False)

    def _take_latest_checkpoint(self, trial: Trial) -> None:
        """The checkpoint of the trial's last report becomes its Result's.
        The reference keeps the checkpoint of the controller's last save,
        which lags the last report when a scheduler stops the trial, and
        is none without a checkpoint_frequency."""
        if trial.actor is None:
            return
        try:
            path = ray_tpu_torch.get(trial.actor.latest_checkpoint.remote(), timeout=30)
        except RayTpuError:
            return
        if path:
            trial.checkpoint_path = path

    def _handle_result(self, trial: Trial, result: dict) -> None:
        trial.last_result = result
        trial.metrics_history.append(result)
        self.searcher.on_trial_result(trial.trial_id, result)
        if result.get(DONE) or self._stop_criterion(result):
            self._complete(trial, result)
            return
        decision = self.scheduler.on_trial_result(trial, result)
        if isinstance(decision, ExploitDecision):
            self._exploit(trial, decision)
        elif decision == TrialScheduler.STOP:
            self._complete(trial, result)
        elif decision == TrialScheduler.PAUSE:
            self._stop_actor(trial, save=True)
            trial.status = PAUSED
        else:
            freq = self.checkpoint_frequency
            if freq and result.get(TRAINING_ITERATION, 0) % freq == 0:
                try:
                    path = ray_tpu_torch.get(trial.actor.save.remote(), timeout=60)
                    if path:
                        trial.checkpoint_path = path
                except RayTpuError:
                    pass
            self._schedule_step(trial)

    def _exploit(self, trial: Trial, decision: ExploitDecision) -> None:
        """PBT: clone source's checkpoint into `trial` with a mutated config
        (reference: pbt.py _exploit → executor restore)."""
        source = decision.source
        if source.actor is None:
            ckpt = source.checkpoint_path
        else:
            try:
                ckpt = ray_tpu_torch.get(source.actor.save.remote(), timeout=60)
                source.checkpoint_path = ckpt
            except RayTpuError:
                ckpt = source.checkpoint_path
        if ckpt is None:  # nothing to exploit yet
            self._schedule_step(trial)
            return
        self._stop_actor(trial, save=False)
        trial.checkpoint_path = ckpt
        self._start_trial(trial, config=decision.new_config, checkpoint=ckpt)

    def _stop_criterion(self, result: dict) -> bool:
        stop = getattr(self.run_config, "stop", None)
        if stop is None:
            return False
        if callable(stop):
            return bool(stop(result))
        return any(k in result and result[k] >= v for k, v in stop.items())

    def _handle_error(self, trial: Trial, err: Exception) -> None:
        trial.num_failures += 1
        self._stop_actor(trial, save=False)
        retry = (
            self.max_failures_per_trial < 0
            or trial.num_failures <= self.max_failures_per_trial
        )
        if retry:
            self._start_trial(trial)  # restores from trial.checkpoint_path
        else:
            self._complete(trial, None, error=err)

    # ------------------------------------------------------------------

    def run(self) -> list[Trial]:
        while True:
            # Fill at loop top: after the last running trial pauses (synch
            # PBT boundary) there are no futures, but resume_decisions will
            # mint new ones.
            self._maybe_fill()
            if not self._futures:
                break
            if self._deadline is not None and time.monotonic() > self._deadline:
                for t in list(self.trials):
                    if t.status in (RUNNING, PAUSED, PENDING):
                        self._stop_actor(t, save=False)
                        t.status = TERMINATED
                break
            ready, _ = ray_tpu_torch.wait(list(self._futures), num_returns=1, timeout=1.0)
            for ref in ready:
                trial = self._futures.pop(ref)
                if trial.status != RUNNING:
                    continue
                try:
                    result = ray_tpu_torch.get(ref)
                except RayTpuError as e:
                    self._handle_error(trial, e)
                    continue
                result.setdefault(TRAINING_ITERATION, len(trial.metrics_history) + 1)
                result["trial_id"] = trial.trial_id
                result["config"] = trial.config
                self._handle_result(trial, result)
        for t in self.trials:
            self._stop_actor(t, save=False)
        return self.trials


class Tuner:
    """Reference: tune/tuner.py Tuner. `Tuner(trainable).fit() -> ResultGrid`.

    `trainable` may be a function `(config) -> None` using `tune.report`,
    a `Trainable` subclass, or a `TorchTrainer` (its train_loop_config
    is merged with `param_space["train_loop_config"]`)."""

    def __init__(
        self,
        trainable: Any,
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config: RunConfig | None = None,
    ):
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig(name=f"tune_{uuid.uuid4().hex[:6]}")
        from ray_tpu_torch.train.trainer import TorchTrainer

        if isinstance(trainable, TorchTrainer):
            trainable = _trainer_to_trainable(trainable)
        self.trainable = trainable

    def fit(self) -> ResultGrid:
        ray_tpu_torch.api.auto_init()
        controller = TuneController(
            self.trainable, self.param_space, self.tune_config, self.run_config
        )
        trials = controller.run()
        results = [
            Result(
                metrics=t.last_result,
                checkpoint=Checkpoint(t.checkpoint_path) if t.checkpoint_path else None,
                path=t.trial_dir,
                metrics_history=t.metrics_history,
                error=t.error,
                config=t.config,
            )
            for t in trials
        ]
        return ResultGrid(results, trials, self.tune_config.metric, self.tune_config.mode)


def _trainer_to_trainable(trainer) -> Callable:
    """Wrap a TorchTrainer so each trial runs trainer.fit() with the sampled
    `train_loop_config` merged in (reference: BaseTrainer.as_trainable,
    train/base_trainer.py:651ff)."""
    import copy

    def _fn(config: dict) -> None:
        from ray_tpu_torch.tune import report

        t = copy.copy(trainer)
        merged = dict(t.train_loop_config or {})
        merged.update(config.get("train_loop_config", {k: v for k, v in config.items()}))
        t.train_loop_config = merged
        run_cfg = copy.copy(t.run_config)
        from ray_tpu_torch.tune.trainable import get_trial_dir

        run_cfg.storage_path = get_trial_dir()
        run_cfg.name = "train"
        t.run_config = run_cfg
        result = t.fit()
        metrics = dict(result.metrics)
        report(metrics, checkpoint=result.checkpoint)

    return _fn


def run(
    trainable: Any,
    *,
    config: dict | None = None,
    num_samples: int = 1,
    metric: str | None = None,
    mode: str = "max",
    scheduler: TrialScheduler | None = None,
    search_alg: Searcher | None = None,
    stop: Any = None,
    storage_path: str | None = None,
    name: str | None = None,
    max_concurrent_trials: int | None = None,
    time_budget_s: float | None = None,
) -> ResultGrid:
    """Legacy-style entry (reference: tune/tune.py:267 tune.run)."""
    run_config = RunConfig(name=name or f"tune_{uuid.uuid4().hex[:6]}", storage_path=storage_path)
    run_config.stop = stop  # type: ignore[attr-defined]
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            scheduler=scheduler,
            search_alg=search_alg,
            max_concurrent_trials=max_concurrent_trials,
            time_budget_s=time_budget_s,
        ),
        run_config=run_config,
    )
    return tuner.fit()
