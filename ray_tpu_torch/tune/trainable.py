"""Trainable API and the trial actor that hosts it (port of
ray_tpu/tune/trainable.py).

The class ``Trainable`` (setup/step/save_checkpoint/load_checkpoint) is
also the base of RLlib's ``Algorithm``. Function trainables run on a
thread of their trial's actor and hand each ``tune.report`` to the
controller with backpressure; one ``TrialActor`` process hosts one trial
and the controller drives it through ``step()`` calls, so pausing or
stopping a trial never blocks the experiment loop.

The chip is a GPU here: ``with_resources({"gpu": f})`` (or ``"GPU"``,
``"tpu"``, ``"TPU"``, ``num_tpus``, ``num_gpus``) asks for ``num_gpus=f``,
where the reference asks for ``num_tpus``. A trial actor without a GPU
lease sees no card (``CUDA_VISIBLE_DEVICES=""``): a trial that computes
on ``"cuda"`` fails with torch's own error, which its ``ResultGrid``
records.
"""

from __future__ import annotations

import functools
import inspect
import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Class trainable (reference: tune/trainable/trainable.py:57)."""

    def __init__(self, config: dict | None = None, trial_dir: str | None = None):
        self.config = config or {}
        self.trial_dir = trial_dir or os.getcwd()
        self.iteration = 0
        self.setup(self.config)

    # --- subclass surface ---

    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[dict]:
        raise NotImplementedError(f"{type(self).__name__} does not implement save_checkpoint")

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not implement load_checkpoint")

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Return True if the trainable can hot-swap configs (PBT exploit
        without an actor restart). Default: not supported."""
        return False

    # --- driver surface ---

    def train(self) -> dict:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        return result

    def save(self, checkpoint_dir: str | None = None) -> str:
        """Checkpoint to ``checkpoint_dir`` (default: a fresh
        ``checkpoint_{iteration:06d}`` under the trial dir) and return
        the path (reference: Trainable.save, trainable.py:467)."""
        dest = checkpoint_dir or os.path.join(
            self.trial_dir, f"checkpoint_{self.iteration:06d}")
        os.makedirs(dest, exist_ok=True)
        self.save_checkpoint(dest)
        return dest

    def restore(self, checkpoint_path: str) -> None:
        """Load state saved by :meth:`save` (reference:
        Trainable.restore, trainable.py:507)."""
        self.load_checkpoint(checkpoint_path)


def with_resources(trainable, resources: dict):
    """Attach per-trial resource requests to a trainable (reference:
    tune/trainable/util.py:147 with_resources). ``resources`` uses the
    reference's shorthand ({"cpu": 2, "gpu"/"tpu": 1, custom: n}) or
    the remote-options form ({"num_cpus": 2, "resources": {...}});
    overrides TuneConfig.trial_resources for this trainable. The chip
    keys map to ``num_gpus``, the port's chip option (the reference's
    map to ``num_tpus``)."""
    opts: dict = {}
    custom: dict = {}
    for k, v in resources.items():
        if k in ("cpu", "CPU", "num_cpus"):
            opts["num_cpus"] = v
        elif k in ("tpu", "TPU", "gpu", "GPU", "num_tpus", "num_gpus"):
            opts["num_gpus"] = v
        elif k == "resources" and isinstance(v, dict):
            custom.update(v)
        else:
            custom[k] = v
    if custom:
        opts["resources"] = custom

    if isinstance(trainable, type):
        wrapped = type(trainable.__name__, (trainable,), {})
    else:
        @functools.wraps(trainable)
        def wrapped(*a, **kw):
            return trainable(*a, **kw)
    wrapped._tune_resources = opts
    return wrapped


def with_parameters(trainable, **kwargs):
    """Bind large objects to a trainable via the object store so every
    trial resolves them from shm instead of re-pickling them into each
    actor (reference: tune/trainable/util.py:21 with_parameters). The
    trainable receives them as keyword arguments after ``config``."""
    import ray_tpu_torch

    ray_tpu_torch.api.auto_init()
    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    if isinstance(trainable, type):
        raise TypeError(
            "with_parameters supports function trainables; class "
            "trainables can take ObjectRefs in their config directly")

    @functools.wraps(trainable)
    def wrapped(config):
        import ray_tpu_torch as _rt

        resolved = {k: _rt.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    # Keep any resource annotation from an inner with_resources wrap.
    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


class _StopTrial(Exception):
    """Raised inside a function trainable's thread to unwind it."""


class _TuneSession:
    """Per-process session backing `tune.report` inside function trainables."""

    def __init__(self, trial_id: str, trial_dir: str, checkpoint: Checkpoint | None):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.checkpoint = checkpoint
        self.results: "queue.Queue[tuple]" = queue.Queue()
        self.resume = threading.Event()
        self.stopped = False

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        if self.stopped:
            raise _StopTrial()
        if checkpoint is not None:
            self.checkpoint = checkpoint
        self.results.put(("result", dict(metrics), checkpoint))
        # Backpressure: wait for the controller to consume this result
        # before computing the next one (reference function-trainable
        # semantics), so PAUSE/STOP decisions apply promptly.
        self.resume.wait()
        self.resume.clear()
        if self.stopped:
            raise _StopTrial()


_session: _TuneSession | None = None


def _set_session(s: _TuneSession | None) -> None:
    global _session
    _session = s


def get_session() -> _TuneSession:
    if _session is None:
        raise RuntimeError("tune.report()/get_checkpoint() called outside a Tune trial")
    return _session


def in_session() -> bool:
    return _session is not None


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    """Public `tune.report` (also reachable as ray_tpu_torch.tune.report)."""
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Checkpoint | None:
    return get_session().checkpoint


def get_trial_id() -> str:
    return get_session().trial_id


def get_trial_dir() -> str:
    return get_session().trial_dir


def is_function_trainable(t: Any) -> bool:
    return callable(t) and not (inspect.isclass(t) and issubclass(t, Trainable))


class TrialActor:
    """Hosts one trial: a Trainable instance or a function-on-a-thread.

    Spawned via ray_tpu_torch actors by the TuneController
    (reference analogue: tune_controller.py:964 _schedule_trial_actor).
    """

    def __init__(
        self,
        trainable: Any,
        config: dict,
        trial_id: str,
        trial_dir: str,
        checkpoint_path: str | None = None,
    ):
        os.makedirs(trial_dir, exist_ok=True)
        self._config = config
        self._trial_id = trial_id
        self._trial_dir = trial_dir
        self._ckpt_index = 0
        self._latest_ckpt = checkpoint_path
        self._start = time.monotonic()
        self._trainable: Trainable | None = None
        self._fn: Callable | None = None
        self._thread: threading.Thread | None = None
        self._fn_error: list[BaseException] = []
        self._last_metrics: dict = {}
        self._iter = 0
        if is_function_trainable(trainable):
            self._fn = trainable
            self._sess = _TuneSession(
                trial_id, trial_dir, Checkpoint(checkpoint_path) if checkpoint_path else None
            )
        else:
            self._trainable = trainable(config, trial_dir)
            if checkpoint_path:
                self._trainable.load_checkpoint(checkpoint_path)
                # Iteration count continues from the checkpoint's manifest.
                meta = os.path.join(checkpoint_path, ".tune_iteration")
                if os.path.exists(meta):
                    with open(meta) as f:
                        self._trainable.iteration = int(f.read())

    # ------------------------------------------------------------------

    def _fn_main(self) -> None:
        _set_session(self._sess)
        try:
            self._fn(self._config)
        except _StopTrial:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced via step()
            self._fn_error.append(e)
        finally:
            self._sess.results.put(("done",))
            _set_session(None)

    def step(self) -> dict:
        """Run/collect one reporting interval. Returns the result dict with
        `done=True` appended when the trial is finished."""
        if self._trainable is not None:
            result = self._trainable.train()
            result[DONE] = bool(result.get(DONE, False))
            result["time_total_s"] = time.monotonic() - self._start
            return result
        if self._thread is None:
            self._thread = threading.Thread(target=self._fn_main, daemon=True, name="tune-fn")
            self._thread.start()
        item = self._sess.results.get()
        if item[0] == "done":
            self._thread.join()
            if self._fn_error:
                raise self._fn_error[0]
            # Function returned: final result repeats the last reported
            # metrics with done=True (reference function-trainable behavior).
            final = dict(self._last_metrics)
            final[DONE] = True
            final[TRAINING_ITERATION] = max(self._iter, 1)
            final["time_total_s"] = time.monotonic() - self._start
            return final
        _, metrics, checkpoint = item
        if checkpoint is not None:
            self._latest_ckpt = self._persist(checkpoint)
        self._sess.resume.set()
        self._iter += 1
        metrics.setdefault(TRAINING_ITERATION, self._iter)
        metrics[DONE] = bool(metrics.get(DONE, False))
        metrics["time_total_s"] = time.monotonic() - self._start
        self._last_metrics = {k: v for k, v in metrics.items() if k != "time_total_s"}
        return metrics

    def _persist(self, checkpoint: Checkpoint) -> str:
        dest = os.path.join(self._trial_dir, f"checkpoint_{self._ckpt_index:06d}")
        self._ckpt_index += 1
        if os.path.abspath(checkpoint.path) != dest:
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(checkpoint.path, dest)
        return dest

    def save(self) -> str | None:
        """Checkpoint the trial; returns the checkpoint path."""
        if self._trainable is not None:
            dest = os.path.join(self._trial_dir, f"checkpoint_{self._ckpt_index:06d}")
            self._ckpt_index += 1
            os.makedirs(dest, exist_ok=True)
            self._trainable.save_checkpoint(dest)
            with open(os.path.join(dest, ".tune_iteration"), "w") as f:
                f.write(str(self._trainable.iteration))
            self._latest_ckpt = dest
            return dest
        return self._latest_ckpt  # function trials: latest reported checkpoint

    def latest_checkpoint(self) -> str | None:
        return self._latest_ckpt

    def reset(self, new_config: dict) -> bool:
        """PBT exploit fast path: swap config in place if supported."""
        if self._trainable is not None and self._trainable.reset_config(new_config):
            self._trainable.config = new_config
            self._config = new_config
            return True
        return False

    def restore(self, checkpoint_path: str) -> None:
        if self._trainable is not None:
            self._trainable.load_checkpoint(checkpoint_path)
            meta = os.path.join(checkpoint_path, ".tune_iteration")
            if os.path.exists(meta):
                with open(meta) as f:
                    self._trainable.iteration = int(f.read())
        self._latest_ckpt = checkpoint_path

    def stop(self) -> None:
        if self._trainable is not None:
            self._trainable.cleanup()
        elif self._thread is not None and self._thread.is_alive():
            self._sess.stopped = True
            self._sess.resume.set()
            self._thread.join(timeout=2.0)
