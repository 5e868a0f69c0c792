"""Search spaces and search algorithms (port of ray_tpu/tune/search.py:
host code, the same draws from the same seed).

Counterpart of the reference's tune/search/: sample domains
(tune/search/sample.py — Float/Integer/Categorical, grid_search),
Searcher ABC (tune/search/searcher.py), and the default
BasicVariantGenerator (tune/search/basic_variant.py) that expands
`grid_search` entries into a cartesian product and samples the rest.
External searcher backends (optuna/hyperopt/...) plug in via the same
Searcher ABC; OptunaSearch is provided when optuna is importable.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import Any, Callable, Dict, Optional


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: float | None = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> float:
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng: random.Random) -> int:
        if self.log:
            v = int(math.exp(rng.uniform(math.log(self.lower), math.log(self.upper))))
            return max(self.lower, min(self.upper - 1, v))
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng: random.Random):
        return rng.choice(self.categories)


class Normal(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = mean, sd

    def sample(self, rng: random.Random) -> float:
        return rng.gauss(self.mean, self.sd)


class SampleFrom(Domain):
    """Arbitrary callable over the (partially resolved) config."""

    def __init__(self, fn: Callable[[dict], Any]):
        self.fn = fn

    def sample(self, rng: random.Random):  # resolved specially (needs config)
        raise TypeError("SampleFrom is resolved against the trial config")


# --- public constructors (ray.tune.* naming) ---


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories) -> Categorical:
    return Categorical(categories)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def sample_from(fn: Callable[[dict], Any]) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values) -> dict:
    return {"grid_search": list(values)}


# ---------------------------------------------------------------------------


def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _resolve(config: dict, rng: random.Random) -> dict:
    """Sample every Domain; SampleFrom last (sees sampled siblings)."""
    out: Dict[str, Any] = {}
    deferred: list[tuple[str, SampleFrom]] = []
    for k, v in config.items():
        if isinstance(v, SampleFrom):
            deferred.append((k, v))
        elif isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict) and not _is_grid(v):
            out[k] = _resolve(v, rng)
        else:
            out[k] = v
    for k, sf in deferred:
        out[k] = sf.fn(out)
    return out


class Searcher:
    """ABC for search algorithms (reference: tune/search/searcher.py).

    `suggest` returns the next config (or None when exhausted);
    `on_trial_complete` feeds the final observation back.
    """

    metric: Optional[str] = None
    mode: Optional[str] = None

    def set_search_properties(self, metric: str | None, mode: str | None, config: dict) -> None:
        self.metric, self.mode = metric, mode

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: dict | None = None, error: bool = False) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid × random expansion (reference: tune/search/basic_variant.py).

    Every `grid_search` key contributes a cartesian-product axis; each of
    `num_samples` repetitions re-samples the stochastic domains across the
    full grid (reference semantics: num_samples multiplies the grid).
    """

    def __init__(self, param_space: dict | None = None, num_samples: int = 1, seed: int | None = None):
        self._space = param_space or {}
        self._num_samples = num_samples
        self._rng = random.Random(seed)
        self._variants = self._generate()
        self._i = 0

    def _grid_axes(self, config: dict, prefix=()) -> list[tuple[tuple, list]]:
        axes = []
        for k, v in config.items():
            if _is_grid(v):
                axes.append((prefix + (k,), v["grid_search"]))
            elif isinstance(v, dict):
                axes.extend(self._grid_axes(v, prefix + (k,)))
        return axes

    @staticmethod
    def _set_path(config: dict, path: tuple, value) -> None:
        for k in path[:-1]:
            config = config[k]
        config[path[-1]] = value

    def _generate(self) -> list[dict]:
        import copy

        axes = self._grid_axes(self._space)
        combos = list(itertools.product(*[vals for _, vals in axes])) if axes else [()]
        variants = []
        for _ in range(self._num_samples):
            for combo in combos:
                cfg = copy.deepcopy(self._space)
                for (path, _), value in zip(axes, combo):
                    self._set_path(cfg, path, value)
                variants.append(_resolve(cfg, self._rng))
        return variants

    def __len__(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class RepeatedRandomSearch(Searcher):
    """Pure random search over a space with no grid axes, unbounded until
    num_samples trials have been suggested."""

    def __init__(self, param_space: dict, num_samples: int, seed: int | None = None):
        self._space = param_space
        self._remaining = num_samples
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._remaining <= 0:
            return None
        self._remaining -= 1
        return _resolve(self._space, self._rng)


try:  # optional backend, mirrors reference tune/search/optuna/optuna_search.py
    import optuna as _optuna  # noqa: F401

    class OptunaSearch(Searcher):
        def __init__(self, space: dict, metric: str, mode: str, seed: int | None = None):
            sampler = _optuna.samplers.TPESampler(seed=seed)
            direction = "maximize" if mode == "max" else "minimize"
            self._study = _optuna.create_study(sampler=sampler, direction=direction)
            self._space = space
            self._trials: dict[str, Any] = {}
            self.metric, self.mode = metric, mode

        def suggest(self, trial_id: str) -> Optional[dict]:
            t = self._study.ask()
            cfg = {}
            for k, v in self._space.items():
                if isinstance(v, Float):
                    cfg[k] = t.suggest_float(k, v.lower, v.upper, log=v.log)
                elif isinstance(v, Integer):
                    cfg[k] = t.suggest_int(k, v.lower, v.upper - 1, log=v.log)
                elif isinstance(v, Categorical):
                    cfg[k] = t.suggest_categorical(k, v.categories)
                else:
                    cfg[k] = v
            self._trials[trial_id] = t
            return cfg

        def on_trial_complete(self, trial_id: str, result=None, error: bool = False):
            t = self._trials.pop(trial_id, None)
            if t is None:
                return
            if error or result is None or self.metric not in result:
                self._study.tell(t, state=_optuna.trial.TrialState.FAIL)
            else:
                self._study.tell(t, result[self.metric])

except ImportError:  # pragma: no cover
    OptunaSearch = None  # type: ignore[assignment]


try:  # optional backend, mirrors reference tune/search/hyperopt
    import hyperopt as _hyperopt  # noqa: F401

    class HyperOptSearch(Searcher):
        """TPE via hyperopt (reference: tune/search/hyperopt/
        hyperopt_search.py). Space entries map to hp.uniform/loguniform/
        quniform/randint/choice from the shared Domain types."""

        def __init__(self, space: dict, metric: str, mode: str = "max",
                     seed: int | None = None):
            from hyperopt import hp

            self.metric, self.mode = metric, mode
            self._space = dict(space)
            hspace = {}
            for k, v in self._space.items():
                if isinstance(v, Float):
                    if v.q:
                        hspace[k] = (hp.qloguniform(k, math.log(v.lower),
                                                    math.log(v.upper), v.q)
                                     if v.log
                                     else hp.quniform(k, v.lower, v.upper, v.q))
                    else:
                        hspace[k] = (hp.loguniform(k, math.log(v.lower),
                                                   math.log(v.upper))
                                     if v.log
                                     else hp.uniform(k, v.lower, v.upper))
                elif isinstance(v, Integer):
                    hspace[k] = hp.randint(k, v.lower, v.upper)
                elif isinstance(v, Categorical):
                    hspace[k] = hp.choice(k, v.categories)
                elif isinstance(v, Normal):
                    hspace[k] = hp.normal(k, v.mean, v.sd)
                # Other domains (SampleFrom, plugins) are outside TPE's
                # model: resolved per-suggest by direct sampling below.
            self._hspace = hspace
            self._py_rng = random.Random(seed)
            self._domain = _hyperopt.Domain(lambda c: 0.0, hspace)
            self._hp_trials = _hyperopt.Trials()
            self._rng = __import__("numpy").random.default_rng(seed)
            self._tid = 0
            self._by_trial: dict[str, int] = {}

        def suggest(self, trial_id: str):
            from hyperopt import base

            self._tid += 1
            seed = int(self._rng.integers(2**31))
            new = _hyperopt.tpe.suggest(
                [self._tid], self._domain, self._hp_trials, seed)
            self._hp_trials.insert_trial_docs(new)
            self._hp_trials.refresh()
            doc = self._hp_trials._dynamic_trials[-1]
            vals = {k: v[0] for k, v in doc["misc"]["vals"].items() if v}
            cfg = dict(self._space)
            for k, v in self._space.items():
                if isinstance(v, Categorical) and k in vals:
                    cfg[k] = v.categories[int(vals[k])]
                elif k in vals:
                    cfg[k] = int(vals[k]) if isinstance(v, Integer) else float(vals[k])
                elif isinstance(v, SampleFrom):
                    cfg[k] = v.fn(cfg)
                elif isinstance(v, Domain):
                    # Domain outside the TPE model: plain random sample.
                    cfg[k] = v.sample(self._py_rng)
            self._by_trial[trial_id] = self._tid
            doc["state"] = base.JOB_STATE_RUNNING
            return cfg

        def on_trial_complete(self, trial_id: str, result=None, error: bool = False):
            from hyperopt import base

            tid = self._by_trial.pop(trial_id, None)
            if tid is None:
                return
            doc = next((d for d in self._hp_trials._dynamic_trials
                        if d["tid"] == tid), None)
            if doc is None:
                return
            if error or result is None or self.metric not in result:
                doc["state"] = base.JOB_STATE_ERROR
            else:
                score = float(result[self.metric])
                loss = -score if self.mode == "max" else score
                doc["result"] = {"loss": loss, "status": base.STATUS_OK}
                doc["state"] = base.JOB_STATE_DONE
            self._hp_trials.refresh()

except ImportError:  # pragma: no cover
    HyperOptSearch = None  # type: ignore[assignment]
