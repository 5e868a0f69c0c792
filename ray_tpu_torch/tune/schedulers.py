"""Trial schedulers: FIFO, ASHA, median stopping, PBT, HyperBand (port of
ray_tpu/tune/schedulers.py: host code, the same decisions from the same
results).

Counterpart of the reference's tune/schedulers/: TrialScheduler ABC
(trial_scheduler.py), AsyncHyperBandScheduler/ASHA (async_hyperband.py),
MedianStoppingRule (median_stopping_rule.py), PopulationBasedTraining
(pbt.py). Decisions flow back to the TuneController which owns actor
lifecycle (stop/pause/exploit)."""

from __future__ import annotations

import dataclasses
import math
import random
from collections import defaultdict
from typing import TYPE_CHECKING, Dict, Optional

from ray_tpu_torch.tune.search import Domain

if TYPE_CHECKING:  # pragma: no cover
    from ray_tpu_torch.tune.tuner import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    PAUSE = "PAUSE"

    metric: Optional[str] = None
    mode: str = "max"

    def set_search_properties(self, metric: str | None, mode: str | None) -> None:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode

    def _score(self, result: dict) -> float | None:
        if self.metric is None or self.metric not in result:
            return None
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_add(self, trial: "Trial") -> None:
        pass

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        return self.CONTINUE

    def on_trial_complete(self, trial: "Trial", result: dict | None) -> None:
        pass

    def on_trial_error(self, trial: "Trial") -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run trials to completion in submission order."""


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference: tune/schedulers/async_hyperband.py).

    Rungs at grace_period * reduction_factor^k. When a trial reaches a rung
    it is compared against the rung's history; trials below the top
    1/reduction_factor quantile stop early. Asynchronous: no waiting for a
    full rung before promoting."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
        brackets: int = 1,
    ):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.max_t = max_t
        self.rf = reduction_factor
        # bracket b starts at grace * rf^b (HyperBand-style staggering).
        self._bracket_rungs: list[list[float]] = []
        for b in range(brackets):
            rungs, t = [], grace_period * (reduction_factor**b)
            while t < max_t:
                rungs.append(t)
                t *= reduction_factor
            self._bracket_rungs.append(rungs)
        self._rung_scores: Dict[tuple, list[float]] = defaultdict(list)
        self._trial_bracket: Dict[str, int] = {}
        self._rr = 0

    def on_trial_add(self, trial: "Trial") -> None:
        self._trial_bracket[trial.trial_id] = self._rr % len(self._bracket_rungs)
        self._rr += 1

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        t = result.get(self.time_attr)
        score = self._score(result)
        if t is None or score is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        bracket = self._trial_bracket.get(trial.trial_id, 0)
        decision = self.CONTINUE
        for rung in reversed(self._bracket_rungs[bracket]):
            if t < rung:
                continue
            key = (bracket, rung, trial.trial_id)
            if key in self._rung_scores:
                break  # already recorded at this rung
            scores = self._rung_scores[(bracket, rung)]
            scores.append(score)
            self._rung_scores[key] = [score]
            if len(scores) > 1:
                cutoff_idx = max(0, int(len(scores) / self.rf) - 1)
                cutoff = sorted(scores, reverse=True)[cutoff_idx]
                if score < cutoff:
                    decision = self.STOP
            break
        return decision


ASHAScheduler = AsyncHyperBandScheduler


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average score falls below the median of
    other trials' averages at the same point in time
    (reference: tune/schedulers/median_stopping_rule.py)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str = "max",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._history: Dict[str, list[float]] = defaultdict(list)

    def on_trial_result(self, trial: "Trial", result: dict) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return self.CONTINUE
        self._history[trial.trial_id].append(score)
        if t < self.grace_period:
            return self.CONTINUE
        means = [
            sum(h) / len(h)
            for tid, h in self._history.items()
            if tid != trial.trial_id and h
        ]
        if len(means) < self.min_samples:
            return self.CONTINUE
        median = sorted(means)[len(means) // 2]
        best = max(self._history[trial.trial_id])
        return self.STOP if best < median else self.CONTINUE


@dataclasses.dataclass
class ExploitDecision:
    """PBT: restart `trial` from `source`'s checkpoint with a mutated config."""

    source: "Trial"
    new_config: dict


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py): every perturbation_interval,
    bottom-quantile trials clone a top-quantile trial's checkpoint and
    perturb its hyperparameters (×1.2 / ×0.8, or resample)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str = "max",
        perturbation_interval: int = 10,
        hyperparam_mutations: dict | None = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        synch: bool = False,
        seed: int | None = None,
    ):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.synch = synch
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = defaultdict(float)
        self._latest: Dict[str, tuple[float, float]] = {}  # tid -> (t, score)
        self._at_boundary: set[str] = set()  # synch mode: trials held paused

    def _mutate(self, config: dict) -> dict:
        new = dict(config)
        for k, spec in self.mutations.items():
            if self._rng.random() < self.resample_p or k not in new:
                if isinstance(spec, Domain):
                    new[k] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    new[k] = self._rng.choice(spec)
                elif callable(spec):
                    new[k] = spec()
            else:
                cur = new[k]
                if isinstance(spec, list):
                    idx = spec.index(cur) if cur in spec else 0
                    idx += self._rng.choice([-1, 1])
                    new[k] = spec[max(0, min(len(spec) - 1, idx))]
                elif isinstance(cur, (int, float)):
                    factor = self._rng.choice([0.8, 1.2])
                    new[k] = type(cur)(cur * factor) if isinstance(cur, float) else max(1, int(cur * factor))
        return new

    def on_trial_result(self, trial: "Trial", result: dict):
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return self.CONTINUE
        self._latest[trial.trial_id] = (t, score)
        if t - self._last_perturb[trial.trial_id] < self.interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        if self.synch:
            # Hold the trial at the boundary; exploits happen in
            # resume_decisions once every live trial arrives
            # (reference: pbt.py synch=True).
            self._at_boundary.add(trial.trial_id)
            return self.PAUSE
        peers = sorted(self._latest.items(), key=lambda kv: kv[1][1])
        n = len(peers)
        k = max(1, int(math.ceil(n * self.quantile)))
        if n < 2 * k:
            return self.CONTINUE
        bottom = {tid for tid, _ in peers[:k]}
        top = [tid for tid, _ in peers[-k:]]
        if trial.trial_id not in bottom:
            return self.CONTINUE
        source_id = self._rng.choice(top)
        source = next((x for x in trial.experiment_trials if x.trial_id == source_id), None)
        if source is None or source is trial:
            return self.CONTINUE
        return ExploitDecision(source=source, new_config=self._mutate(source.config))

    def on_trial_complete(self, trial: "Trial", result: dict | None) -> None:
        # Dead trials must neither anchor the bottom quantile nor be
        # picked as exploit sources.
        self._latest.pop(trial.trial_id, None)
        self._at_boundary.discard(trial.trial_id)

    def on_trial_error(self, trial: "Trial") -> None:
        self._latest.pop(trial.trial_id, None)
        self._at_boundary.discard(trial.trial_id)

    # --- synch-mode controller hooks ---

    def may_resume(self, trial: "Trial") -> bool:
        return trial.trial_id not in self._at_boundary

    def resume_decisions(self, trials) -> dict:
        """Once all live trials are paused at the perturbation boundary,
        release them — bottom-quantile trials with (mutated config, source
        checkpoint). Returns {trial: (config, checkpoint_path | None)}."""
        if not self._at_boundary:
            return {}
        live = [t for t in trials if t.status in ("RUNNING", "PAUSED", "PENDING")]
        held = [t for t in live if t.trial_id in self._at_boundary]
        if any(t.status != "PAUSED" for t in live) or len(held) < len(live):
            return {}  # someone is still training toward the boundary
        ranked = sorted(held, key=lambda t: self._latest[t.trial_id][1])
        n = len(ranked)
        k = max(1, int(math.ceil(n * self.quantile)))
        decisions: dict = {}
        if n >= 2 * k:
            top = ranked[-k:]
            for t in ranked[:k]:
                source = self._rng.choice(top)
                if source.checkpoint_path:
                    decisions[t] = (self._mutate(source.config), source.checkpoint_path)
        for t in held:
            decisions.setdefault(t, (t.config, None))
        self._at_boundary.clear()
        return decisions


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference: tune/schedulers/hyperband.py).

    Trials are assigned to brackets s = s_max..0; bracket s admits
    n_s = ceil((s_max+1)/(s+1) * eta^s) trials with initial rung budget
    r_s = max_t * eta^-s. At each rung every live bracket member PAUSES
    until the whole bracket arrives, then the top 1/eta continue to the
    next rung (budget *= eta) and the rest stop — the synchronous cut
    ASHA deliberately forgoes. Losers are reaped through the
    ``pending_stops`` controller hook."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str | None = None,
        mode: str = "max",
        max_t: int = 81,
        reduction_factor: float = 3,
    ):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.max_t = max_t
        self.eta = reduction_factor
        self._s_max = int(math.log(max_t) / math.log(reduction_factor))
        self._next_s = self._s_max
        self._brackets: list[dict] = []
        self._trial_bracket: Dict[str, dict] = {}
        self._to_stop: set[str] = set()

    def _new_bracket(self) -> dict:
        s = self._next_s
        self._next_s = self._s_max if self._next_s == 0 else self._next_s - 1
        n = int(math.ceil((self._s_max + 1) / (s + 1) * self.eta**s))
        r = self.max_t * self.eta ** (-s)
        bracket = {"s": s, "n": n, "r": max(1.0, r), "trials": [],
                   "scores": {}, "reached": set()}
        self._brackets.append(bracket)
        return bracket

    def on_trial_add(self, trial: "Trial") -> None:
        bracket = next(
            (b for b in self._brackets if len(b["trials"]) < b["n"]), None
        ) or self._new_bracket()
        bracket["trials"].append(trial)
        self._trial_bracket[trial.trial_id] = bracket

    def _live_members(self, bracket: dict) -> list:
        return [t for t in bracket["trials"]
                if t.status not in ("TERMINATED", "ERROR")
                and t.trial_id not in self._to_stop]

    def _cut(self, bracket: dict) -> None:
        """All live members reached the rung: keep the top 1/eta."""
        ranked = sorted(bracket["scores"].items(), key=lambda kv: kv[1])
        n_live = len(ranked)
        keep = max(1, int(n_live / self.eta))
        if bracket["r"] * self.eta > self.max_t:
            keep = n_live  # final rung: everyone left runs to max_t
        losers = [tid for tid, _ in ranked[:-keep]] if keep < n_live else []
        self._to_stop.update(losers)
        bracket["r"] = bracket["r"] * self.eta
        bracket["scores"] = {}
        bracket["reached"] = set()

    def on_trial_result(self, trial: "Trial", result: dict):
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return self.STOP
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return self.CONTINUE
        if t < bracket["r"] or trial.trial_id in bracket["reached"]:
            return self.CONTINUE
        score = self._score(result)
        if score is None:
            return self.CONTINUE
        bracket["reached"].add(trial.trial_id)
        bracket["scores"][trial.trial_id] = score
        live = self._live_members(bracket)
        if all(x.trial_id in bracket["reached"] for x in live):
            self._cut(bracket)
            if trial.trial_id in self._to_stop:
                self._to_stop.discard(trial.trial_id)
                return self.STOP
            return self.CONTINUE
        return self.PAUSE

    def on_trial_complete(self, trial: "Trial", result: dict | None) -> None:
        self._finalize(trial)

    def on_trial_error(self, trial: "Trial") -> None:
        self._finalize(trial)

    def _finalize(self, trial: "Trial") -> None:
        bracket = self._trial_bracket.pop(trial.trial_id, None)
        self._to_stop.discard(trial.trial_id)
        if bracket is None:
            return
        bracket["reached"].discard(trial.trial_id)
        bracket["scores"].pop(trial.trial_id, None)
        # A member dying can complete the rung for the rest.
        live = self._live_members(bracket)
        if live and bracket["reached"] and all(
            x.trial_id in bracket["reached"] for x in live
        ):
            self._cut(bracket)

    # --- controller hooks ---

    def may_resume(self, trial: "Trial") -> bool:
        if trial.trial_id in self._to_stop:
            return False
        bracket = self._trial_bracket.get(trial.trial_id)
        if bracket is None:
            return True
        # Resume only once the rung cut released this trial.
        return trial.trial_id not in bracket["reached"]

    def pending_stops(self, trials) -> list:
        out = [t for t in trials
               if t.trial_id in self._to_stop and t.status == "PAUSED"]
        return out


class TuneBOHB(TrialScheduler):
    """BOHB (reference: tune/schedulers/hb_bohb.py + search/bohb) needs the
    hpbandster package, which is not installed in this image; construction
    raises with guidance. Use HyperBandScheduler + OptunaSearch for a
    comparable model-based bandit setup."""

    def __init__(self, *a, **kw):
        raise ImportError(
            "TuneBOHB requires 'hpbandster', which is not installed in this "
            "environment. Use HyperBandScheduler (+ OptunaSearch) instead."
        )
