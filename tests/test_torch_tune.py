"""Tune on the port (ray_tpu_torch.tune), part 1: tests/test_tune.py's
scenarios (search spaces, function and class trainables, checkpoint and
retry, ASHA, the median rule, PBT's decision, the concurrency cap,
with_parameters and with_resources) on one port cluster (init(num_cpus=8,
num_gpus=1), one head shard), and with_resources' chip keys asking for
num_gpus. Part 2 (HyperBand, synchronous PBT) is
tests/test_torch_tune_hyperband.py; part 3 (GPU leases, RLlib and Train
as trainables) tests/test_torch_tune_trainables.py: a trial actor
imports torch (~2 s here), so one file would pass 40 s.

The trainables live in this module, which workers import by reference:
it imports neither ray_tpu nor jax. Every fit is bounded."""

from __future__ import annotations

import os
import random

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.tune.schedulers import ExploitDecision
from ray_tpu_torch.tune.search import BasicVariantGenerator
from tests.torch_tune_helpers import fit_bounded


@pytest.fixture(scope="module", autouse=True)
def _cluster():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=1, object_store_memory=128 * 1024 * 1024,
            _system_config={"head_shards": 1})
    yield
    rt.shutdown()


def _fit(tuner):
    return fit_bounded(tuner.fit)


# ---------------------------------------------------------------------------
# search spaces


def test_basic_variant_grid_and_samples():
    space = {
        "a": tune.grid_search([1, 2, 3]),
        "b": tune.grid_search(["x", "y"]),
        "c": tune.uniform(0.0, 1.0),
        "fixed": 7,
    }
    gen = BasicVariantGenerator(space, num_samples=2, seed=0)
    variants = [gen.suggest(str(i)) for i in range(len(gen))]
    assert len(variants) == 12  # 3 * 2 grid, times 2 samples
    assert gen.suggest("overflow") is None
    assert {v["a"] for v in variants} == {1, 2, 3}
    assert all(0.0 <= v["c"] <= 1.0 and v["fixed"] == 7 for v in variants)


def test_domain_sampling():
    rng = random.Random(0)
    assert 1 <= tune.randint(1, 10).sample(rng) < 10
    assert 1e-4 <= tune.loguniform(1e-4, 1e-1).sample(rng) <= 1e-1
    assert tune.choice([1, 2]).sample(rng) in (1, 2)
    q = tune.quniform(0.0, 1.0, 0.25).sample(rng)
    assert abs(q / 0.25 - round(q / 0.25)) < 1e-9
    cfg = {"a": 2, "b": tune.sample_from(lambda c: c["a"] * 10)}
    gen = BasicVariantGenerator(cfg, num_samples=1)
    assert gen.suggest("t")["b"] == 20


def test_optional_searchers_keep_their_import_gates():
    """OptunaSearch and HyperOptSearch exist only where their package is
    installed (neither is on this machine); TuneBOHB always raises."""
    for name, module in (("OptunaSearch", "optuna"), ("HyperOptSearch", "hyperopt")):
        try:
            __import__(module)
        except ImportError:
            assert getattr(tune, name) is None
        else:
            assert issubclass(getattr(tune, name), tune.Searcher)
    with pytest.raises(ImportError, match="hpbandster"):
        tune.TuneBOHB()


# ---------------------------------------------------------------------------
# end-to-end: function trainable


def _objective(config):
    score = 0.0
    for _ in range(5):
        score += config["lr"]
        tune.report({"score": score})


def test_tuner_function_trainable(tmp_path):
    results = _fit(tune.Tuner(
        _objective,
        param_space={"lr": tune.grid_search([0.1, 1.0, 10.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=tune.RunConfig(name="fn_grid", storage_path=str(tmp_path)),
    ))
    assert len(results) == 3
    best = results.get_best_result()
    assert best.metrics["config"]["lr"] == 10.0
    assert best.metrics["score"] == pytest.approx(50.0)
    assert best.metrics["training_iteration"] == 5
    assert results.num_errors == 0
    df = results.get_dataframe()
    assert sorted(df["score"]) == pytest.approx([0.5, 5.0, 50.0])


def test_tune_run_with_stop_criterion(tmp_path):
    grid = fit_bounded(lambda: tune.run(
        _objective, config={"lr": tune.grid_search([1.0])}, metric="score", mode="max",
        stop={"training_iteration": 2}, storage_path=str(tmp_path)))
    assert grid[0].metrics["training_iteration"] == 2


# ---------------------------------------------------------------------------
# class trainable + checkpointing


class Counter(tune.Trainable):
    def setup(self, config):
        self.x = 0
        self.mult = config.get("mult", 1)

    def step(self):
        self.x += self.mult
        return {"value": self.x, "done": self.iteration + 1 >= 4}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "x.txt"), "w") as f:
            f.write(str(self.x))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "x.txt")) as f:
            self.x = int(f.read())


def test_class_trainable_runs_to_done(tmp_path):
    grid = _fit(tune.Tuner(
        Counter,
        param_space={"mult": tune.grid_search([1, 3])},
        tune_config=tune.TuneConfig(metric="value", mode="max"),
        run_config=tune.RunConfig(name="cls", storage_path=str(tmp_path)),
    ))
    best = grid.get_best_result()
    assert best.metrics["value"] == 12  # 4 steps * mult 3
    assert best.metrics["done"] is True


class Flaky(tune.Trainable):
    """Fails once at iteration 3 (per actor incarnation) to exercise
    restore-from-checkpoint retry."""

    def setup(self, config):
        self.x = 0
        self.crashed = False

    def step(self):
        self.x += 1
        if self.x == 3 and not self.crashed:
            raise RuntimeError("boom")
        return {"value": self.x, "done": self.x >= 5}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "x.txt"), "w") as f:
            f.write(f"{self.x}")

    def load_checkpoint(self, d):
        with open(os.path.join(d, "x.txt")) as f:
            self.x = int(f.read())
        self.crashed = True  # survived a restart


def test_trial_failure_retry_restores(tmp_path):
    grid = _fit(tune.Tuner(
        Flaky,
        param_space={},
        tune_config=tune.TuneConfig(metric="value", mode="max"),
        run_config=tune.RunConfig(
            name="flaky",
            storage_path=str(tmp_path),
            failure_config=tune.FailureConfig(max_failures=2),
            checkpoint_config=tune.CheckpointConfig(checkpoint_frequency=1),
        ),
    ))
    assert grid.num_errors == 0
    assert grid[0].metrics["value"] == 5


# ---------------------------------------------------------------------------
# schedulers


def _curve(config):
    # Deterministic learning curves: good trials grow fast.
    for i in range(1, 9):
        tune.report({"acc": config["slope"] * i})


def test_asha_stops_bad_trials(tmp_path):
    grid = _fit(tune.Tuner(
        _curve,
        # Descending slopes: the second wave reports rung-1 metrics below
        # the first wave's, so some trial is cut under any arrival order
        # (the reference test's reasoning).
        param_space={"slope": tune.grid_search([8, 7, 6, 5, 4, 3, 2, 1])},
        tune_config=tune.TuneConfig(
            metric="acc",
            mode="max",
            scheduler=tune.ASHAScheduler(max_t=8, grace_period=1, reduction_factor=2),
            max_concurrent_trials=4,
        ),
        run_config=tune.RunConfig(name="asha", storage_path=str(tmp_path)),
    ))
    iters = {r.metrics["config"]["slope"]: r.metrics["training_iteration"] for r in grid}
    assert grid.get_best_result().metrics["config"]["slope"] == 8
    assert min(iters.values()) < 8  # a poor trial was cut before max_t
    assert iters[8] == 8  # the best ran to completion


def test_median_stopping_rule_decisions():
    sched = tune.MedianStoppingRule(
        metric="acc", mode="max", grace_period=2, min_samples_required=2
    )

    class T:
        def __init__(self, tid):
            self.trial_id = tid

    for tid, acc in (("a", 10.0), ("b", 12.0)):
        for it in range(1, 4):
            assert sched.on_trial_result(T(tid), {"training_iteration": it, "acc": acc}) == "CONTINUE"
    t = T("weak")
    sched.on_trial_result(t, {"training_iteration": 1, "acc": 1.0})
    assert sched.on_trial_result(t, {"training_iteration": 3, "acc": 1.0}) == "STOP"


def test_pbt_emits_exploit_decision():
    pbt = tune.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=2,
        hyperparam_mutations={"p": [1, 2, 4]}, quantile_fraction=0.5, seed=1,
    )

    class T:
        def __init__(self, tid, config):
            self.trial_id, self.config = tid, config
            self.experiment_trials = []

    hi, lo = T("hi", {"p": 4}), T("lo", {"p": 1})
    hi.experiment_trials = lo.experiment_trials = [hi, lo]
    assert pbt.on_trial_result(hi, {"training_iteration": 2, "m": 100.0}) == "CONTINUE"
    d = pbt.on_trial_result(lo, {"training_iteration": 2, "m": 1.0})
    assert isinstance(d, ExploitDecision)
    assert d.source is hi
    assert "p" in d.new_config


# ---------------------------------------------------------------------------
# concurrency cap, parameters and resources


def test_max_concurrent_trials_and_time_fields(tmp_path):
    grid = _fit(tune.Tuner(
        _objective,
        param_space={"lr": tune.grid_search([0.1] * 6)},
        tune_config=tune.TuneConfig(metric="score", mode="max", max_concurrent_trials=2),
        run_config=tune.RunConfig(name="cap", storage_path=str(tmp_path)),
    ))
    assert len(grid) == 6
    assert all("time_total_s" in r.metrics for r in grid)


def _data_total(config, data):
    tune.report({"total": float(data.sum()) + config["x"]})


def test_with_parameters_and_resources(tmp_path):
    import numpy as np

    big = np.arange(1000)
    wrapped = tune.with_resources(tune.with_parameters(_data_total, data=big), {"cpu": 1})
    assert wrapped._tune_resources == {"num_cpus": 1}
    grid = _fit(tune.Tuner(
        wrapped,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="total", mode="max"),
        run_config=tune.RunConfig(name="wp", storage_path=str(tmp_path)),
    ))
    totals = sorted(r.metrics["total"] for r in grid)
    assert totals == [499501.0, 499502.0]


@pytest.mark.parametrize("key", ["gpu", "GPU", "tpu", "TPU", "num_tpus", "num_gpus"])
def test_with_resources_maps_the_chip_to_num_gpus(key):
    """The port's chip option is num_gpus; the reference maps the same
    keys to num_tpus."""
    wrapped = tune.with_resources(_objective, {key: 0.5, "cpu": 1, "memory_gb": 2})
    assert wrapped._tune_resources == {"num_gpus": 0.5, "num_cpus": 1,
                                       "resources": {"memory_gb": 2}}
