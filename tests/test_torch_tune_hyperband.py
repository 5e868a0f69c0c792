"""Tune on the port, part 2: tests/test_tune_hyperband.py's scenarios
(synchronous HyperBand pruning to the best trial, its bracket sizes, the
BOHB gate) and test_tune.py's synchronous PBT, whose trials pause at
each boundary (a restart each), on one port cluster (one head shard).
Part 1 is tests/test_torch_tune.py. Every fit is bounded."""

from __future__ import annotations

import os

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import tune
from tests.torch_tune_helpers import fit_bounded


@pytest.fixture(scope="module", autouse=True)
def _cluster():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=1, object_store_memory=128 * 1024 * 1024,
            _system_config={"head_shards": 1})
    yield
    rt.shutdown()


def _fit(tuner, timeout=90):
    return fit_bounded(tuner.fit, timeout)


def _hyperband_trainable(config):
    for i in range(30):
        tune.report({"score": config["q"] + 0.001 * i})


def test_hyperband_prunes_to_best(tmp_path):
    scheduler = tune.HyperBandScheduler(metric="score", mode="max", max_t=27,
                                        reduction_factor=3)
    results = _fit(tune.Tuner(
        _hyperband_trainable,
        param_space={"q": tune.grid_search([0.1, 0.2, 0.3, 0.4, 0.5,
                                            0.6, 0.7, 0.8, 0.9])},
        tune_config=tune.TuneConfig(scheduler=scheduler, metric="score",
                                    mode="max", max_concurrent_trials=3),
        run_config=tune.RunConfig(name="hb", storage_path=str(tmp_path)),
    ))
    best = results.get_best_result()
    assert best.config["q"] == pytest.approx(0.9)
    iters = sum(len(r.metrics_history) for r in results)
    assert iters < 9 * 30 * 0.7, iters
    by_q = {r.config["q"]: len(r.metrics_history) for r in results}
    assert by_q[0.9] == max(by_q.values())
    assert min(by_q.values()) < max(by_q.values())


def test_hyperband_bracket_math():
    s = tune.HyperBandScheduler(max_t=81, reduction_factor=3)
    b0 = s._new_bracket()
    assert b0["s"] == 4
    assert b0["n"] == 81  # ceil(5/5 * 3^4)
    assert b0["r"] == pytest.approx(1.0)
    b1 = s._new_bracket()
    assert b1["s"] == 3 and b1["r"] == pytest.approx(3.0)


def test_bohb_gate():
    with pytest.raises(ImportError, match="hpbandster"):
        tune.TuneBOHB()


class PBTTrainable(tune.Trainable):
    def setup(self, config):
        self.score = 0.0

    def step(self):
        self.score += self.config["rate"]
        return {"score": self.score, "done": self.iteration + 1 >= 12}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "s.txt"), "w") as f:
            f.write(str(self.score))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "s.txt")) as f:
            self.score = float(f.read())


def test_pbt_synch_exploits_better_config(tmp_path):
    pbt = tune.PopulationBasedTraining(
        metric="score",
        mode="max",
        perturbation_interval=3,
        hyperparam_mutations={"rate": tune.uniform(0.5, 2.0)},
        quantile_fraction=0.5,
        synch=True,
        seed=0,
    )
    grid = _fit(tune.Tuner(
        PBTTrainable,
        param_space={"rate": tune.grid_search([0.1, 2.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt),
        run_config=tune.RunConfig(name="pbt", storage_path=str(tmp_path)),
    ))
    # The weak trial (1.2 if never exploited) cloned the strong one's
    # state and a rate >= 0.5 at the first boundary.
    scores = [r.metrics["score"] for r in grid]
    assert all(s > 5.0 for s in scores), scores
    configs = [r.metrics["config"]["rate"] for r in grid]
    assert 0.1 not in configs
