"""Tune and Workflow held against the reference on the CPU.

In process: the port's and ray_tpu's search spaces, searchers and
schedulers, fed the same seeds and the same stream of results, give
exactly the same variants and the same decisions (ASHA with one and
with three brackets, synchronous HyperBand with its pauses and reaped
losers, the median rule, PBT's exploits and mutations, asynchronous and
synchronous).

Then tests/torch_tune_parity_cases.py runs under each package in its own
process (one head shard both), side by side: three Tuner runs and two
workflows, whose JSON outcomes must be equal (configs, statuses,
iterations, last metrics, the best configs, checkpoint contents,
workflow outputs and statuses)."""

import json
import os
import random
import subprocess
import sys
import threading

import pytest

from ray_tpu.tune import schedulers as ref_sched
from ray_tpu.tune import search as ref_search
from ray_tpu_torch.tune import schedulers as port_sched
from ray_tpu_torch.tune import search as port_search

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tests", "torch_tune_parity_cases.py")
PAIR = [("ray_tpu", ref_search, ref_sched), ("ray_tpu_torch", port_search, port_sched)]


def _space(s):
    return {
        "grid": s.grid_search([1, 2, 3]),
        "nested": {"g": s.grid_search(["a", "b"]), "u": s.uniform(-1.0, 1.0)},
        "lu": s.loguniform(1e-5, 1e-1),
        "q": s.quniform(0.0, 10.0, 0.5),
        "ri": s.randint(2, 40),
        "lri": s.lograndint(1, 1000),
        "c": s.choice(["x", "y", "z", 7]),
        "n": s.randn(0.5, 2.0),
        "derived": s.sample_from(lambda cfg: cfg["ri"] * 2 + cfg["grid"]),
        "fixed": 11,
    }


@pytest.mark.parametrize("seed", [0, 1, 123])
def test_basic_variant_generator_draws_the_same_variants(seed):
    got = {}
    for name, s, _ in PAIR:
        gen = s.BasicVariantGenerator(_space(s), num_samples=3, seed=seed)
        got[name] = [gen.suggest(str(i)) for i in range(len(gen) + 1)]
    assert len(got["ray_tpu"]) == 3 * 3 * 2 + 1 and got["ray_tpu"][-1] is None
    assert got["ray_tpu_torch"] == got["ray_tpu"]


def test_repeated_random_search_and_domains_draw_the_same_values():
    got = {}
    for name, s, _ in PAIR:
        space = {k: v for k, v in _space(s).items() if k not in ("grid", "nested", "derived")}
        rs = s.RepeatedRandomSearch(space, num_samples=5, seed=42)
        rng = random.Random(9)
        doms = [s.uniform(0, 3), s.quniform(1, 2, 0.1), s.loguniform(1e-3, 1.0),
                s.randint(-5, 5), s.lograndint(2, 64), s.choice("abc"), s.randn()]
        got[name] = ([rs.suggest(str(i)) for i in range(6)],
                     [d.sample(rng) for d in doms * 4])
    assert got["ray_tpu_torch"] == got["ray_tpu"]


class _Trial:
    def __init__(self, tid, config):
        self.trial_id, self.config = tid, dict(config)
        self.status = "RUNNING"
        self.checkpoint_path = f"ckpt-{tid}"
        self.experiment_trials = []


def _drive(sched, n_trials, max_iter, seed, score, s):
    """Feed ``sched`` a seeded stream of results from ``n_trials`` fake
    trials as a controller would (paused trials wait for may_resume,
    pending_stops and resume_decisions are honoured) and log every
    decision. Returns the log."""
    rng = random.Random(seed)
    trials = [_Trial(f"t{i}", {"rate": 0.5 + i, "k": [1, 2, 4][i % 3]}) for i in range(n_trials)]
    for t in trials:
        t.experiment_trials = trials
        sched.on_trial_add(t)
    it = {t.trial_id: 0 for t in trials}
    log = []
    for _ in range(n_trials * max_iter * 4):
        for t in getattr(sched, "pending_stops", lambda ts: [])(trials):
            t.status = "TERMINATED"
            sched.on_trial_complete(t, {})
            log.append(("reaped", t.trial_id))
        for t, (cfg, ckpt) in getattr(sched, "resume_decisions", lambda ts: {})(trials).items():
            t.config, t.status = dict(cfg), "RUNNING"
            log.append(("released", t.trial_id, sorted(cfg.items()), ckpt))
        for t in trials:
            if t.status == "PAUSED" and getattr(sched, "may_resume", lambda x: True)(t):
                t.status = "RUNNING"
                log.append(("resumed", t.trial_id))
        live = [t for t in trials if t.status == "RUNNING"]
        if not live:
            break
        t = rng.choice(live)
        it[t.trial_id] += 1
        result = {"training_iteration": it[t.trial_id],
                  "m": score(t, it[t.trial_id], rng)}
        d = sched.on_trial_result(t, result)
        if isinstance(d, s.ExploitDecision):
            log.append(("exploit", t.trial_id, d.source.trial_id, sorted(d.new_config.items())))
            t.config = dict(d.new_config)
            continue
        log.append((d, t.trial_id, it[t.trial_id]))
        if d == "PAUSE":
            t.status = "PAUSED"
        elif d == "STOP" or it[t.trial_id] >= max_iter:
            t.status = "TERMINATED"
            sched.on_trial_complete(t, result)
    return log


def _noisy(t, i, rng):
    return t.config["rate"] * i + rng.gauss(0.0, 1.0)


# name: (a scheduler from a package's schedulers and search modules, trials,
# iterations a trial may run)
SCHEDULERS = {
    "asha": (lambda sch, s: sch.ASHAScheduler(
        metric="m", mode="max", max_t=16, grace_period=1, reduction_factor=2), 12, 16),
    "asha_3_brackets_min": (lambda sch, s: sch.AsyncHyperBandScheduler(
        metric="m", mode="min", max_t=27, grace_period=1, reduction_factor=3, brackets=3),
        10, 27),
    "hyperband": (lambda sch, s: sch.HyperBandScheduler(
        metric="m", mode="max", max_t=27, reduction_factor=3), 9, 27),
    "median": (lambda sch, s: sch.MedianStoppingRule(
        metric="m", mode="max", grace_period=2, min_samples_required=2), 8, 10),
    "pbt": (lambda sch, s: sch.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=2, quantile_fraction=0.25,
        resample_probability=0.3,
        hyperparam_mutations={"rate": s.uniform(0.1, 3.0), "k": [1, 2, 4]}, seed=5), 8, 12),
    "pbt_synch": (lambda sch, s: sch.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=3, quantile_fraction=0.5,
        hyperparam_mutations={"rate": s.uniform(0.1, 3.0)}, synch=True, seed=2), 4, 12),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
@pytest.mark.parametrize("seed", [0, 7])
def test_schedulers_make_the_same_decisions(name, seed):
    make, n_trials, max_iter = SCHEDULERS[name]
    logs = {pkg: _drive(make(sch, s), n_trials, max_iter, seed, _noisy, sch)
            for pkg, s, sch in PAIR}
    decisions = {e[0] for e in logs["ray_tpu"]}
    assert len(decisions) > 1, decisions  # the stream made the scheduler decide something
    assert logs["ray_tpu_torch"] == logs["ray_tpu"]


@pytest.fixture(scope="module")
def outcomes():
    results, threads = {}, []

    def run(pkg):
        env = dict(os.environ, PYTHONPATH=ROOT)
        try:
            results[pkg] = subprocess.run(
                [sys.executable, SCRIPT, pkg], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=150)
        except subprocess.TimeoutExpired as e:
            results[pkg] = subprocess.CompletedProcess(e.cmd, "timeout", e.stdout, e.stderr)

    for pkg in ("ray_tpu", "ray_tpu_torch"):
        threads.append(threading.Thread(target=run, args=(pkg,)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    out = {}
    for pkg, proc in results.items():
        assert proc.returncode == 0, (
            f"{pkg} ({proc.returncode}):\n{(proc.stderr or '')[-4000:]}\n"
            f"{(proc.stdout or '')[-2000:]}")
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


KEYS = ["fifo", "fifo_best", "fifo_errors", "asha", "asha_best", "pbt", "continuation",
        "gated_first", "gated_status_failed", "gated_resumed", "statuses", "gated_output"]


@pytest.mark.parametrize("key", KEYS)
def test_outcome_matches(outcomes, key):
    assert outcomes["ray_tpu_torch"][key] == outcomes["ray_tpu"][key]


def test_outcomes_cover_the_script(outcomes):
    ref = outcomes["ray_tpu"]
    assert set(ref) == set(KEYS) | {"foreign_modules"}
    assert all(t["checkpoint"]["step"] == 4 for t in ref["fifo"])
    assert sorted(t["iterations"] for t in ref["asha"])[0] < 8  # ASHA cut a trial
    assert {t["config"]["rate"] for t in ref["pbt"]} != {0.04, 4.0}  # PBT exploited
    assert ref["gated_first"] != "returned" and ref["gated_status_failed"] == "FAILED"
    assert ref["gated_resumed"] == {"sum": 18, "v": [0, 3, 6, 9]}
    # the port's driver loaded neither jax nor any ray_tpu module
    assert outcomes["ray_tpu_torch"]["foreign_modules"] == []
