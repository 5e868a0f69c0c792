"""Tune on the port, part 3: what is the port's own, on one port cluster
(init(num_cpus=8, num_gpus=1): "GPU" from resources alone, no CUDA is
called; one head shard). A half-card lease pins a trial's actor to
device 0 and a trial without one sees no card; a trial that computes on
"cuda" without a lease fails with torch's error into ResultGrid.errors;
a trial's Result carries the checkpoint of its last report, also when a
scheduler stops it; Tuner(PPO, ...) with "device": "cpu"
(tests/test_rllib.py's flagship scenario); Tuner(TorchTrainer(...)).
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


def _visible(config):
    tune.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid()})


def test_gpu_lease_pins_the_trial_and_no_lease_sees_no_card(tmp_path):
    """A half-card lease pins the trial's actor to device 0; a trial
    without a lease runs with CUDA_VISIBLE_DEVICES="" (no card)."""
    leased = _fit(tune.Tuner(
        tune.with_resources(_visible, {"gpu": 0.5}),
        param_space={"i": tune.grid_search([0, 1])},
        run_config=tune.RunConfig(name="leased", storage_path=str(tmp_path))))
    assert [r.metrics["visible"] for r in leased] == ["0", "0"]
    plain = _fit(tune.Tuner(
        _visible, run_config=tune.RunConfig(name="plain", storage_path=str(tmp_path))))
    assert plain[0].metrics["visible"] == ""


def _on_cuda(config):
    import torch

    tune.report({"x": float(torch.ones(1, device="cuda").sum())})


def test_cuda_trial_without_a_lease_fails_into_errors(tmp_path):
    """No fallback to the CPU: a trial that computes on "cuda" without a
    GPU lease fails with torch's own error, recorded in the ResultGrid."""
    grid = _fit(tune.Tuner(
        _on_cuda, run_config=tune.RunConfig(name="nolease", storage_path=str(tmp_path))))
    assert grid.num_errors == 1
    assert "CUDA" in str(grid.errors[0]) or "cuda" in str(grid.errors[0])


def _checkpointed(config):
    from ray_tpu_torch import train

    for i in range(1, 5):
        d = train.make_temp_checkpoint_dir()
        with open(os.path.join(d, "step.txt"), "w") as f:
            f.write(str(i))
        tune.report({"acc": config["slope"] * i, "step": i}, checkpoint=train.Checkpoint(d))


def test_result_checkpoint_is_the_last_reports(tmp_path):
    """ASHA stops every trial at max_t=3 on its third report: each
    Result's checkpoint is that report's (the reference's is the last
    controller save's, here none, as no checkpoint_frequency is set)."""
    grid = _fit(tune.Tuner(
        _checkpointed,
        param_space={"slope": tune.grid_search([2, 1])},
        tune_config=tune.TuneConfig(
            metric="acc", mode="max",
            scheduler=tune.ASHAScheduler(max_t=3, grace_period=1, reduction_factor=2)),
        run_config=tune.RunConfig(name="ckpt", storage_path=str(tmp_path))))
    assert grid.num_errors == 0
    for r in grid:
        with open(os.path.join(r.checkpoint.path, "step.txt")) as f:
            assert int(f.read()) == r.metrics["step"]
    assert grid.get_best_result().metrics["step"] == 3


def test_algorithm_is_tune_trainable(tmp_path):
    """Tuner(PPO, param_space=...) (tests/test_rllib.py's flagship
    scenario), on the CPU."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPO

    grid = _fit(tune.Tuner(
        PPO,
        param_space={
            "env": "CartPole-v1",
            "device": "cpu",
            "lr": tune.grid_search([1e-3, 3e-4]),
            "train_batch_size": 128,
            "minibatch_size": 64,
            "num_epochs": 1,
            "rollout_fragment_length": 16,
            "num_envs_per_env_runner": 4,
        },
        tune_config=tune.TuneConfig(metric="episode_return_mean", mode="max"),
        run_config=tune.RunConfig(
            name="ppo_tune", storage_path=str(tmp_path), stop={"training_iteration": 2}),
    ))
    assert len(grid) == 2
    assert grid.num_errors == 0, grid.errors
    assert all(r.metrics["training_iteration"] == 2 for r in grid)


def _train_loop(config):
    from ray_tpu_torch import train

    for i in range(3):
        ckpt = None
        if i == 2:
            d = train.make_temp_checkpoint_dir()
            with open(os.path.join(d, "lr.txt"), "w") as f:
                f.write(repr(config["lr"]))
            ckpt = train.Checkpoint(d)
        train.report({"loss": config["lr"] * (3 - i), "step": i + 1}, checkpoint=ckpt)


def test_tuner_over_a_torch_trainer(tmp_path):
    """Tuner(TorchTrainer(...)): each trial runs the trainer's fit with
    its sampled train_loop_config merged in; the result carries the
    trainer's last report and checkpoint."""
    from ray_tpu_torch import train

    trainer = train.TorchTrainer(
        _train_loop, train_loop_config={"lr": 0.0},
        scaling_config=train.ScalingConfig(num_workers=1),
        backend_config=train.TorchConfig(device="cpu"))
    grid = _fit(tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search([3e-4, 1e-3])}},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=tune.RunConfig(name="trainer", storage_path=str(tmp_path))), timeout=120)
    assert grid.num_errors == 0, grid.errors
    losses = sorted(r.metrics["loss"] for r in grid)
    assert losses == [3e-4, 1e-3]
    best = grid.get_best_result()
    with open(os.path.join(best.checkpoint.path, "lr.txt")) as f:
        assert float(f.read()) == 3e-4
