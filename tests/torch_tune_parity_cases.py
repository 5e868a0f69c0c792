"""One Tune and Workflow script run under ray_tpu and under ray_tpu_torch,
each in its own process, by tests/test_torch_tune_parity.py:

    python tests/torch_tune_parity_cases.py ray_tpu|ray_tpu_torch

It prints one JSON object of outcomes: three Tuner runs over trainables
that report numpy functions of their config (FIFO to completion with a
checkpoint each report and ASHA from a seeded searcher, both with
max_concurrent_trials=1; synchronous PBT over a class trainable), each
trial's config, status, iterations, last metrics and checkpoint
contents, and the best config; then a workflow with a continuation, one
with a step that fails once and is resumed, and their statuses. It
imports only the package it is given, so the ray_tpu_torch run loads
neither jax nor ray_tpu.
"""

import importlib
import json
import os
import sys
import tempfile

import numpy as np

def _ckpt_contents(result):
    if result.checkpoint is None:
        return None
    path = result.checkpoint.path
    if os.path.exists(os.path.join(path, "w.npz")):
        z = np.load(os.path.join(path, "w.npz"))
        return {"w": z["w"].tolist(), "step": int(z["step"])}
    with open(os.path.join(path, "s.txt")) as f:
        return {"s": f.read()}


def _trials(grid):
    keep = ("loss", "norm", "acc", "score", "training_iteration", "done")
    return [{"config": r.config, "status": t.status,
             "metrics": {k: r.metrics[k] for k in keep if k in r.metrics},
             "iterations": len(r.metrics_history),
             "error": type(r.error).__name__ if r.error else None,
             "checkpoint": _ckpt_contents(r)} for r, t in zip(grid, grid._trials)]


def main(pkg: str) -> dict:
    os.environ["RAY_TPU_WORKFLOW_DIR"] = tempfile.mkdtemp()
    rt = importlib.import_module(pkg)
    tune = importlib.import_module(pkg + ".tune")
    search = importlib.import_module(pkg + ".tune.search")
    workflow = importlib.import_module(pkg + ".workflow")
    rt.init(num_cpus=4, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1})
    storage = tempfile.mkdtemp()
    out = {}

    def _curve(config):
        """Deterministic numpy metrics of the config; a checkpoint (an .npz
        of the same numbers) with every report."""
        train = importlib.import_module(pkg + ".train")
        w = np.linspace(0.0, 1.0, 5) * config["lr"]
        for i in range(1, 5):
            w = np.tanh(w + config["lr"] * np.arange(5))
            d = tempfile.mkdtemp()
            np.savez(os.path.join(d, "w.npz"), w=w, step=i)
            tune.report({"loss": float(np.square(w - 0.5).sum()),
                         "norm": float(np.linalg.norm(w))}, checkpoint=train.Checkpoint(d))

    def _asha_curve(config):
        for i in range(1, 9):
            tune.report({"acc": float(np.log1p(config["slope"] * i) + config["noise"])})

    # FIFO to completion: a checkpoint with every report, the controller
    # saving after each result.
    grid = tune.Tuner(
        _curve, param_space={"lr": tune.grid_search([0.5, 0.1, 0.9])},
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=1),
        run_config=tune.RunConfig(
            name="fifo", storage_path=storage,
            checkpoint_config=tune.CheckpointConfig(checkpoint_frequency=1))).fit()
    out["fifo"] = _trials(grid)
    out["fifo_best"] = grid.get_best_result().config
    out["fifo_errors"] = grid.num_errors

    # ASHA over a seeded searcher's draws, one trial at a time.
    space = {"slope": tune.grid_search([4.0, 1.0, 3.0, 2.0]), "noise": tune.uniform(0.0, 0.3)}
    gen = search.BasicVariantGenerator(space, num_samples=1, seed=7)
    grid = tune.Tuner(
        _asha_curve, param_space=space,
        tune_config=tune.TuneConfig(
            metric="acc", mode="max", search_alg=gen, num_samples=len(gen),
            max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(max_t=8, grace_period=1, reduction_factor=2)),
        run_config=tune.RunConfig(name="asha", storage_path=storage)).fit()
    out["asha"] = _trials(grid)
    out["asha_best"] = grid.get_best_result().config

    # Synchronous PBT over a class trainable: pauses, a checkpoint each
    # pause, the bottom trial cloning the top one's state. Both trials at
    # once (the boundary orders them; one at a time, the second trial
    # would not exist yet when the first reaches it).
    class Scored(tune.Trainable):
        def setup(self, config):
            self.score = 0.0

        def step(self):
            self.score += float(np.sqrt(self.config["rate"]))
            return {"score": self.score, "done": self.iteration + 1 >= 6}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "s.txt"), "w") as f:
                f.write(repr(self.score))

        def load_checkpoint(self, d):
            with open(os.path.join(d, "s.txt")) as f:
                self.score = float(f.read())

    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"rate": tune.uniform(0.5, 2.0)}, quantile_fraction=0.5,
        synch=True, seed=3)
    grid = tune.Tuner(
        Scored, param_space={"rate": tune.grid_search([0.04, 4.0])},
        tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt),
        run_config=tune.RunConfig(name="pbt", storage_path=storage)).fit()
    out["pbt"] = _trials(grid)

    # A workflow with a continuation, then one whose step fails once.
    @rt.remote
    def fib(n):
        if n <= 1:
            return n
        return workflow.continuation(fib_sum.bind(fib.bind(n - 1), fib.bind(n - 2)))

    @rt.remote
    def fib_sum(a, b):
        return a + b

    out["continuation"] = workflow.run(fib.bind(7), workflow_id="fib")
    flag = os.path.join(tempfile.mkdtemp(), "ok")

    @rt.remote(max_retries=0)
    def scale(x):
        return (np.arange(4) * x).tolist()

    @rt.remote(max_retries=0)
    def gate(v, path):
        if not os.path.exists(path):
            raise RuntimeError("first run fails")
        return {"sum": sum(v), "v": v}

    dag = gate.bind(scale.bind(3), flag)
    try:
        workflow.run(dag, workflow_id="gated")
        out["gated_first"] = "returned"
    except Exception as e:  # noqa: BLE001 — the class name is the outcome
        out["gated_first"] = type(e).__name__
    out["gated_status_failed"] = workflow.get_status("gated")
    open(flag, "w").close()
    out["gated_resumed"] = workflow.resume("gated")
    out["statuses"] = sorted(workflow.list_all())
    out["gated_output"] = workflow.get_output("gated")
    rt.shutdown()
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "ray_tpu") and pkg != "ray_tpu")
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1]), sort_keys=True))
