"""The port's side of tests/test_torch_rllib_mesh.py: learner updates
through a ``data`` mesh, on each rank of a gloo CPU group spawned by
ray_tpu_torch.parallel._spawn, and the same learners without a mesh, for
the test's own process. Imports no JAX (the children must not load XLA);
every input is made here with numpy from a seed, so every rank and the
test make the same ones."""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.ops.tree import flatten
from ray_tpu_torch.rllib import SampleBatch, TorchLearner
from ray_tpu_torch.rllib.algorithms import cql, dqn, impala, ppo, sac
from ray_tpu_torch.rllib.core.learner import make_optimizer

ROWS = 64  # a minibatch: 32, 16 rows a rank on 2 and 4 ranks
T = 8  # IMPALA's rollout: 8 columns of 8 steps
STEPS = 2  # updates a case takes, so that Adam's moments are not fresh
KINDS = ("ppo", "dqn", "sac", "cql", "impala")


def _config(kind):
    cfg = {"ppo": ppo.PPOConfig, "dqn": dqn.DQNConfig, "sac": sac.SACConfig,
           "cql": cql.CQLConfig, "impala": impala.IMPALAConfig}[kind]()
    dims = (3, 2) if kind in ("sac", "cql") else (4, 3)
    return cfg.environment(observation_dim=dims[0], action_dim=dims[1]).learners(device="cpu")


def learner(kind: str, mesh=None) -> TorchLearner:
    """The algorithm's learner (its module from seed 0, its loss and
    optimizer), on ``mesh`` if given."""
    cfg = _config(kind)
    if kind in ("sac", "cql"):
        cfg.action_low, cfg.action_high = -np.ones(2, np.float32), np.ones(2, np.float32)
        cfg.grad_clip = 1.0
    loss = {"ppo": lambda: ppo.make_ppo_loss(cfg), "dqn": dqn.make_dqn_loss,
            "sac": lambda: sac.make_sac_loss(cfg, 0.0, 1.0, -2.0),
            "cql": lambda: cql.make_cql_loss(cfg, 0.0, 1.0, -2.0),
            "impala": lambda: impala.make_impala_loss(cfg, T)}[kind]()
    return TorchLearner(cfg.rl_module_spec().build(seed=0), loss, make_optimizer(cfg),
                        mesh=mesh, time_major_T=T if kind == "impala" else None)


def batches(kind: str, rows: int = ROWS) -> list[dict]:
    """STEPS minibatches of the columns the algorithm's loss reads."""
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(100 * KINDS.index(kind) + step)
        if kind in ("sac", "cql"):
            b = {"obs": rng.standard_normal((rows, 3)),
                 "actions": rng.uniform(-0.9, 0.9, (rows, 2)),
                 "td_targets": rng.standard_normal(rows),
                 "noise_pi": rng.standard_normal((rows, 2))}
            if kind == "cql":
                n = _config(kind).num_actions
                b.update(next_obs=rng.standard_normal((rows, 3)),
                         rand_actions=rng.uniform(-1.0, 1.0, (rows * n, 2)),
                         noise_cur=rng.standard_normal((rows * n, 2)),
                         noise_nxt=rng.standard_normal((rows * n, 2)),
                         use_bc=np.float32(step % 2))
        else:
            b = {"obs": rng.standard_normal((rows, 4)),
                 "actions": rng.integers(0, 3, rows),
                 "action_logp": np.log(1 / 3) + 0.3 * rng.standard_normal(rows),
                 "advantages": 2.0 + 3.0 * rng.standard_normal(rows),
                 "value_targets": rng.standard_normal(rows),
                 "td_targets": rng.standard_normal(rows),
                 "next_obs": rng.standard_normal((rows, 4)),
                 "behavior_logits": rng.standard_normal((rows, 3)),
                 "rewards": rng.standard_normal(rows),
                 "terminateds": rng.random(rows) < 0.1,
                 "truncateds": rng.random(rows) < 0.05}
        out.append({k: (v.astype(np.float32) if v.dtype == np.float64 else v)
                    for k, v in b.items()})
    return out


def updates(kind: str, mesh=None) -> dict:
    """STEPS updates of the learner: each step's metrics, then the
    parameters and the optimizer state (flat dotted paths)."""
    lrn = learner(kind, mesh)
    metrics = [lrn.update(SampleBatch(dict(b))) for b in batches(kind)]
    state = lrn.get_state()
    return {"metrics": metrics, "params": flatten(state["params"]),
            "opt_state": flatten(state["opt_state"])}


def ppo_algorithm(mesh=None) -> dict:
    """One PPO train() on CartPole-v1 (2 envs, a 32-row batch, 2 epochs
    of 16-row minibatches), every rank from the same seed."""
    cfg = (ppo.PPOConfig().environment("CartPole-v1").learners(device="cpu", mesh=mesh)
           .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
           .training(train_batch_size=32, minibatch_size=16, num_epochs=2).debugging(seed=0))
    algo = cfg.build()
    try:
        assert algo.learner_group.local.mesh is mesh
        result = algo.train()
        return {"metrics": {k: result[k] for k in ("total_loss", "policy_loss", "grad_norm")},
                "params": flatten(algo.get_weights())}
    finally:
        algo.cleanup()


def run(rank: int, world: int) -> dict:
    """Every case on this rank, through a ("data",) mesh of the group."""
    from ray_tpu_torch.parallel import MeshConfig

    torch.set_num_threads(1)
    mesh = MeshConfig().build("cpu")
    out = {kind: updates(kind, mesh) for kind in KINDS}
    out["ppo_algorithm"] = ppo_algorithm(mesh)
    try:
        learner("ppo", mesh).update(SampleBatch(batches("ppo", rows=ROWS - 1)[0]))
        out["indivisible"] = ""
    except ValueError as e:
        out["indivisible"] = str(e)
    return out
