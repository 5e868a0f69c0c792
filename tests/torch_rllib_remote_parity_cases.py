"""One script run under ray_tpu and under ray_tpu_torch, each in its own
process, by tests/test_torch_rllib_remote.py:

    python tests/torch_rllib_remote_parity_cases.py ray_tpu|ray_tpu_torch sync|async|groups

Each part runs on a cluster of its own (the test runs the six processes
side by side).
RLlib's remote groups (head_shards=1). "sync": PPO on CartPole-v1
with 2 remote env runners (4 envs, 32-step fragments, batch 256) and 2
remote learners for 2 iterations; one LearnerGroup(num_learners=2)
update on a fixed batch, and on a batch of 1 row (replicated); and
whether stop() leaves a runner or learner alive. "async": IMPALA and
APPO at their defaults. "groups": the merged connector state of 2
runners, and a multi-agent group's fragments from 2 runners. Every module starts from the same carried
weights, drawn here with numpy (jax.random and torch draw different
initial weights). It prints one JSON object; the port's learners run on
the CPU. It imports only the package it is given, so the ray_tpu_torch
run loads neither jax nor ray_tpu.
"""

import importlib
import json
import sys

import numpy as np

T = 60  # every get is bounded


def carry(tree, rng):
    """The same tree of float32 leaves under both packages: dicts in
    sorted key order, lists in order, each leaf ~N(0, 1/fan_in); the
    last policy layer small, as both packages initialise it."""
    if isinstance(tree, dict):
        return {k: carry(tree[k], rng) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [carry(v, rng) for v in tree]
    a = np.asarray(tree)
    scale = 1.0 / np.sqrt(a.shape[0]) if a.ndim == 2 else 0.1
    return (rng.standard_normal(a.shape) * scale).astype(np.float32)


def carried(weights, seed):
    w = carry(weights, np.random.default_rng(seed))
    if isinstance(w, dict) and "pi" in w:
        w["pi"][-1]["w"] = w["pi"][-1]["w"] * np.float32(0.01)
    return w


def as_list(tree):
    if isinstance(tree, dict):
        return {k: as_list(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [as_list(v) for v in tree]
    return np.asarray(tree, np.float64).tolist()


def scalars(metrics):
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, (int, float, np.floating, np.integer))}


def main(pkg: str, part: str) -> dict:
    rt = importlib.import_module(pkg)
    rllib = importlib.import_module(pkg + ".rllib")
    sb = importlib.import_module(pkg + ".rllib.sample_batch")
    ma = importlib.import_module(pkg + ".rllib.env.multi_agent")
    conn = importlib.import_module(pkg + ".rllib.connectors")
    er = importlib.import_module(pkg + ".rllib.env.env_runner")
    rt.init(num_cpus=6, object_store_memory=128 * 1024 * 1024,
            _system_config={"head_shards": 1})
    on_cpu = (lambda c: c.learners(device="cpu")) if pkg == "ray_tpu_torch" else (lambda c: c)
    out = {}
    if part == "sync":
        _sync(rt, rllib, sb, on_cpu, out)
    elif part == "async":
        _async(rllib, on_cpu, out)
    else:
        _groups(rt, rllib, conn, er, ma, on_cpu, out)
    rt.shutdown()
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "ray_tpu") and pkg != "ray_tpu")
    return out


def _sync(rt, rllib, sb, on_cpu, out):
    # PPO: 2 remote runners, 2 remote learners, 2 iterations.
    cfg = on_cpu(rllib.PPOConfig().environment("CartPole-v1")
                 .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                              rollout_fragment_length=32)
                 .training(train_batch_size=256).learners(num_learners=2))
    algo = cfg.build()
    algo.learner_group.set_weights(carried(algo.learner_group.get_weights(), 1))
    seen = []
    real = algo.env_runner_group.sample_batches

    def sample_batches(weights=None):
        got = real(weights)
        seen.append([{k: np.asarray(b[k]).tolist() for k in
                      ("obs", "actions", "rewards", "behavior_logits")} for b in got])
        return got

    algo.env_runner_group.sample_batches = sample_batches
    iters = []
    for _ in range(2):
        r = algo.train()
        per = [rt.get(a.get_weights.remote(), timeout=T) for a in algo.learner_group.remotes]
        same = all(np.array_equal(x, y) for x, y in
                   zip(_leaves(per[0]), _leaves(per[1])))
        iters.append({"metrics": scalars(r), "weights": as_list(algo.get_weights()),
                      "learners_equal": same})
    out["ppo"] = {"iterations": iters, "samples": seen}
    # LearnerGroup(num_learners=2), the same learners from new carried
    # weights: one update on a fixed batch, then on a batch of one row
    # (replicated to both learners).
    lg = algo.learner_group
    lg.set_weights(carried(lg.get_weights(), 2))
    rng = np.random.default_rng(3)
    n = 64
    batch = {sb.OBS: rng.standard_normal((n, 4)).astype(np.float32),
             sb.ACTIONS: rng.integers(0, 2, n).astype(np.int64),
             sb.LOGP: np.log(np.full(n, 0.5, np.float32)),
             sb.ADVANTAGES: rng.standard_normal(n).astype(np.float32),
             sb.VALUE_TARGETS: rng.standard_normal(n).astype(np.float32),
             sb.VF_PREDS: np.zeros(n, np.float32)}
    m = lg.update_epochs(sb.SampleBatch(dict(batch)), num_epochs=1, minibatch_size=16)
    out["learner_group"] = {"metrics": scalars(m), "weights": as_list(lg.get_weights())}
    one = sb.SampleBatch({k: v[:1] for k, v in batch.items()})
    m = lg.update_epochs(one, num_epochs=1, minibatch_size=1)
    per = [rt.get(a.get_weights.remote(), timeout=T) for a in lg.remotes]
    out["learner_group_one_row"] = {
        "metrics": scalars(m), "weights": as_list(lg.get_weights()),
        "learners_equal": all(np.array_equal(x, y)
                              for x, y in zip(_leaves(per[0]), _leaves(per[1])))}
    runners = list(algo.env_runner_group.remote_runners)
    learners = list(lg.remotes)
    algo.stop()
    out["stopped"] = [_dead(rt, a) for a in runners + learners]


def _groups(rt, rllib, conn, er, ma, on_cpu, out):
    # The connector states of 2 runners, merged.
    cfg = on_cpu(rllib.PPOConfig().environment("CartPole-v1")
                 .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                              rollout_fragment_length=16,
                              env_to_module_connector=lambda: [conn.NormalizeObservations()]))
    cfg._infer_spaces()
    group = er.EnvRunnerGroup(cfg)
    w = carried(cfg.rl_module_spec().build(seed=0).get_weights(), 4)
    group.sample_batches(w)
    merged = group.get_connector_state()
    out["connector"] = [{k: (np.asarray(v, np.float64).tolist() if k != "kind" else v)
                         for k, v in s.items()} for s in merged]
    again = rt.get([r.get_connector_state.remote() for r in group.remote_runners], timeout=T)
    out["connector_broadcast"] = [[s["count"] for s in st] for st in again]
    group.stop()

    # A multi-agent group's fragments from 2 remote runners.
    cfg = on_cpu(rllib.PPOConfig().environment(make_signal_match(ma.MultiAgentEnv))
                 .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                              rollout_fragment_length=12)
                 .multi_agent(policies=["m0", "m1"],
                              policy_mapping_fn=lambda a, i=0, **k: "m" + a[1]))
    cfg._infer_spaces()
    group = ma.MultiAgentEnvRunnerGroup(cfg)
    weights = {mid: carried(s.build(seed=0).get_weights(), 5 + i)
               for i, (mid, s) in enumerate(sorted(cfg.rl_module_specs().items()))}
    frags = group.sample_fragments(weights)
    out["multi_agent"] = {mid: [len(f) for f in fl] for mid, fl in sorted(frags.items())}
    runners = list(group.remote_runners)
    group.stop()
    out["stopped_multi_agent"] = [_dead(rt, a) for a in runners]


def _async(rllib, on_cpu, out):
    # IMPALA and APPO at their defaults (tests/test_rllib.py's checks for
    # IMPALA, on its defaults here: 2 runners, 2 requests in flight each).
    for name in ("IMPALAConfig", "APPOConfig"):
        algo = on_cpu(getattr(rllib, name)().environment("CartPole-v1")).build()
        r = algo.train()
        out[name] = {"updates_at_least_1": r["num_learner_updates"] >= 1,
                     "finite": bool(np.isfinite(r["total_loss"])),
                     "rho_near_1": bool(0.5 < r.get("mean_rho", r.get("mean_ratio")) < 2.0),
                     "steps_at_least_batch": r["num_env_steps_sampled"] >= 512}
        algo.stop()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _dead(rt, actor) -> bool:
    """Whether a call on ``actor`` fails (the actor was killed)."""
    try:
        rt.get(actor.get_weights.remote() if hasattr(actor, "get_weights")
               else actor.get_metrics.remote(), timeout=10)
    except Exception:  # noqa: BLE001 — any failure: the actor is gone
        return True
    return False


def make_signal_match(base):
    """tests/torch_rllib_helpers.py's SignalMatch (ray_tpu's multi-agent
    test env) on ``base``, the package's MultiAgentEnv: two agents each
    see a one-hot signal and score 1 for naming it, 8-step episodes."""

    class SignalMatch(base):
        possible_agents = ["a0", "a1"]
        observation_dims = {"a0": 3, "a1": 3}
        action_dims = {"a0": 3, "a1": 3}

        def __init__(self, episode_len: int = 8):
            self.episode_len = episode_len
            self._rng = np.random.default_rng(0)
            self.t = 0

        def _obs(self):
            self.signals = {a: int(self._rng.integers(3)) for a in self.possible_agents}
            return {a: np.eye(3, dtype=np.float32)[self.signals[a]]
                    for a in self.possible_agents}

        def reset(self, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self.t = 0
            return self._obs(), {}

        def step(self, action_dict):
            rewards = {a: float(action_dict[a] == self.signals[a]) for a in action_dict}
            self.t += 1
            done = self.t >= self.episode_len
            obs = self._obs() if not done else {}
            return obs, rewards, {"__all__": done}, {"__all__": False}, {}

    return SignalMatch


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], sys.argv[2]), sort_keys=True))
