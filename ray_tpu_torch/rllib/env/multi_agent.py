"""Multi-agent RL: the env API, its env runner and the learner fan-out
(port of ray_tpu/rllib/env/multi_agent.py).

Counterpart of the reference's MultiAgentEnv (rllib/env/multi_agent_env.py),
MultiAgentEnvRunner (rllib/env/multi_agent_env_runner.py) and the
multi-module paths of Learner/LearnerGroup (rllib/core/learner/learner.py
operates on a MultiRLModule keyed by ModuleID). Design notes:

- Policies are plain RLModules keyed by module id; the mapping from agent
  id to module id is ``policy_mapping_fn(agent_id, env_index)``, as in the
  reference (AlgorithmConfig.multi_agent, algorithm_config.py).
- Env stepping stays host-side numpy. In each vector step the runner
  batches every (env, agent) observation routed to the same module into
  ONE forward on the module's device, whatever the number of agents.
  Actions are drawn on the host from the runner's numpy generator by
  Gumbel-max (``gumbel_sample_logits``), so the same weights and seed give
  ray_tpu's actions.
- Trajectories are collected per (env, agent) and emitted as *fragments*:
  contiguous-time SampleBatches with per-step NEXT_OBS, so GAE runs per
  fragment with exact bootstrapping (the [T, B] math with B=1).
- Turn-based envs are supported: an agent whose action produced no
  immediate next observation keeps its transition open, accumulating any
  rewards credited to it, until it observes again or the episode ends
  (reference: AgentCollector semantics in env_runner_v2).

Remote runner actors (``num_env_runners > 0``) build their modules on
the CPU, as the single-agent group's do (``env_runner.host_config``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.rllib.env.env_runner import (
    EnvRunnerGroup,
    gumbel_sample_logits,
    summarize_episodes,
)
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    LOGP,
    NEXT_OBS,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
    VF_PREDS,
    SampleBatch,
)

DEFAULT_MODULE_ID = "default_policy"


def shared_policy_mapping_fn(agent_id, env_index=0, **kw) -> str:
    """Every agent maps to one shared module (reference default)."""
    return DEFAULT_MODULE_ID


class MultiAgentEnv:
    """Dict-in/dict-out env (reference: rllib/env/multi_agent_env.py).

    Subclasses define:
      - ``possible_agents``: list of all agent ids that may ever appear.
      - ``observation_dims`` / ``action_dims``: dicts agent_id -> int
        (flat obs dim / discrete action count).
      - ``reset(seed=None) -> (obs_dict, info_dict)``
      - ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
        infos)`` where ``terminateds``/``truncateds`` carry the special
        ``"__all__"`` key ending the episode for everyone.

    Only agents present in ``obs`` act next step; rewards may be credited
    to any agent (turn-based games pay the previous mover).
    """

    possible_agents: list = []
    observation_dims: dict = {}
    action_dims: dict = {}

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: dict):
        raise NotImplementedError

    def close(self) -> None:
        pass


class _OpenTransition:
    __slots__ = ("obs", "action", "logp", "vf", "reward")

    def __init__(self, obs, action, logp, vf):
        self.obs = obs
        self.action = action
        self.logp = logp
        self.vf = vf
        self.reward = 0.0


class _AgentTrajectory:
    """Per-(env, agent) fragment under construction."""

    __slots__ = ("rows", "open")

    def __init__(self):
        self.rows: list[tuple] = []  # (obs, act, logp, vf, rew, term, trunc, next_obs)
        self.open: _OpenTransition | None = None

    def close_open(self, next_obs, terminated: bool, truncated: bool) -> None:
        tr = self.open
        if tr is None:
            return
        self.rows.append((tr.obs, tr.action, tr.logp, tr.vf, tr.reward,
                          terminated, truncated, next_obs))
        self.open = None

    def pop_fragment(self) -> SampleBatch | None:
        if not self.rows:
            return None
        cols = list(zip(*self.rows))
        batch = SampleBatch({
            OBS: np.stack(cols[0]).astype(np.float32),
            ACTIONS: np.asarray(cols[1], np.int64),
            LOGP: np.asarray(cols[2], np.float32),
            VF_PREDS: np.asarray(cols[3], np.float32),
            REWARDS: np.asarray(cols[4], np.float32),
            TERMINATEDS: np.asarray(cols[5], bool),
            TRUNCATEDS: np.asarray(cols[6], bool),
            NEXT_OBS: np.stack(cols[7]).astype(np.float32),
        })
        self.rows = []
        return batch


def _flat(obs) -> np.ndarray:
    return np.asarray(obs, np.float32).reshape(-1)


class MultiAgentEnvRunner:
    """Steps N multi-agent envs, routing agents to modules via the policy
    mapping fn (reference: rllib/env/multi_agent_env_runner.py).

    ``sample()`` returns ``{module_id: [fragment SampleBatch, ...]}``; each
    fragment is contiguous in time for one (env, agent) pair.
    """

    def __init__(self, config: "AlgorithmConfig", seed: int = 0):  # noqa: F821
        self.config = config
        self.num_envs = config.num_envs_per_env_runner
        self.rollout_len = config.rollout_fragment_length
        if not callable(config.env):
            raise TypeError("multi-agent env must be a callable returning MultiAgentEnv")
        if getattr(config, "env_to_module_connector", None) is not None:
            raise NotImplementedError(
                "env_to_module_connector is not yet supported by the "
                "multi-agent runner (per-module pipelines pending); "
                "preprocess observations in the env"
            )
        self.envs = [config.env() for _ in range(self.num_envs)]
        self.mapping_fn: Callable = config.policy_mapping_fn
        specs = config.rl_module_specs()
        self.modules = {mid: spec.build(seed=seed + i)
                        for i, (mid, spec) in enumerate(specs.items())}
        self._rng = np.random.default_rng(seed)
        # Live episode state per env.
        self.cur_obs: list[dict] = [env.reset(seed=seed + i)[0]
                                    for i, env in enumerate(self.envs)]
        self.traj: list[dict[Any, _AgentTrajectory]] = [{} for _ in range(self.num_envs)]
        self._agent_to_module: list[dict] = [{} for _ in range(self.num_envs)]
        self._ep_return = np.zeros(self.num_envs, np.float64)
        self._ep_len = np.zeros(self.num_envs, np.int64)
        self._completed_returns: list[float] = []
        self._completed_lengths: list[int] = []

    def _module_for(self, env_i: int, agent_id) -> str:
        cache = self._agent_to_module[env_i]
        if agent_id not in cache:
            mid = self.mapping_fn(agent_id, env_i)
            if mid not in self.modules:
                raise ValueError(
                    f"policy_mapping_fn returned {mid!r} for agent "
                    f"{agent_id!r}, which is not a configured module id "
                    f"{sorted(self.modules)}"
                )
            cache[agent_id] = mid
        return cache[agent_id]

    def set_weights(self, weights: dict) -> None:
        for mid, w in weights.items():
            if mid in self.modules:
                self.modules[mid].set_weights(w)

    def get_weights(self) -> dict:
        return {mid: m.get_weights() for mid, m in self.modules.items()}

    def get_connector_state(self):
        # Connector pipelines are refused multi-agent (__init__); the
        # checkpoint path still asks through the group.
        return None

    def set_connector_state(self, state) -> None:
        pass

    def sample(self, weights: dict | None = None) -> dict[str, list[SampleBatch]]:
        if weights is not None:
            self.set_weights(weights)
        out: dict[str, list[SampleBatch]] = {mid: [] for mid in self.modules}

        for _ in range(self.rollout_len):
            # 1. Batch all acting (env, agent) pairs by module: one forward
            #    per module per vector step.
            per_module: dict[str, list[tuple[int, Any]]] = {}
            for env_i, obs_dict in enumerate(self.cur_obs):
                for agent_id in obs_dict:
                    per_module.setdefault(self._module_for(env_i, agent_id), []).append(
                        (env_i, agent_id))
            actions_by_env: list[dict] = [{} for _ in range(self.num_envs)]
            for mid, pairs in per_module.items():
                obs_mat = np.stack([_flat(self.cur_obs[e][a]) for e, a in pairs])
                fwd = self.modules[mid].forward_exploration(obs_mat)
                acts, logp = gumbel_sample_logits(fwd["action_dist_inputs"], self._rng)
                vf = fwd.get(VF_PREDS, np.zeros(len(pairs), np.float32))
                for j, (e, a) in enumerate(pairs):
                    actions_by_env[e][a] = int(acts[j])
                    t = self.traj[e].setdefault(a, _AgentTrajectory())
                    # A still-open transition means this agent acted before
                    # without observing since (cannot happen: observing is
                    # the precondition to act): close it defensively.
                    t.close_open(obs_mat[j], False, False)
                    t.open = _OpenTransition(obs_mat[j], int(acts[j]), float(logp[j]),
                                             float(vf[j]))

            # 2. Step every env.
            for env_i, env in enumerate(self.envs):
                obs, rew, term, trunc, _ = env.step(actions_by_env[env_i])
                done = bool(term.get("__all__", False)) or bool(trunc.get("__all__", False))
                self._ep_return[env_i] += float(sum(rew.values()))
                self._ep_len[env_i] += 1
                trajs = self.traj[env_i]
                # Credit rewards to whichever open transition earned them.
                for agent_id, r in rew.items():
                    t = trajs.get(agent_id)
                    if t is not None and t.open is not None:
                        t.open.reward += float(r)
                for agent_id, t in trajs.items():
                    if t.open is None:
                        continue
                    a_term = bool(term.get(agent_id, False)) or bool(term.get("__all__", False))
                    a_trunc = bool(trunc.get(agent_id, False)) or bool(
                        trunc.get("__all__", False))
                    if agent_id in obs and not (a_term or a_trunc):
                        t.close_open(_flat(obs[agent_id]), False, False)
                    elif a_term or a_trunc or done:
                        t.close_open(_flat(obs.get(agent_id, t.open.obs)),
                                     a_term or (done and not a_trunc), a_trunc)
                    # else: the agent did not observe and the episode goes
                    # on: its transition stays open, accumulating rewards.
                if done:
                    for agent_id, t in trajs.items():
                        frag = t.pop_fragment()
                        if frag is not None:
                            out[self._module_for(env_i, agent_id)].append(frag)
                    self._completed_returns.append(float(self._ep_return[env_i]))
                    self._completed_lengths.append(int(self._ep_len[env_i]))
                    self._ep_return[env_i] = 0.0
                    self._ep_len[env_i] = 0
                    self.traj[env_i] = {}
                    self._agent_to_module[env_i] = {}
                    obs = env.reset()[0]
                else:
                    # Per-agent done while the episode continues: the env
                    # may include the dead agent's FINAL observation in
                    # obs (reference convention); it must not act again.
                    obs = {a: o for a, o in obs.items()
                           if not (bool(term.get(a, False)) or bool(trunc.get(a, False)))}
                self.cur_obs[env_i] = obs

        # 3. Rollout boundary: flush fragments, truncating open transitions
        #    (their own next obs is unknown yet; GAE bootstraps from the
        #    transition's recorded next_obs with the lambda-chain cut).
        for env_i, trajs in enumerate(self.traj):
            for agent_id, t in trajs.items():
                if t.open is not None:
                    t.close_open(_flat(self.cur_obs[env_i].get(agent_id, t.open.obs)),
                                 False, True)
                frag = t.pop_fragment()
                if frag is not None:
                    out[self._module_for(env_i, agent_id)].append(frag)
        return out

    def get_metrics(self) -> dict:
        rets, lens = self._completed_returns, self._completed_lengths
        self._completed_returns, self._completed_lengths = [], []
        return summarize_episodes(rets, lens)

    def stop(self) -> None:
        for env in self.envs:
            try:
                env.close()
            except Exception:
                pass


class MultiAgentEnvRunnerGroup(EnvRunnerGroup):
    """Remote multi-agent runner fan-out (reference: EnvRunnerGroup with
    MultiAgentEnvRunner workers). Inherits construction, metrics merge and
    teardown; multi-agent sampling returns per-module fragment lists, so
    the single-agent sample()/sample_batches() surface is replaced by
    ``sample_fragments``."""

    runner_cls = MultiAgentEnvRunner

    def sample_fragments(self, weights=None) -> dict[str, list[SampleBatch]]:
        import ray_tpu_torch

        if self.local_runner is not None:
            results = [self.local_runner.sample(weights)]
        else:
            ref = ray_tpu_torch.put(weights) if weights is not None else None
            results = ray_tpu_torch.get([r.sample.remote(ref) for r in self.remote_runners])
        merged: dict[str, list[SampleBatch]] = {}
        for res in results:
            for mid, frags in res.items():
                merged.setdefault(mid, []).extend(frags)
        return merged

    def sample(self, weights=None):
        raise NotImplementedError(
            "multi-agent groups produce per-module fragments; use sample_fragments()")

    sample_batches = sample
    sample_async = sample


class MultiAgentLearnerGroup:
    """One TorchLearner per module id (reference: Learner over
    MultiRLModule, learner.py — per-module optimizers, the
    ``policies_to_train`` filter)."""

    def __init__(self, learner_factories: dict[str, Callable],
                 policies_to_train: Optional[list[str]] = None):
        self.learners = {mid: f() for mid, f in learner_factories.items()}
        self.policies_to_train = (set(policies_to_train) if policies_to_train is not None
                                  else set(self.learners))

    def update_epochs(self, batches: dict[str, SampleBatch], **kw) -> dict:
        metrics: dict = {}
        for mid, batch in batches.items():
            if mid not in self.learners or mid not in self.policies_to_train:
                continue
            # A module's share of the sampled rows can undershoot the
            # configured minibatch size (many policies / short fragments);
            # shrink it so every module still takes gradient steps instead
            # of silently skipping (SampleBatch.minibatches drops
            # remainders), to a power of two as the reference does (its
            # jitted update sees a bounded set of shapes).
            module_kw = kw
            if "minibatch_size" in kw and len(batch) < kw["minibatch_size"]:
                bucket = 1 << (max(len(batch), 1).bit_length() - 1)
                module_kw = {**kw, "minibatch_size": bucket}
            metrics[mid] = self.learners[mid].update_epochs(batch, **module_kw)
        # Flat aggregates for schedulers/loggers expecting scalars.
        per_module = dict(metrics)
        for k in {k for m in per_module.values() for k in m}:
            vals = [m[k] for m in per_module.values() if k in m]
            metrics[k] = float(np.mean(vals))
        return metrics

    def get_weights(self) -> dict:
        return {mid: learner.get_weights() for mid, learner in self.learners.items()}

    def set_weights(self, weights: dict) -> None:
        for mid, w in weights.items():
            if mid in self.learners:
                self.learners[mid].set_weights(w)

    def get_state(self) -> dict:
        return {mid: learner.get_state() for mid, learner in self.learners.items()}

    def set_state(self, state: dict) -> None:
        for mid, s in state.items():
            if mid in self.learners:
                self.learners[mid].set_state(s)

    def stop(self) -> None:
        pass
