"""EnvRunners: step vectorized envs with the current policy (port of
ray_tpu/rllib/env/env_runner.py, the local runner).

Counterpart of the reference's SingleAgentEnvRunner
(rllib/env/single_agent_env_runner.py:68) and EnvRunnerGroup
(rllib/env/env_runner_group.py:71). Env stepping stays host-side numpy;
policy inference is one batched forward on the module's device per
vector step (no per-env Python forward), and actions are drawn on the
host by Gumbel-max from a numpy generator, as in ray_tpu, so the same
weights and seed give the same actions in both packages. Episode
bookkeeping uses SAME_STEP autoreset semantics implemented locally so
value bootstrapping is exact for truncations and version-stable across
gymnasium releases.

With ``num_env_runners > 0`` the group's runners are actors of the
port's core, each on ``num_cpus_per_env_runner`` CPUs and no GPU lease.
A worker without a lease sees no card (``CUDA_VISIBLE_DEVICES=""``), so
a remote runner builds its module on the CPU whatever ``config.device``
is (``host_config``); weights reach it as numpy, one ``put`` per
broadcast. The reference's runners run on the host as well, its
chipless workers running JAX on the CPU."""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    BEHAVIOR_LOGITS,
    LOGP,
    NEXT_OBS,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
    VF_PREDS,
    SampleBatch,
)


class _SyncVectorEnv:
    """N single envs stepped together with immediate (same-step) reset.

    On done, the returned obs is the NEXT episode's initial observation and
    the terminal observation is kept in `final_obs` for bootstrapping."""

    def __init__(self, env_fns: list[Callable[[], Any]], seed: int = 0):
        self.envs = [fn() for fn in env_fns]
        self.n = len(self.envs)
        self._seed = seed

    def reset(self) -> np.ndarray:
        obs = [e.reset(seed=self._seed + i)[0] for i, e in enumerate(self.envs)]
        return np.stack(obs).astype(np.float32)

    def step(self, actions: np.ndarray):
        obs_out, rewards, terms, truncs, final_obs = [], [], [], [], [None] * self.n
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            obs, r, term, trunc, _ = env.step(a)
            if term or trunc:
                final_obs[i] = np.asarray(obs, np.float32)
                obs = env.reset()[0]
            obs_out.append(obs)
            rewards.append(r)
            terms.append(term)
            truncs.append(trunc)
        return (
            np.stack(obs_out).astype(np.float32),
            np.asarray(rewards, np.float32),
            np.asarray(terms, bool),
            np.asarray(truncs, bool),
            final_obs,
        )

    def close(self):
        for e in self.envs:
            try:
                e.close()
            except Exception:
                pass


def _make_env_fn(env: Any) -> Callable[[], Any]:
    if callable(env):
        return env
    if isinstance(env, str):
        import gymnasium

        return lambda: gymnasium.make(env)
    raise TypeError(f"env must be a gym id or callable, got {type(env)}")


class SingleAgentEnvRunner:
    """Samples fixed-length rollouts (reference:
    rllib/env/single_agent_env_runner.py:68 sample())."""

    def __init__(self, config: "AlgorithmConfig", seed: int = 0):  # noqa: F821
        self.config = config
        self.num_envs = config.num_envs_per_env_runner
        self.rollout_len = config.rollout_fragment_length
        self.vec = _SyncVectorEnv(
            [_make_env_fn(config.env) for _ in range(self.num_envs)], seed=seed
        )
        self.module = config.rl_module_spec().build(seed=seed)
        # env-to-module connector pipeline (reference: EnvRunner applying
        # the env_to_module connector before the RLModule forward;
        # transformed observations are what lands in the sample batch).
        from ray_tpu_torch.rllib.connectors import build_pipeline

        self._obs_pipe = build_pipeline(
            getattr(config, "env_to_module_connector", None))
        self.obs = self._connect(self.vec.reset())
        self._rng = np.random.default_rng(seed)
        # Per-env running episode stats.
        self._ep_return = np.zeros(self.num_envs, np.float64)
        self._ep_len = np.zeros(self.num_envs, np.int64)
        self._completed_returns: list[float] = []
        self._completed_lengths: list[int] = []

    # ------------------------------------------------------------------

    def _connect(self, obs: np.ndarray, update: bool = True) -> np.ndarray:
        if self._obs_pipe is None:
            return obs
        return np.asarray(self._obs_pipe(obs, update=update))

    def _connected_next(self, next_obs, final_obs):
        """(t_next, next_for_value): next obs through the connector, with
        terminal rows substituted by their true final observation run
        through the pipeline WITHOUT updating running stats (their values
        are only bootstrapped, never acted on)."""
        t_next = self._connect(next_obs)
        next_for_value = t_next.copy()
        done_idx = [i for i, fo in enumerate(final_obs) if fo is not None]
        if done_idx:
            finals = self._connect(
                np.stack([final_obs[i] for i in done_idx]), update=False)
            for j, i in enumerate(done_idx):
                next_for_value[i] = finals[j]
        return t_next, next_for_value

    def set_weights(self, weights) -> None:
        self.module.set_weights(weights)

    def get_weights(self):
        return self.module.get_weights()

    def get_connector_state(self):
        return self._obs_pipe.get_state() if self._obs_pipe else None

    def set_connector_state(self, state) -> None:
        if self._obs_pipe is not None and state is not None:
            self._obs_pipe.set_state(state)

    def sample(self, weights=None) -> SampleBatch:
        """One rollout of [T, B] transitions, flattened to [T*B] with GAE
        inputs attached (vf_preds, bootstrap via next_obs values)."""
        if weights is not None:
            self.module.set_weights(weights)
        # Modules owning their exploration (epsilon-greedy DQN, squashed
        # gaussian SAC, any continuous policy) take the generic path: the
        # module decides actions/extras, the runner just steps envs.
        if hasattr(self.module, "explore_actions"):
            return self._sample_generic()
        T, B = self.rollout_len, self.num_envs
        obs_buf = np.empty((T, B) + self.obs.shape[1:], np.float32)
        act_buf = np.empty((T, B), np.int64)
        logp_buf = np.empty((T, B), np.float32)
        vf_buf = np.empty((T, B), np.float32)
        logits_buf: np.ndarray | None = None
        rew_buf = np.empty((T, B), np.float32)
        term_buf = np.empty((T, B), bool)
        trunc_buf = np.empty((T, B), bool)
        next_obs_buf = np.empty_like(obs_buf)

        for t in range(T):
            out = self.module.forward_exploration(self.obs)
            logits = out["action_dist_inputs"]
            if logits_buf is None:
                logits_buf = np.empty((T, B, logits.shape[-1]), np.float32)
            actions, logp = gumbel_sample_logits(logits, self._rng)
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logp
            vf_buf[t] = out[VF_PREDS]
            logits_buf[t] = logits
            next_obs, rewards, terms, truncs, final_obs = self.vec.step(actions)
            # Bootstrapping for truncated (time-limit) episodes uses the
            # true terminal observation, not the post-reset one.
            t_next, next_for_value = self._connected_next(next_obs, final_obs)
            rew_buf[t], term_buf[t], trunc_buf[t] = rewards, terms, truncs
            next_obs_buf[t] = next_for_value
            self._track_episodes(rewards, terms, truncs)
            self.obs = t_next

        flat = lambda a: a.reshape((T * B,) + a.shape[2:])  # noqa: E731
        return SampleBatch(
            {
                OBS: flat(obs_buf),
                ACTIONS: flat(act_buf),
                LOGP: flat(logp_buf),
                VF_PREDS: flat(vf_buf),
                BEHAVIOR_LOGITS: flat(logits_buf),
                REWARDS: flat(rew_buf),
                TERMINATEDS: flat(term_buf),
                TRUNCATEDS: flat(trunc_buf),
                NEXT_OBS: flat(next_obs_buf),
                "t": np.tile(np.arange(T)[:, None], (1, B)).reshape(-1),
                "env_id": np.tile(np.arange(B)[None, :], (T, 1)).reshape(-1),
            }
        )

    def _sample_generic(self) -> SampleBatch:
        """Rollout driven by module.explore_actions(obs, rng) ->
        (actions, extras). Collects the off-policy transition tuple
        (obs, action, reward, terminated, truncated, next_obs) plus any
        per-step extras the module returns (e.g. logp)."""
        T, B = self.rollout_len, self.num_envs
        obs_buf = np.empty((T, B) + self.obs.shape[1:], np.float32)
        next_obs_buf = np.empty_like(obs_buf)
        rew_buf = np.empty((T, B), np.float32)
        term_buf = np.empty((T, B), bool)
        trunc_buf = np.empty((T, B), bool)
        act_buf = None
        extra_bufs: dict[str, np.ndarray] = {}

        for t in range(T):
            actions, extras = self.module.explore_actions(self.obs, self._rng)
            actions = np.asarray(actions)
            if act_buf is None:
                act_buf = np.empty((T,) + actions.shape, actions.dtype)
            act_buf[t] = actions
            for k, v in (extras or {}).items():
                v = np.asarray(v)
                if k not in extra_bufs:
                    extra_bufs[k] = np.empty((T,) + v.shape, v.dtype)
                extra_bufs[k][t] = v
            next_obs, rewards, terms, truncs, final_obs = self.vec.step(actions)
            t_next, next_for_value = self._connected_next(next_obs, final_obs)
            obs_buf[t] = self.obs
            rew_buf[t], term_buf[t], trunc_buf[t] = rewards, terms, truncs
            next_obs_buf[t] = next_for_value
            self._track_episodes(rewards, terms, truncs)
            self.obs = t_next

        flat = lambda a: a.reshape((T * B,) + a.shape[2:])  # noqa: E731
        out = SampleBatch({
            OBS: flat(obs_buf),
            ACTIONS: flat(act_buf),
            REWARDS: flat(rew_buf),
            TERMINATEDS: flat(term_buf),
            TRUNCATEDS: flat(trunc_buf),
            NEXT_OBS: flat(next_obs_buf),
        })
        for k, buf in extra_bufs.items():
            out[k] = flat(buf)
        return out

    def _track_episodes(self, rewards, terms, truncs) -> None:
        self._ep_return += rewards
        self._ep_len += 1
        done = terms | truncs
        for i in np.nonzero(done)[0]:
            self._completed_returns.append(float(self._ep_return[i]))
            self._completed_lengths.append(int(self._ep_len[i]))
            self._ep_return[i] = 0.0
            self._ep_len[i] = 0

    def get_metrics(self) -> dict:
        """Drain episode stats (reference: env runner metrics logger)."""
        rets, lens = self._completed_returns, self._completed_lengths
        self._completed_returns, self._completed_lengths = [], []
        return summarize_episodes(rets, lens)

    def stop(self) -> None:
        self.vec.close()


def summarize_episodes(returns: list[float], lengths: list[int]) -> dict:
    if not returns:
        return {"num_episodes": 0}
    return {
        "num_episodes": len(returns),
        "episode_return_mean": float(np.mean(returns)),
        "episode_return_max": float(np.max(returns)),
        "episode_return_min": float(np.min(returns)),
        "episode_len_mean": float(np.mean(lengths)),
    }


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def gumbel_sample_logits(
    logits: np.ndarray, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Sample categorical actions host-side via gumbel-max (avoids device
    rng state) and return (actions, logp_of_actions)."""
    g = rng.gumbel(size=logits.shape).astype(np.float32)
    actions = np.argmax(logits + g, axis=-1)
    logp_all = logits - _logsumexp(logits)
    return actions, np.take_along_axis(logp_all, actions[..., None], -1)[..., 0]


def merge_episode_metrics(per: list[dict]) -> dict:
    """Episode-count-weighted merge of per-runner summarize_episodes dicts."""
    merged: dict = {"num_episodes": sum(m.get("num_episodes", 0) for m in per)}
    with_eps = [m for m in per if "episode_return_mean" in m]
    if with_eps:
        w = [m["num_episodes"] for m in with_eps]
        merged["episode_return_mean"] = float(
            np.average([m["episode_return_mean"] for m in with_eps], weights=w)
        )
        merged["episode_return_max"] = max(m["episode_return_max"] for m in with_eps)
        merged["episode_return_min"] = min(m["episode_return_min"] for m in with_eps)
        merged["episode_len_mean"] = float(
            np.average([m["episode_len_mean"] for m in with_eps], weights=w)
        )
    return merged


def host_config(config):
    """A copy of ``config`` whose modules live on the CPU: what a remote
    runner builds from (multi-agent specs included)."""
    import dataclasses

    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    c = config.copy()
    c.device, c.mesh = "cpu", None
    if c.policies is not None:
        c.policies = {mid: dataclasses.replace(s, device="cpu")
                      if isinstance(s, RLModuleSpec) else s
                      for mid, s in c.policies.items()}
    return c


class EnvRunnerGroup:
    """Remote env-runner actors + local fallback (reference:
    rllib/env/env_runner_group.py:71). Subclasses swap ``runner_cls``
    (multi-agent group) without re-implementing the fan-out."""

    runner_cls: type = None  # set below (class defined later in this file)

    def __init__(self, config: "AlgorithmConfig"):  # noqa: F821
        import ray_tpu_torch

        self.config = config
        self.num_remote = config.num_env_runners
        if self.num_remote == 0:
            self.local_runner = self.runner_cls(config, seed=config.seed)
            self.remote_runners = []
        else:
            self.local_runner = None
            cls = ray_tpu_torch.remote(num_cpus=config.num_cpus_per_env_runner)(
                self.runner_cls)
            remote_config = host_config(config)
            self.remote_runners = [
                cls.remote(remote_config, seed=config.seed + 1000 * (i + 1))
                for i in range(self.num_remote)
            ]

    def sample(self, weights=None) -> SampleBatch:
        return SampleBatch.concat_samples(self.sample_batches(weights))

    def sample_batches(self, weights=None) -> list[SampleBatch]:
        """Per-runner batches. Each keeps its own [T*B] t-major layout, so
        time-structured postprocessing (GAE/vtrace) must happen per batch
        BEFORE concatenation."""
        import ray_tpu_torch

        if self.local_runner is not None:
            return [self.local_runner.sample(weights)]
        ref = ray_tpu_torch.put(weights) if weights is not None else None
        return ray_tpu_torch.get([r.sample.remote(ref) for r in self.remote_runners])

    def sample_async(self, weights=None) -> list:
        """Kick off sampling on every remote runner; returns (runner, ref)
        pairs (reference: foreach_env_runner_async, the IMPALA path)."""
        import ray_tpu_torch

        ref = ray_tpu_torch.put(weights) if weights is not None else None
        return [(r, r.sample.remote(ref)) for r in self.remote_runners]

    def get_metrics(self) -> dict:
        import ray_tpu_torch

        if self.local_runner is not None:
            per = [self.local_runner.get_metrics()]
        else:
            per = ray_tpu_torch.get([r.get_metrics.remote() for r in self.remote_runners])
        return merge_episode_metrics(per)

    def get_connector_state(self):
        """Merged pipeline state across ALL runners (reference:
        MeanStdFilter sync semantics): gather every runner's state,
        combine stateful connectors (Chan's parallel combine for running
        normalizers), and broadcast the merged stats back so each runner
        keeps normalizing with the shared statistics."""
        import ray_tpu_torch

        from ray_tpu_torch.rllib.connectors import merge_pipeline_states

        if self.local_runner is not None:
            return self.local_runner.get_connector_state()
        if not self.remote_runners:
            return None
        states = ray_tpu_torch.get([r.get_connector_state.remote()
                                    for r in self.remote_runners])
        merged, mergeable = merge_pipeline_states(states)
        if merged is not None:
            # Gathering HARVESTED each runner's delta, so the merged
            # result must go back even with one runner or the samples
            # would vanish from every future merge. Broadcast ONLY
            # genuinely merged positions; unmergeable (unknown-kind)
            # connector state stays per-runner — a None entry is skipped
            # by ConnectorPipelineV2.set_state.
            broadcast = [m if ok else None for m, ok in zip(merged, mergeable)]
            if any(b is not None for b in broadcast):
                ray_tpu_torch.get([r.set_connector_state.remote(broadcast)
                                   for r in self.remote_runners])
        return merged

    def sync_connector_states(self) -> None:
        """Periodic cross-runner stats sync (called by Algorithm.step);
        no-op with a local runner or no stateful connectors."""
        if self.local_runner is None and len(self.remote_runners) > 1:
            self.get_connector_state()

    def set_connector_state(self, state) -> None:
        """Seed every runner's pipeline (restore path)."""
        import ray_tpu_torch

        if state is None:
            return
        if self.local_runner is not None:
            self.local_runner.set_connector_state(state)
        else:
            ray_tpu_torch.get([r.set_connector_state.remote(state)
                               for r in self.remote_runners])

    def stop(self) -> None:
        import ray_tpu_torch

        if self.local_runner is not None:
            self.local_runner.stop()
        for r in self.remote_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass


EnvRunnerGroup.runner_cls = SingleAgentEnvRunner
