"""Algorithm + AlgorithmConfig: the RL training controller (port of
ray_tpu/rllib/algorithms/algorithm.py).

Counterpart of the reference's Algorithm (rllib/algorithms/algorithm.py:199
— a Tune Trainable; step :924, training_step :1749) and AlgorithmConfig
(algorithm_config.py — configured by chained .environment()/.training()/
.env_runners() calls). Algorithm subclasses ray_tpu_torch.tune.Trainable.

Beside ray_tpu's options, ``learners()`` takes the ``device`` every
module lives on (default "cuda"; pass "cpu" for the CPU; remote env
runners build theirs on the CPU, see ``env/env_runner.py``); its ``mesh``
is a one-dimensional torch DeviceMesh with a ``data`` dimension, over
which the learner shards each minibatch (``core/learner.py``).
Multi-agent configs (``.multi_agent()``) train one module per policy id
(``env/multi_agent.py``); checkpoints are pickles of numpy state, keyed
by module id where there are several, as in ray_tpu."""

from __future__ import annotations

import copy
import os
import pickle
from typing import Any, Optional, Type

import numpy as np

from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.env.multi_agent import (
    DEFAULT_MODULE_ID,
    MultiAgentEnvRunnerGroup,
    shared_policy_mapping_fn,
)
from ray_tpu_torch.tune.trainable import Trainable


class AlgorithmConfig:
    """Chained configuration (reference: rllib/algorithms/algorithm_config.py)."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        # environment
        self.env: Any = None
        self.observation_dim: int | None = None
        self.action_dim: int | None = None
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 8
        self.rollout_fragment_length = 64
        self.num_cpus_per_env_runner = 1.0
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 512
        self.minibatch_size = 128
        self.num_epochs = 4
        self.grad_clip: float | None = 0.5
        self.model: dict = {"hidden": (64, 64)}
        # learner
        self.num_learners = 0
        self.device = "cuda"  # where the modules and the learner live
        self.mesh = None  # a 1-D DeviceMesh ("data",): the learner's batch sharding
        # action space (filled by _infer_spaces; Box envs set continuous)
        self.continuous = False
        self.action_low: Any = None
        self.action_high: Any = None
        # connectors v2 (reference: AlgorithmConfig.env_to_module_connector
        # / learner_connector — rllib/connectors/)
        self.env_to_module_connector = None
        self.learner_connector = None
        # multi-agent (reference: AlgorithmConfig.multi_agent,
        # rllib/algorithms/algorithm_config.py)
        self.policies: dict | None = None
        self.policy_mapping_fn = None
        self.policies_to_train: list | None = None
        # evaluation (reference: AlgorithmConfig.evaluation —
        # evaluation_interval in train iterations, duration in episodes)
        self.evaluation_interval: int | None = None
        self.evaluation_duration = 10
        # misc
        self.seed = 0

    # --- fluent sections ---

    def evaluation(self, *, evaluation_interval: int | None = None,
                   evaluation_duration: int | None = None,
                   ) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def environment(self, env: Any = None, *, observation_dim: int | None = None,
                    action_dim: int | None = None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if observation_dim is not None:
            self.observation_dim = observation_dim
        if action_dim is not None:
            self.action_dim = action_dim
        return self

    def env_runners(self, *, num_env_runners: int | None = None,
                    num_envs_per_env_runner: int | None = None,
                    rollout_fragment_length: int | None = None,
                    num_cpus_per_env_runner: float | None = None,
                    env_to_module_connector=None) -> "AlgorithmConfig":
        if env_to_module_connector is not None:
            self.env_to_module_connector = env_to_module_connector
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_cpus_per_env_runner is not None:
            self.num_cpus_per_env_runner = num_cpus_per_env_runner
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners: int | None = None, mesh=None,
                 device: str | None = None) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if mesh is not None:
            self.mesh = mesh
        if device is not None:
            self.device = device
        return self

    def multi_agent(self, *, policies: dict | list | None = None,
                    policy_mapping_fn=None,
                    policies_to_train: list | None = None) -> "AlgorithmConfig":
        """Configure multi-agent training (reference:
        algorithm_config.py multi_agent()). ``policies`` maps module id ->
        RLModuleSpec | dict(observation_dim=, action_dim=) | None
        (None: dims inferred from the env's agents routed to that module);
        a plain list of ids is shorthand for all-None specs."""
        if policies is not None:
            if isinstance(policies, (list, tuple, set)):
                policies = {mid: None for mid in policies}
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = list(policies_to_train)
        # The default mapping fn is filled in by _resolve_multi_agent_specs.
        return self

    @property
    def is_multi_agent(self) -> bool:
        return self.policies is not None

    def debugging(self, *, seed: int | None = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # --- resolution ---

    def _infer_spaces(self) -> None:
        if self.is_multi_agent:
            self._resolve_multi_agent_specs()
            return
        if self.observation_dim is not None and self.action_dim is not None:
            return
        if self.env is None:
            raise ValueError(
                "no env configured: pass environment(env=...) or explicit "
                "observation_dim/action_dim (offline algorithms)"
            )
        from ray_tpu_torch.rllib.env.env_runner import _make_env_fn

        env = _make_env_fn(self.env)()
        try:
            self.observation_dim = int(np.prod(env.observation_space.shape))
            space = env.action_space
            if hasattr(space, "n"):  # Discrete
                self.action_dim = int(space.n)
                self.continuous = False
            else:  # Box
                self.action_dim = int(np.prod(space.shape))
                self.continuous = True
                self.action_low = np.asarray(space.low, np.float32)
                self.action_high = np.asarray(space.high, np.float32)
        finally:
            try:
                env.close()
            except Exception:
                pass

    def _resolve_multi_agent_specs(self) -> None:
        """Turn every policies[mid] entry into a concrete RLModuleSpec on
        this config's device, inferring dims from the env's agents where
        unspecified."""
        if self.policy_mapping_fn is None:
            self.policy_mapping_fn = shared_policy_mapping_fn
        needs_env = any(not isinstance(s, RLModuleSpec)
                        and not (isinstance(s, dict) and "observation_dim" in s)
                        for s in self.policies.values())
        agent_dims: dict = {}
        if needs_env:
            if not callable(self.env):
                raise ValueError("multi-agent spec inference needs environment(env=callable)")
            env = self.env()
            try:
                for a in env.possible_agents:
                    agent_dims[a] = (env.observation_dims[a], env.action_dims[a])
            finally:
                try:
                    env.close()
                except Exception:
                    pass
        hidden = tuple(self.model.get("hidden", (64, 64)))
        resolved: dict[str, RLModuleSpec] = {}
        for mid, s in self.policies.items():
            if isinstance(s, RLModuleSpec):
                resolved[mid] = s
            elif isinstance(s, dict):
                resolved[mid] = RLModuleSpec(
                    observation_dim=s["observation_dim"], action_dim=s["action_dim"],
                    hidden=tuple(s.get("hidden", hidden)),
                    module_class=s.get("module_class"), device=self.device)
            else:  # None: the first env agent mapping to this module defines dims
                dims = next(((od, ad) for a, (od, ad) in agent_dims.items()
                             if self.policy_mapping_fn(a, 0) == mid), None)
                if dims is None:
                    raise ValueError(f"cannot infer spaces for module {mid!r}: no env "
                                     f"agent maps to it; pass an explicit spec")
                resolved[mid] = RLModuleSpec(observation_dim=dims[0], action_dim=dims[1],
                                             hidden=hidden, device=self.device)
        self.policies = resolved

    def rl_module_specs(self) -> "dict[str, RLModuleSpec]":
        """Per-module specs (multi-agent); single-agent configs expose their
        one spec under the default module id."""
        if self.is_multi_agent:
            if any(not isinstance(s, RLModuleSpec) for s in self.policies.values()):
                self._resolve_multi_agent_specs()
            return dict(self.policies)
        return {DEFAULT_MODULE_ID: self.rl_module_spec()}

    def rl_module_spec(self) -> RLModuleSpec:
        return RLModuleSpec(
            observation_dim=self.observation_dim,
            action_dim=self.action_dim,
            hidden=tuple(self.model.get("hidden", (64, 64))),
            module_class=getattr(self, "module_class", None),
            device=self.device,
        )

    def copy(self) -> "AlgorithmConfig":
        mesh, self.mesh = self.mesh, None  # a DeviceMesh holds process groups
        try:
            c = copy.deepcopy(self)
        finally:
            self.mesh = mesh
        c.mesh = mesh
        return c

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig()/IMPALAConfig()")
        self._infer_spaces()
        return self.algo_class(config=self.copy())


class Algorithm(Trainable):
    """Reference: rllib/algorithms/algorithm.py:199. A Tune Trainable whose
    step() is `training_step()` plus metric aggregation."""

    config_class: Type[AlgorithmConfig] = AlgorithmConfig
    supports_multi_agent: bool = False
    supports_learner_connector: bool = False

    def __init__(self, config: AlgorithmConfig | dict | None = None, trial_dir: str | None = None):
        if isinstance(config, dict):
            # Invoked by Tune with a plain dict: overlay onto the default
            # config (keys are AlgorithmConfig attribute names).
            base = self.config_class()
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        elif config is None:
            config = self.config_class()
        if config.is_multi_agent and not self.supports_multi_agent:
            raise ValueError(
                f"{type(self).__name__} does not support multi-agent "
                f"training; use PPO or drop .multi_agent() from the config"
            )
        if (config.learner_connector is not None
                and not self.supports_learner_connector):
            raise ValueError(
                f"{type(self).__name__} does not apply learner connectors; "
                f"currently supported by PPO. Preprocess the data in your "
                f"env or module instead."
            )
        config._infer_spaces()
        self.algo_config = config
        super().__init__(config={}, trial_dir=trial_dir)

    def setup(self, config: dict) -> None:
        cfg = self.algo_config
        # Offline algorithms (BC/CQL-style) may have no env at all.
        if cfg.env is None:
            self.env_runner_group = None
        elif cfg.is_multi_agent:
            self.env_runner_group = MultiAgentEnvRunnerGroup(cfg)
        else:
            self.env_runner_group = EnvRunnerGroup(cfg)
        self._rng = np.random.default_rng(cfg.seed)
        self.build_learner(cfg)  # algorithm-specific

    def build_learner(self, cfg: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    def step(self) -> dict:
        result = self.training_step()
        if self.env_runner_group is not None:
            result.update(self.env_runner_group.get_metrics())
            if hasattr(self.env_runner_group, "sync_connector_states"):
                # Keep running-normalizer stats consistent across remote
                # runners (reference: MeanStdFilter periodic sync).
                self.env_runner_group.sync_connector_states()
        interval = self.algo_config.evaluation_interval
        if interval and (self.iteration + 1) % interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self, duration: int | None = None) -> dict:
        """Greedy-policy evaluation for ``duration`` episodes (reference:
        Algorithm.evaluate / config.evaluation). Uses the current
        learner weights and the training runners' frozen connector
        statistics (observation normalizers are applied, not updated)."""
        from ray_tpu_torch.rllib.connectors import build_pipeline
        from ray_tpu_torch.rllib.env.env_runner import _make_env_fn

        cfg = self.algo_config
        if cfg.env is None:
            raise ValueError("evaluate() requires an environment")
        if cfg.is_multi_agent:
            raise NotImplementedError("evaluate() supports single-agent configs")
        n_episodes = int(duration or cfg.evaluation_duration)
        env = _make_env_fn(cfg.env)()
        module = self.get_module()
        pipe = build_pipeline(getattr(cfg, "env_to_module_connector", None))
        group = getattr(self, "env_runner_group", None)
        if (pipe is not None and group is not None
                and hasattr(group, "get_connector_state")):
            state = group.get_connector_state()
            if state is not None:
                pipe.set_state(state)
        returns: list[float] = []
        lengths: list[int] = []
        try:
            for ep in range(n_episodes):
                obs = env.reset(seed=cfg.seed + 10_000 + ep)[0]
                total, steps, done = 0.0, 0, False
                while not done and steps < 100_000:
                    o = np.asarray(obs, np.float32)[None, :]
                    if pipe is not None:
                        o = np.asarray(pipe(o, update=False))
                    logits = module.forward_inference(o)["action_dist_inputs"][0]
                    if cfg.continuous:
                        # Mean action: first half of the dist inputs.
                        act = np.asarray(logits[: len(logits) // 2])
                    else:
                        act = int(np.argmax(logits))
                    obs, r, term, trunc, _ = env.step(act)
                    total += float(r)
                    steps += 1
                    done = bool(term or trunc)
                returns.append(total)
                lengths.append(steps)
        finally:
            try:
                env.close()
            except Exception:
                pass
        return {
            "env_runners": {
                "episode_return_mean": float(np.mean(returns)),
                "episode_return_max": float(np.max(returns)),
                "episode_return_min": float(np.min(returns)),
                "episode_len_mean": float(np.mean(lengths)),
                "episodes_this_iter": n_episodes,
            }
        }

    def train(self) -> dict:  # Trainable.train adds iteration bookkeeping
        return super().train()

    # --- checkpointing (reference: Checkpointable mixin utils/checkpoints.py) ---

    def get_extra_state(self) -> dict:
        """Algorithm-held state beyond the learner (target networks,
        moving statistics, rng keys). Subclasses override both hooks so
        checkpoints capture their full training state."""
        return {}

    def set_extra_state(self, state: dict) -> None:
        pass

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = self.learner_group.get_state()
        payload = {
            "learner": state,
            "iteration": self.iteration,
            "extra": self.get_extra_state(),
        }
        group = getattr(self, "env_runner_group", None)
        if group is not None and hasattr(group, "get_connector_state"):
            # Env-to-module connector stats (running normalizers) are part
            # of the trained artifact: the policy expects inputs scaled by
            # the converged statistics.
            payload["connector_state"] = group.get_connector_state()
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "wb") as f:
            pickle.dump(payload, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self.iteration = state["iteration"]
        if state.get("extra"):
            self.set_extra_state(state["extra"])
        group = getattr(self, "env_runner_group", None)
        if (state.get("connector_state") is not None and group is not None
                and hasattr(group, "set_connector_state")):
            group.set_connector_state(state["connector_state"])

    def get_weights(self):
        return self.learner_group.get_weights()

    def get_module(self, module_id: str | None = None):
        """A LOCAL RLModule carrying the current trained weights
        (reference: Algorithm.get_module). Built lazily from this
        algorithm's module spec; refreshed with the learner weights on
        every call so it tracks training."""
        module_id = module_id or DEFAULT_MODULE_ID
        cache = getattr(self, "_inference_modules", None)
        if cache is None:
            cache = self._inference_modules = {}
        module = cache.get(module_id)
        if module is None:
            module = cache[module_id] = (
                self.algo_config.rl_module_specs()[module_id].build())
        weights = self.learner_group.get_weights()
        # Multi-module weight dicts key by module id.
        if isinstance(weights, dict) and module_id in weights:
            weights = weights[module_id]
        module.set_weights(weights)
        return module

    def compute_single_action(self, observation, *, explore: bool = False,
                              module_id: str | None = None) -> int:
        """Action for ONE observation from the current policy (reference:
        Algorithm.compute_single_action, algorithms/algorithm.py:3770).
        ``explore=False`` is the greedy/deterministic action;
        ``explore=True`` samples the action distribution."""
        module = self.get_module(module_id)
        obs = np.asarray(observation, dtype=np.float32)[None, :]
        out = module.forward_inference(obs)
        logits = out["action_dist_inputs"][0]
        if not explore:
            return int(np.argmax(logits))
        z = logits - logits.max()
        p = np.exp(z) / np.exp(z).sum()
        return int(self._rng.choice(len(p), p=p))

    def cleanup(self) -> None:
        if getattr(self, "env_runner_group", None) is not None:
            self.env_runner_group.stop()
        if hasattr(self, "learner_group"):
            self.learner_group.stop()

    stop = cleanup
