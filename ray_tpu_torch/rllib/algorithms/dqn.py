"""DQN: double Q-learning with a target network and replay (port of
ray_tpu/rllib/algorithms/dqn.py).

Counterpart of the reference's DQN (rllib/algorithms/dqn/dqn.py — new API
stack: EnvRunner sampling -> EpisodeReplayBuffer -> learner with
double-Q + target net). TD targets are computed outside the learner from
(online, target) parameters, so the learner stays a plain (params,
batch) -> grads update, and the target net is an algorithm-held tree
(hard-synced every ``target_network_update_freq`` env steps).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, TorchLearner, batch_mean,
                                               make_optimizer)
from ray_tpu_torch.ops.tree import tree_map
from ray_tpu_torch.rllib.core.rl_module import RLModule, _mlp_apply, _mlp_init, to_tensor
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import ACTIONS, NEXT_OBS, OBS, REWARDS, TERMINATEDS


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DQN)
        self.lr = 5e-4
        self.replay_buffer_capacity = 50_000
        self.learning_starts = 1000  # env steps before updates begin
        self.target_network_update_freq = 500  # env steps between hard syncs
        self.num_gradient_steps = 32  # per training_step
        self.double_q = True
        self.n_step = 1
        self.epsilon = (1.0, 0.05)  # (initial, final)
        self.epsilon_timesteps = 10_000
        self.train_batch_size = 32  # replay minibatch rows
        self.tau = 1.0  # 1.0 = hard update

    def rl_module_spec(self):
        # Env runners and the learner both build from this spec, so the
        # Q-module (with its epsilon-greedy exploration) rides the config.
        spec = super().rl_module_spec()
        if spec.module_class is None:
            spec.module_class = _qmodule_factory(self)
        return spec


class QModule(RLModule):
    """MLP Q-network with built-in epsilon-greedy exploration, drawn from
    the runner's numpy generator as in ray_tpu.

    The epsilon schedule advances on a local step counter per runner —
    exploration state never needs to ride the weight broadcast."""

    def __init__(self, spec, seed: int = 0, *, epsilon=(1.0, 0.05),
                 epsilon_timesteps=10_000, num_envs: int = 1):
        self._eps0, self._eps1 = epsilon
        self._eps_steps = max(1, epsilon_timesteps)
        self._env_steps = 0
        self._num_envs = num_envs
        super().__init__(spec, seed)

    def init_params(self, gen):
        s = self.spec
        return {"q": _mlp_init(gen, [s.observation_dim, *s.hidden, s.action_dim])}

    def apply(self, params, obs) -> dict:
        q = _mlp_apply(params["q"], obs)
        return {"q_values": q, "action_dist_inputs": q, "vf_preds": q.max(-1).values}

    def explore_actions(self, obs, rng: np.random.Generator):
        frac = min(1.0, self._env_steps / self._eps_steps)
        eps = self._eps0 + frac * (self._eps1 - self._eps0)
        self._env_steps += len(obs)
        q = self.forward_inference(obs)["q_values"]
        greedy = q.argmax(-1)
        random = rng.integers(0, q.shape[-1], size=len(obs))
        take_random = rng.random(len(obs)) < eps
        return np.where(take_random, random, greedy).astype(np.int64), {}


def huber_loss(errors: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """optax.huber_loss, in its order of operations."""
    abs_errors = errors.abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_errors - quadratic)


def make_dqn_loss():
    def loss_fn(params, apply_fn, batch):
        q = apply_fn(params, batch[OBS])["q_values"]
        qa = q.gather(-1, batch[ACTIONS][:, None].long())[:, 0]
        td = qa - batch["td_targets"]
        loss = batch_mean(huber_loss(td))
        return loss, {"qf_loss": loss, "qf_mean": batch_mean(qa),
                      "td_error_abs": batch_mean(td.abs())}

    return loss_fn


def make_td_targets(apply_fn, gamma: float, double_q: bool):
    """r + gamma (1 - terminated) Q_target(s', a*), a* the online net's
    argmax with double Q, else the target's max."""

    @torch.no_grad()
    def td_targets(online, target, next_obs, rewards, terminateds):
        qt = apply_fn(target, next_obs)["q_values"]
        if double_q:
            a_star = apply_fn(online, next_obs)["q_values"].argmax(-1)
            q_next = qt.gather(-1, a_star[:, None])[:, 0]
        else:
            q_next = qt.max(-1).values
        return rewards + gamma * (1.0 - terminateds) * q_next

    return td_targets


class DQN(Algorithm):
    config_class = DQNConfig

    def get_extra_state(self) -> dict:
        return {"target_weights": tree_map(lambda t: t.cpu().numpy(), self.target_weights),
                "env_steps_total": self._env_steps_total,
                "last_target_sync": self._last_target_sync}

    def set_extra_state(self, state: dict) -> None:
        self.target_weights = self._on_device(state["target_weights"])
        self._env_steps_total = state["env_steps_total"]
        self._last_target_sync = state["last_target_sync"]

    def _on_device(self, weights):
        return tree_map(lambda a: to_tensor(a, self._device).clone(), weights)

    def build_learner(self, cfg: DQNConfig) -> None:
        spec = cfg.rl_module_spec()
        if cfg.num_learners > 0:
            raise ValueError(
                "DQN drives its learner locally (replay + target net live "
                "with the driver); num_learners > 0 is not supported"
            )
        tx = make_optimizer(cfg)
        seed = cfg.seed

        def factory():
            return TorchLearner(spec.build(seed=seed), loss_fn=make_dqn_loss(), optimizer=tx,
                                mesh=cfg.mesh)

        self.learner_group = LearnerGroup(factory, num_learners=0)
        self._device = self.learner_group.local.device
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self.target_weights = self._on_device(self.learner_group.get_weights())
        self._env_steps_total = 0
        self._last_target_sync = 0
        self._td_targets = make_td_targets(self.learner_group.local.module.apply,
                                           cfg.gamma, cfg.double_q)

    def training_step(self) -> dict:
        cfg = self.algo_config
        weights = self.learner_group.get_weights()
        batch = self.env_runner_group.sample(weights)
        self.buffer.add(batch)
        self._env_steps_total += len(batch)
        metrics: dict = {"num_env_steps_sampled": self._env_steps_total,
                         "replay_buffer_size": len(self.buffer)}
        if self._env_steps_total < cfg.learning_starts:
            return metrics
        dev = self._device
        for _ in range(cfg.num_gradient_steps):
            mb = self.buffer.sample(cfg.train_batch_size)
            # The online params as they are now: double-Q action selection
            # must track the learner, not a snapshot from before the loop.
            online = self.learner_group.local.module.params
            mb["td_targets"] = self._td_targets(
                online, self.target_weights, to_tensor(mb[NEXT_OBS], dev),
                to_tensor(mb[REWARDS], dev),
                to_tensor(mb[TERMINATEDS].astype(np.float32), dev)).cpu().numpy()
            metrics.update(self.learner_group.local.update(mb))
        if (self._env_steps_total - self._last_target_sync
                >= cfg.target_network_update_freq):
            w = self.learner_group.local.module.params
            if cfg.tau >= 1.0:
                self.target_weights = tree_map(lambda o: o.detach().clone(), w)
            else:
                self.target_weights = tree_map(
                    lambda t, o: (1 - cfg.tau) * t + cfg.tau * o.detach(), self.target_weights, w)
            self._last_target_sync = self._env_steps_total
        return metrics


def _qmodule_factory(cfg: DQNConfig):
    eps, eps_t = cfg.epsilon, cfg.epsilon_timesteps
    num_envs = cfg.num_envs_per_env_runner

    class _Q(QModule):
        def __init__(self, spec, seed: int = 0):
            super().__init__(spec, seed, epsilon=eps, epsilon_timesteps=eps_t,
                             num_envs=num_envs)

    return _Q
