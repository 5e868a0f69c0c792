"""SAC: soft actor-critic for continuous control (port of
ray_tpu/rllib/algorithms/sac.py).

Counterpart of the reference's SAC (rllib/algorithms/sac/ — squashed
gaussian policy, twin Q critics, entropy temperature auto-tuning, polyak
target nets, replay). The actor, critic and temperature losses are summed
into one update with ``.detach()`` walls between them (critic gradients
do not flow into the policy term and vice versa); the target critic is
an algorithm-held tree, polyak-updated after each gradient step.

ray_tpu draws the reparameterisation noise from jax.random keys inside
its jitted functions. Here one ``torch.Generator`` (seeded by the
config's seed) draws it on the host in ``SAC._draw_noise``, which hands
it to the TD targets and, as batch columns, to the loss: so the loss and
the targets are pure functions of their inputs, and a test can feed them
JAX's draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, TorchLearner, batch_mean,
                                               make_optimizer)
from ray_tpu_torch.ops.tree import tree_map
from ray_tpu_torch.rllib.core.rl_module import RLModule, _mlp_apply, _mlp_init, to_tensor
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import ACTIONS, NEXT_OBS, OBS, REWARDS, TERMINATEDS

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
LOG_2PI = math.log(2.0 * math.pi)
LOG_2 = math.log(2.0)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=SAC)
        self.lr = 3e-4
        self.replay_buffer_capacity = 100_000
        self.learning_starts = 500
        self.num_gradient_steps = 32
        self.train_batch_size = 64
        self.tau = 0.005  # polyak for the target critic
        self.initial_alpha = 1.0
        self.target_entropy: float | None = None  # default: -action_dim
        self.grad_clip = None

    def rl_module_spec(self):
        spec = super().rl_module_spec()
        if spec.module_class is None:
            center, half = _action_affine(self.action_low, self.action_high)
            spec.module_class = _sac_module_factory(self.initial_alpha, center, half)
        return spec


def gaussian_sample(apply_out, noise):
    """Reparameterized squashed-gaussian sample a = tanh(mean + std·noise)
    with the tanh-corrected log-prob; ``noise`` is standard normal of
    the mean's shape."""
    mean, log_std = apply_out["mean"], apply_out["log_std"]
    std = torch.exp(log_std)
    u = mean + std * noise
    logp_u = (-0.5 * torch.square((u - mean) / std) - log_std - 0.5 * LOG_2PI).sum(-1)
    a = torch.tanh(u)
    # d tanh correction (numerically-stable formulation).
    logp = logp_u - (2.0 * (LOG_2 - u - F.softplus(-2.0 * u))).sum(-1)
    return a, logp


def _action_affine(low, high):
    """Map tanh output [-1, 1] onto [low, high]: a = center + half·tanh(u).
    Handles asymmetric Box spaces (low != -high)."""
    if high is None:
        return 0.0, 1.0
    low = np.asarray(low, np.float32)
    high = np.asarray(high, np.float32)
    return (high + low) / 2.0, (high - low) / 2.0


def detached(tree):
    """The tree's tensors cut from autograd (jax.lax.stop_gradient)."""
    return tree_map(lambda t: t.detach(), tree)


class SACModule(RLModule):
    """Policy (mean/log_std heads) + twin Q critics + log_alpha, one tree."""

    action_center: np.ndarray | float = 0.0
    action_half: np.ndarray | float = 1.0
    initial_alpha: float = 1.0

    def init_params(self, gen):
        s = self.spec
        qin = s.observation_dim + s.action_dim
        return {
            "pi": {
                "torso": _mlp_init(gen, [s.observation_dim, *s.hidden]),
                "mean": _mlp_init(gen, [s.hidden[-1], s.action_dim]),
                "log_std": _mlp_init(gen, [s.hidden[-1], s.action_dim]),
            },
            "q1": _mlp_init(gen, [qin, *s.hidden, 1]),
            "q2": _mlp_init(gen, [qin, *s.hidden, 1]),
            "log_alpha": torch.tensor(np.log(self.initial_alpha), dtype=torch.float32),
        }

    def apply(self, params, obs) -> dict:
        h = _mlp_apply(params["pi"]["torso"], obs, activate_last=True)
        mean = _mlp_apply(params["pi"]["mean"], h)
        log_std = torch.clamp(_mlp_apply(params["pi"]["log_std"], h), LOG_STD_MIN, LOG_STD_MAX)
        return {"mean": mean, "log_std": log_std,
                "action_dist_inputs": mean, "vf_preds": mean[..., 0] * 0.0}

    @staticmethod
    def q_apply(q_params, obs, actions):
        x = torch.cat([obs, actions], dim=-1)
        return _mlp_apply(q_params, x)[..., 0]

    def explore_actions(self, obs, rng: np.random.Generator):
        out = self.forward_inference(obs)
        mean, log_std = out["mean"], out["log_std"]
        u = mean + np.exp(log_std) * rng.standard_normal(mean.shape).astype(np.float32)
        a = self.action_center + self.action_half * np.tanh(u)
        return a.astype(np.float32), {}


def _affine_tensors(center, half, like: torch.Tensor):
    return (torch.as_tensor(center, dtype=torch.float32, device=like.device),
            torch.as_tensor(half, dtype=torch.float32, device=like.device))


def make_sac_loss(cfg: SACConfig, action_center, action_half, target_entropy: float):
    """The summed loss; the batch carries ``td_targets`` and ``noise_pi``
    (standard normal [B, action_dim], the actor's reparameterisation)."""

    def loss_fn(params, apply_fn, batch):
        obs, acts = batch[OBS], batch[ACTIONS]
        center, half = _affine_tensors(action_center, action_half, obs)
        # Buffer actions are env-scaled; critics see normalized [-1, 1].
        acts_n = (acts - center) / half
        alpha = torch.exp(params["log_alpha"])

        # -- critic loss (targets precomputed outside; see DQN) ----------
        q1 = SACModule.q_apply(params["q1"], obs, acts_n)
        q2 = SACModule.q_apply(params["q2"], obs, acts_n)
        target = batch["td_targets"]
        critic_loss = (batch_mean(torch.square(q1 - target))
                       + batch_mean(torch.square(q2 - target)))

        # -- actor loss: fresh reparam sample through frozen critics ------
        out = apply_fn(params, obs)
        a_pi, logp_pi = gaussian_sample(out, batch["noise_pi"])
        q1_pi = SACModule.q_apply(detached(params["q1"]), obs, a_pi)
        q2_pi = SACModule.q_apply(detached(params["q2"]), obs, a_pi)
        q_pi = torch.minimum(q1_pi, q2_pi)
        actor_loss = batch_mean(alpha.detach() * logp_pi - q_pi)

        # -- temperature loss --------------------------------------------
        alpha_loss = batch_mean(-params["log_alpha"] * (logp_pi + target_entropy).detach())

        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss,
                       "alpha_loss": alpha_loss, "alpha": alpha,
                       "entropy": -batch_mean(logp_pi), "q1_mean": batch_mean(q1)}

    return loss_fn


def make_soft_td_targets(apply_fn, gamma: float):
    """r + gamma (1 - terminated) (min Q_target(s', a') - alpha log pi(a'|s')),
    a' drawn with ``noise``."""

    @torch.no_grad()
    def td_targets(params, target_q, noise, next_obs, rewards, terminateds):
        out = apply_fn(params, next_obs)
        a2, logp2 = gaussian_sample(out, noise)
        q1t = SACModule.q_apply(target_q["q1"], next_obs, a2)
        q2t = SACModule.q_apply(target_q["q2"], next_obs, a2)
        alpha = torch.exp(params["log_alpha"])
        soft_q = torch.minimum(q1t, q2t) - alpha * logp2
        return rewards + gamma * (1.0 - terminateds) * soft_q

    return td_targets


class SAC(Algorithm):
    config_class = SACConfig

    def make_loss(self, cfg, center, half, target_entropy):
        """Loss factory hook; CQL overrides it with the conservative one."""
        return make_sac_loss(cfg, center, half, target_entropy)

    def get_extra_state(self) -> dict:
        return {"target_q": tree_map(lambda t: t.cpu().numpy(), self.target_q),
                "env_steps_total": self._env_steps_total,
                "generator": self._gen.get_state().numpy()}

    def set_extra_state(self, state: dict) -> None:
        self.target_q = tree_map(lambda a: to_tensor(a, self._device).clone(), state["target_q"])
        self._env_steps_total = state["env_steps_total"]
        self._gen.set_state(torch.from_numpy(np.asarray(state["generator"])))

    def _build_sac_learner(self, cfg: SACConfig) -> None:
        """The learner, target critics, noise generator and TD targets
        that SAC and CQL share."""
        if cfg.num_learners > 0:
            raise ValueError(
                f"{type(self).__name__} drives its learner locally (replay + "
                f"target nets live with the driver); num_learners > 0 is not "
                f"supported")
        spec = cfg.rl_module_spec()
        target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                          else -float(cfg.action_dim))
        center, half = _action_affine(cfg.action_low, cfg.action_high)
        tx = make_optimizer(cfg)
        loss_fn = self.make_loss(cfg, center, half, target_entropy)
        seed = cfg.seed

        def factory():
            return TorchLearner(spec.build(seed=seed), loss_fn=loss_fn, optimizer=tx,
                                mesh=cfg.mesh)

        self.learner_group = LearnerGroup(factory, num_learners=0)
        self._device = self.learner_group.local.device
        params = self.learner_group.local.module.params
        self.target_q = tree_map(lambda t: t.detach().clone(),
                                 {"q1": params["q1"], "q2": params["q2"]})
        self._gen = torch.Generator().manual_seed(cfg.seed)
        self._td_targets = make_soft_td_targets(self.learner_group.local.module.apply, cfg.gamma)

    def build_learner(self, cfg: SACConfig) -> None:
        self._build_sac_learner(cfg)
        self.buffer = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._env_steps_total = 0

    def _draw_noise(self, batch_size: int):
        """One gradient step's reparameterisation noise: the TD targets'
        [B, action_dim] and the loss's batch columns."""
        shape = (batch_size, self.algo_config.action_dim)
        td = torch.randn(shape, generator=self._gen)
        return td.numpy(), {"noise_pi": torch.randn(shape, generator=self._gen).numpy()}

    def _gradient_step(self, mb, metrics: dict) -> None:
        """TD targets, one learner update and the polyak target update."""
        cfg, dev = self.algo_config, self._device
        params = self.learner_group.local.module.params
        td_noise, loss_noise = self._draw_noise(len(mb))
        mb["td_targets"] = self._td_targets(
            params, self.target_q, to_tensor(td_noise, dev), to_tensor(mb[NEXT_OBS], dev),
            to_tensor(mb[REWARDS], dev),
            to_tensor(np.asarray(mb[TERMINATEDS], np.float32), dev)).cpu().numpy()
        mb.update(loss_noise)
        metrics.update(self.learner_group.local.update(mb))
        # Polyak target update every gradient step (reference default).
        w = self.learner_group.local.module.params
        self.target_q = tree_map(lambda t, o: (1 - cfg.tau) * t + cfg.tau * o.detach(),
                                 self.target_q, {"q1": w["q1"], "q2": w["q2"]})

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
        for _ in range(cfg.num_gradient_steps):
            self._gradient_step(self.buffer.sample(cfg.train_batch_size), metrics)
        return metrics


def _sac_module_factory(initial_alpha: float, action_center, action_half):
    class _SAC(SACModule):
        pass

    _SAC.initial_alpha = initial_alpha
    _SAC.action_center = action_center
    _SAC.action_half = action_half
    return _SAC
