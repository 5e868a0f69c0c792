"""CQL: conservative Q-learning, offline SAC (port of
ray_tpu/rllib/algorithms/cql.py).

Counterpart of the reference's CQL (rllib/algorithms/cql/cql.py — SAC with
the CQL(H) conservative regularizer trained from offline data). Built on
SAC's module, twin critics and target updates: the critic loss gains

    alpha_cql * ( logsumexp_a Q(s, a) - Q(s, a_data) )

where the logsumexp is importance-sampled with ``num_actions`` uniform
actions plus policy actions at s and s' (each weighted by its proposal
log-density). The actor warm-starts with behavior cloning for
``bc_iters`` updates before switching to the SAC actor loss. The noise
(uniform actions and three gaussian draws) comes from SAC's generator in
``CQL._draw_noise``, as batch columns.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithms.bc import _to_sample_batch
from ray_tpu_torch.rllib.algorithms.sac import (
    LOG_2,
    LOG_2PI,
    SAC,
    SACConfig,
    SACModule,
    _affine_tensors,
    detached,
    gaussian_sample,
)
from ray_tpu_torch.rllib.core.learner import batch_mean
from ray_tpu_torch.rllib.sample_batch import ACTIONS, NEXT_OBS, OBS, REWARDS, TERMINATEDS, SampleBatch


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = CQL
        self.offline_data = None
        self.bc_iters = 200           # actor BC warm-up updates
        self.cql_alpha = 5.0          # min_q_weight in the reference
        self.num_actions = 4          # sampled actions per logsumexp term
        self.num_gradient_steps = 16
        self.learning_starts = 0

    def offline(self, offline_data) -> "CQLConfig":
        self.offline_data = offline_data
        return self


def _squashed_gaussian_logp(out, actions_n):
    """log pi(a|s) for given normalized actions under the squashed
    gaussian (inverse of gaussian_sample's tanh)."""
    mean, log_std = out["mean"], out["log_std"]
    a = torch.clamp(actions_n, -1.0 + 1e-6, 1.0 - 1e-6)
    u = torch.atanh(a)
    std = torch.exp(log_std)
    logp_u = (-0.5 * torch.square((u - mean) / std) - log_std - 0.5 * LOG_2PI).sum(-1)
    return logp_u - (2.0 * (LOG_2 - u - F.softplus(-2.0 * u))).sum(-1)


def make_cql_loss(cfg: CQLConfig, action_center, action_half, target_entropy: float):
    """The summed loss; the batch carries ``td_targets``, ``use_bc`` (0 or
    1) and the noise columns: ``noise_pi`` [B, d] standard normal,
    ``rand_actions`` [B·n, d] uniform on [-1, 1], ``noise_cur`` and
    ``noise_nxt`` [B·n, d] standard normal."""
    n_act = cfg.num_actions
    cql_alpha = cfg.cql_alpha

    def loss_fn(params, apply_fn, batch):
        obs, acts, nxt = batch[OBS], batch[ACTIONS], batch[NEXT_OBS]
        center, half = _affine_tensors(action_center, action_half, obs)
        acts_n = (acts - center) / half
        alpha = torch.exp(params["log_alpha"])
        B, d = acts_n.shape

        # -- standard SAC critic TD loss ---------------------------------
        q1 = SACModule.q_apply(params["q1"], obs, acts_n)
        q2 = SACModule.q_apply(params["q2"], obs, acts_n)
        target = batch["td_targets"]
        td_loss = batch_mean(torch.square(q1 - target)) + batch_mean(torch.square(q2 - target))

        # -- CQL(H) conservative penalty ---------------------------------
        # Importance-sampled logsumexp over: uniform actions (density
        # 2^-d on [-1,1]^d), policy actions at s, policy actions at s'.
        def tiled(o):
            return torch.repeat_interleave(o, n_act, dim=0)  # [B*n, ...]

        rand_a = batch["rand_actions"]
        out_cur = apply_fn(params, obs)
        out_nxt = apply_fn(params, nxt)
        cur_a, cur_logp = gaussian_sample(
            {"mean": tiled(out_cur["mean"]), "log_std": tiled(out_cur["log_std"])},
            batch["noise_cur"])
        nxt_a, nxt_logp = gaussian_sample(
            {"mean": tiled(out_nxt["mean"]), "log_std": tiled(out_nxt["log_std"])},
            batch["noise_nxt"])
        rand_logp = torch.full((B * n_act,), -d * LOG_2, device=obs.device)

        def penalty(qkey):
            qs = []
            for a_s, lp in ((rand_a, rand_logp), (cur_a, cur_logp.detach()),
                            (nxt_a, nxt_logp.detach())):
                q = SACModule.q_apply(params[qkey], tiled(obs), a_s)
                qs.append((q - lp).reshape(B, n_act))
            cat = torch.cat(qs, dim=1)  # [B, 3n]
            lse = torch.logsumexp(cat, dim=1) - math.log(3.0 * n_act)
            q_data = SACModule.q_apply(params[qkey], obs, acts_n)
            return batch_mean(lse - q_data)

        cql_pen = penalty("q1") + penalty("q2")
        critic_loss = td_loss + cql_alpha * cql_pen

        # -- actor: BC warm-up then SAC objective ------------------------
        a_pi, logp_pi = gaussian_sample(out_cur, batch["noise_pi"])
        q_pi = torch.minimum(SACModule.q_apply(detached(params["q1"]), obs, a_pi),
                             SACModule.q_apply(detached(params["q2"]), obs, a_pi))
        bc_logp = _squashed_gaussian_logp(out_cur, acts_n)
        sac_actor = batch_mean(alpha.detach() * logp_pi - q_pi)
        bc_actor = batch_mean(alpha.detach() * logp_pi - bc_logp)
        use_bc = batch["use_bc"]  # scalar 0/1 carried in the batch
        actor_loss = use_bc * bc_actor + (1.0 - use_bc) * sac_actor

        alpha_loss = batch_mean(-params["log_alpha"] * (logp_pi + target_entropy).detach())

        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "td_loss": td_loss,
                       "cql_penalty": cql_pen, "actor_loss": actor_loss,
                       "alpha": alpha, "q1_mean": batch_mean(q1)}

    return loss_fn


class CQL(SAC):
    config_class = CQLConfig

    def make_loss(self, cfg, center, half, target_entropy):
        return make_cql_loss(cfg, center, half, target_entropy)

    def get_extra_state(self) -> dict:
        state = super().get_extra_state()
        del state["env_steps_total"]
        return {**state, "updates": self._updates}

    def set_extra_state(self, state: dict) -> None:
        super().set_extra_state({**state, "env_steps_total": 0})
        self._updates = state["updates"]

    def build_learner(self, cfg: CQLConfig) -> None:
        if cfg.offline_data is None:
            raise ValueError("CQL requires config.offline(offline_data=...)")
        if cfg.num_learners > 0:
            raise ValueError(
                "CQL drives its learner locally (replay sampling + target "
                "nets live with the driver); num_learners > 0 is not "
                "supported"
            )
        self._dataset = _to_sample_batch(cfg.offline_data)
        for col in (OBS, ACTIONS, REWARDS, NEXT_OBS):
            if col not in self._dataset:
                raise ValueError(f"CQL offline data needs a {col!r} column")
        if TERMINATEDS not in self._dataset:
            self._dataset[TERMINATEDS] = np.zeros(len(self._dataset), bool)
        self._build_sac_learner(cfg)
        self._updates = 0
        self._rng = np.random.default_rng(cfg.seed)

    def _draw_noise(self, batch_size: int):
        cfg, g = self.algo_config, self._gen
        d, n = cfg.action_dim, cfg.num_actions
        td = torch.randn((batch_size, d), generator=g)
        loss = {"noise_pi": torch.randn((batch_size, d), generator=g),
                "rand_actions": torch.rand((batch_size * n, d), generator=g) * 2.0 - 1.0,
                "noise_cur": torch.randn((batch_size * n, d), generator=g),
                "noise_nxt": torch.randn((batch_size * n, d), generator=g)}
        return td.numpy(), {k: v.numpy() for k, v in loss.items()}

    def training_step(self) -> dict:
        cfg = self.algo_config
        metrics: dict = {"num_offline_rows": len(self._dataset)}
        n = len(self._dataset)
        for _ in range(cfg.num_gradient_steps):
            idx = self._rng.integers(0, n, size=cfg.train_batch_size)
            mb = SampleBatch({k: v[idx] for k, v in self._dataset.items()})
            mb["use_bc"] = np.float32(1.0 if self._updates < cfg.bc_iters else 0.0)
            self._gradient_step(mb, metrics)
            self._updates += 1
        metrics["num_gradient_updates"] = self._updates
        return metrics
