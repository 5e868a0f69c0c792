"""APPO: asynchronous PPO, IMPALA's architecture with a clipped surrogate
(port of ray_tpu/rllib/algorithms/appo.py).

Counterpart of the reference's APPO (rllib/algorithms/appo/appo.py — an
IMPALA subclass whose loss applies the PPO clip to v-trace-corrected
advantages). The pipeline is IMPALA's; only the loss changes.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig, vtrace_terms
from ray_tpu_torch.rllib.core.learner import batch_mean
from ray_tpu_torch.rllib.core.rl_module import categorical_entropy


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.clip_param = 0.2  # PPO surrogate clip on the IS ratio


def make_appo_loss(cfg: APPOConfig, T: int):
    clip = cfg.clip_param

    def loss_fn(params, apply_fn, batch):
        logits, values, target_logp, behavior_logp, vs, pg_adv = vtrace_terms(
            params, apply_fn, batch, T, cfg)
        # PPO clip on the importance ratio (the APPO twist on IMPALA).
        ratio = torch.exp(target_logp - behavior_logp)
        surrogate = torch.minimum(ratio * pg_adv, torch.clamp(ratio, 1 - clip, 1 + clip) * pg_adv)
        policy_loss = -batch_mean(surrogate)
        vf_loss = 0.5 * batch_mean(torch.square(values - vs))
        entropy = batch_mean(categorical_entropy(logits))
        total = policy_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy,
                       "mean_ratio": batch_mean(ratio)}

    return loss_fn


class APPO(IMPALA):
    config_class = APPOConfig

    def make_loss(self, cfg):
        return make_appo_loss(cfg, cfg.rollout_fragment_length)
