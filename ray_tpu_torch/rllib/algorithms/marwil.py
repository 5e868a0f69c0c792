"""MARWIL: monotonic advantage re-weighted imitation learning (port of
ray_tpu/rllib/algorithms/marwil.py).

Counterpart of the reference's MARWIL (rllib/algorithms/marwil/marwil.py —
offline RL; exponentially advantage-weighted behavior cloning with a
learned value baseline; beta=0 degenerates to BC). The loss
(marwil_torch_learner / marwil_learner possibly_masked_mean path) is one
pure function of (params, batch):

    L = -E[ exp(beta * A / c) * log pi(a|s) ] + vf_coeff * E[A^2]

with A = R_t - V(s_t) (Monte-Carlo return minus baseline) and c the
advantage RMS — the reference keeps c as a moving average
(``ma_adv_norm``, update_term in marwil_learner); here c is carried as an
explicit scalar in the batch and updated host-side each step, which keeps
the loss pure.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.bc import _to_sample_batch
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, TorchLearner, batch_mean,
                                               make_optimizer)
from ray_tpu_torch.rllib.core.rl_module import categorical_logp
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    OBS,
    REWARDS,
    TERMINATEDS,
    SampleBatch,
)

RETURNS = "mc_returns"


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=MARWIL)
        self.offline_data = None
        self.beta = 1.0  # 0 => plain behavior cloning
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-2
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_epochs = 1
        self.grad_clip = None

    def offline(self, offline_data) -> "MARWILConfig":
        self.offline_data = offline_data
        return self


def make_marwil_loss(cfg: MARWILConfig):
    beta, vf_coeff = cfg.beta, cfg.vf_coeff

    def loss_fn(params, apply_fn, batch):
        out = apply_fn(params, batch[OBS])
        logp = categorical_logp(out["action_dist_inputs"], batch[ACTIONS])
        vf = out["vf_preds"]
        adv = batch[RETURNS] - vf
        vf_loss = batch_mean(torch.square(adv))
        if beta != 0.0:
            c = torch.clamp(batch["ma_adv_norm"], min=1e-8)
            # exp-weight on a stop-grad advantage, clipped for stability
            # (reference clamps the exponent the same way).
            w = torch.exp(torch.clamp(beta * adv.detach() / c, -10.0, 10.0))
            policy_loss = -batch_mean(w * logp)
        else:
            policy_loss = -batch_mean(logp)
        total = policy_loss + vf_coeff * vf_loss
        acc = batch_mean((out["action_dist_inputs"].argmax(-1) == batch[ACTIONS]).float())
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "action_accuracy": acc,
            "mean_sqd_adv": batch_mean(torch.square(adv)),
        }

    return loss_fn


def attach_mc_returns(batch: SampleBatch, gamma: float) -> SampleBatch:
    """Backward discounted-return pass over row-ordered episodic data
    (reference: compute_advantages with use_gae=False in the offline
    pre-learner)."""
    if REWARDS not in batch:
        raise ValueError("MARWIL offline data needs a 'rewards' column")
    rew = np.asarray(batch[REWARDS], np.float32)
    term = np.asarray(
        batch.get(TERMINATEDS, np.zeros(len(batch), bool)), bool
    )
    # Truncated boundaries also cut the return chain: without a value
    # function there is nothing to bootstrap with, and leaking the next
    # episode's rewards across the boundary is strictly worse.
    done = term
    if "truncateds" in batch:
        done = term | np.asarray(batch["truncateds"], bool)
    ret = np.zeros_like(rew)
    acc = 0.0
    for t in range(len(rew) - 1, -1, -1):
        if done[t]:
            acc = 0.0
        acc = rew[t] + gamma * acc
        ret[t] = acc
    batch[RETURNS] = ret
    return batch


class MARWIL(Algorithm):
    config_class = MARWILConfig

    def build_learner(self, cfg: MARWILConfig) -> None:
        if cfg.offline_data is None:
            raise ValueError("MARWIL requires config.offline(offline_data=...)")
        if cfg.num_learners > 0:
            raise ValueError(
                "MARWIL drives its learner locally (the ma_adv_norm moving "
                "stat lives with the driver); num_learners > 0 is not "
                "supported"
            )
        self._dataset = attach_mc_returns(
            _to_sample_batch(cfg.offline_data), cfg.gamma
        )
        tx = make_optimizer(cfg)
        spec, seed = cfg.rl_module_spec(), cfg.seed
        loss_fn = make_marwil_loss(cfg)

        def factory():
            return TorchLearner(spec.build(seed=seed), loss_fn, tx, mesh=cfg.mesh)

        self.learner_group = LearnerGroup(factory, num_learners=cfg.num_learners,
                                          device=cfg.device)
        self._ma_adv_norm = 1.0  # RMS of advantages, host-side moving stat

    def get_extra_state(self) -> dict:
        return {"ma_adv_norm": self._ma_adv_norm}

    def set_extra_state(self, state: dict) -> None:
        self._ma_adv_norm = state["ma_adv_norm"]

    def training_step(self) -> dict:
        cfg = self.algo_config
        rate = cfg.moving_average_sqd_adv_norm_update_rate
        batch = SampleBatch(dict(self._dataset))
        metrics: dict = {}
        rng = np.random.default_rng(self.iteration)
        # Datasets smaller than the configured batch still train
        # (minibatches() drops remainders).
        mb_size = min(cfg.train_batch_size, len(batch))
        for _ in range(cfg.num_epochs):
            shuffled = batch.shuffle(rng)
            for mb in shuffled.minibatches(mb_size):
                mb["ma_adv_norm"] = np.float32(self._ma_adv_norm)
                metrics = self.learner_group.local.update(mb)
                # Moving RMS of the advantage (reference ma_adv_norm).
                self._ma_adv_norm = float(
                    (1 - rate) * self._ma_adv_norm
                    + rate * np.sqrt(max(metrics["mean_sqd_adv"], 1e-12))
                )
        metrics["num_offline_rows"] = len(self._dataset)
        metrics["ma_adv_norm"] = self._ma_adv_norm
        return metrics
