"""PPO: clipped-surrogate policy optimization (port of
ray_tpu/rllib/algorithms/ppo.py).

Counterpart of the reference's PPO (rllib/algorithms/ppo/ppo.py:362 —
training_step :388: synchronous_parallel_sample -> LearnerGroup.update ->
sync weights), with the loss a pure torch function of (params, batch)
that the learner differentiates. ``kl_target`` stops an iteration's
epochs early: once an epoch ends with a mean KL (between the sampling
policy and the learner's, on the epoch's last minibatch) above it, the
remaining epochs are skipped. ray_tpu's PPOConfig has the field but reads
it nowhere; unset (the default), the two run the same epochs."""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.connectors import build_pipeline
from ray_tpu_torch.rllib.core.learner import LearnerGroup, TorchLearner, make_optimizer
from ray_tpu_torch.rllib.core.rl_module import (
    categorical_entropy,
    categorical_logp,
    to_tensor,
)
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGP,
    NEXT_OBS,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
    VALUE_TARGETS,
    VF_PREDS,
    SampleBatch,
    compute_gae,
)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=PPO)
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.lambda_ = 0.95
        self.kl_target: float | None = None

    def training(self, **kwargs) -> "PPOConfig":
        # Accept reference spellings.
        if "lambda_" not in kwargs and "lambda" in kwargs:
            kwargs["lambda_"] = kwargs.pop("lambda")
        return super().training(**kwargs)


def make_ppo_loss(cfg: PPOConfig):
    clip, vf_clip = cfg.clip_param, cfg.vf_clip_param
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff

    def loss_fn(params, apply_fn, batch):
        out = apply_fn(params, batch[OBS])
        logits = out["action_dist_inputs"]
        logp = categorical_logp(logits, batch[ACTIONS])
        ratio = torch.exp(logp - batch[LOGP])
        adv = batch[ADVANTAGES]
        # Per-minibatch advantage normalization (reference PPO default);
        # the population std, as jnp.std.
        adv = (adv - adv.mean()) / torch.clamp(adv.std(correction=0), min=1e-4)
        surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        policy_loss = -surrogate.mean()

        vf = out[VF_PREDS]
        vf_err = torch.square(vf - batch[VALUE_TARGETS])
        vf_loss = torch.clamp(vf_err, 0.0, vf_clip).mean()

        entropy = categorical_entropy(logits).mean()
        total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        kl = (batch[LOGP] - logp).mean()
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_kl": kl}

    return loss_fn


class PPO(Algorithm):
    config_class = PPOConfig
    supports_learner_connector = True

    def build_learner(self, cfg: PPOConfig) -> None:
        tx = make_optimizer(cfg)
        loss_fn = make_ppo_loss(cfg)
        spec, seed = cfg.rl_module_spec(), cfg.seed
        self._learner_pipe = build_pipeline(cfg.learner_connector)

        def factory():
            return TorchLearner(spec.build(seed=seed), loss_fn, tx)

        self.learner_group = LearnerGroup(factory, num_learners=cfg.num_learners)

    @torch.no_grad()
    def _values(self, obs: np.ndarray) -> np.ndarray:
        """V(obs) under the learner's current parameters."""
        module = self.learner_group.local.module
        return module.apply(module.params, to_tensor(obs, module.device))[VF_PREDS].cpu().numpy()

    def _postprocess(self, batch: SampleBatch) -> SampleBatch:
        """Attach GAE advantages/targets (reference:
        postprocessing.compute_advantages via the learner connector)."""
        cfg = self.algo_config
        next_values = self._values(batch[NEXT_OBS])
        # Reshape flat [T*B] rows back to [T, B] (row-major by t).
        T = cfg.rollout_fragment_length
        B = len(batch) // T
        shape = lambda a: a.reshape(T, B)  # noqa: E731
        adv, targets = compute_gae(
            shape(batch[REWARDS]), shape(batch[VF_PREDS]), next_values.reshape(T, B),
            shape(batch[TERMINATEDS]), shape(batch[TRUNCATEDS]), cfg.gamma, cfg.lambda_)
        batch[ADVANTAGES] = adv.reshape(-1)
        batch[VALUE_TARGETS] = targets.reshape(-1)
        return batch

    def training_step(self) -> dict:
        cfg = self.algo_config
        weights = self.learner_group.get_weights()
        # 1. sample (synchronous_parallel_sample, execution/rollout_ops.py:20)
        # GAE runs on each runner's t-major batch before flat concat.
        batches: list[SampleBatch] = []
        total = 0
        while total < cfg.train_batch_size:
            for b in self.env_runner_group.sample_batches(weights):
                if self._learner_pipe is not None:
                    b = self._learner_pipe(b)
                batches.append(self._postprocess(b))
                total += len(b)
        batch = SampleBatch.concat_samples(batches)
        # 2. learn, one epoch at a time (the same minibatch shuffles as
        # update_epochs over all of them), until the KL passes kl_target
        metrics: dict = {}
        for _ in range(cfg.num_epochs):
            metrics = self.learner_group.update_epochs(
                batch, num_epochs=1, minibatch_size=cfg.minibatch_size)
            if cfg.kl_target is not None and metrics["mean_kl"] > cfg.kl_target:
                break
        return {"num_env_steps_sampled": len(batch), **metrics}
