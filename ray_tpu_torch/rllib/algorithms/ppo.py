"""PPO: clipped-surrogate policy optimization (port of
ray_tpu/rllib/algorithms/ppo.py).

Counterpart of the reference's PPO (rllib/algorithms/ppo/ppo.py:362 —
training_step :388: synchronous_parallel_sample -> LearnerGroup.update ->
sync weights), with the loss a pure torch function of (params, batch)
that the learner differentiates. ``kl_target`` stops an iteration's
epochs early: once an epoch ends with a mean KL (between the sampling
policy and the learner's, on the epoch's last minibatch) above it, the
remaining epochs are skipped (multi-agent: each module's own). ray_tpu's
PPOConfig has the field but reads it nowhere; unset (the default), the
two run the same epochs.

Multi-agent configs sample per-module fragments, attach GAE to each and
update one learner per module (reference: ``_multi_agent_training_step``)."""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.connectors import build_pipeline
from ray_tpu_torch.rllib.core.learner import (
    LearnerGroup,
    TorchLearner,
    batch_mean,
    batch_std,
    make_optimizer,
)
from ray_tpu_torch.rllib.core.rl_module import (
    categorical_entropy,
    categorical_logp,
    to_tensor,
)
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentLearnerGroup
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
        # the population std, as jnp.std, both of the whole minibatch.
        adv = (adv - batch_mean(adv)) / torch.clamp(batch_std(adv), min=1e-4)
        surrogate = torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        policy_loss = -batch_mean(surrogate)

        vf = out[VF_PREDS]
        vf_err = torch.square(vf - batch[VALUE_TARGETS])
        vf_loss = batch_mean(torch.clamp(vf_err, 0.0, vf_clip))

        entropy = batch_mean(categorical_entropy(logits))
        total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
        kl = batch_mean(batch[LOGP] - logp)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_kl": kl}

    return loss_fn


class PPO(Algorithm):
    config_class = PPOConfig
    supports_multi_agent = True
    supports_learner_connector = True

    def build_learner(self, cfg: PPOConfig) -> None:
        tx = make_optimizer(cfg)
        loss_fn = make_ppo_loss(cfg)
        seed, mesh = cfg.seed, cfg.mesh
        self._learner_pipe = build_pipeline(cfg.learner_connector)

        def factory(spec):
            return lambda: TorchLearner(spec.build(seed=seed), loss_fn, tx, mesh=mesh)

        if cfg.is_multi_agent:
            # One local learner per module, whatever num_learners is (as
            # the reference builds its MultiAgentLearnerGroup).
            self.learner_group = MultiAgentLearnerGroup(
                {mid: factory(s) for mid, s in cfg.rl_module_specs().items()},
                policies_to_train=cfg.policies_to_train)
            return
        self.learner_group = LearnerGroup(factory(cfg.rl_module_spec()),
                                          num_learners=cfg.num_learners, device=cfg.device)
        # With remote learners the bootstrap values come from a local
        # module that takes the group's weights each iteration.
        self._value_module = (cfg.rl_module_spec().build(seed=0)
                              if self.learner_group.local is None else None)

    @torch.no_grad()
    def _values(self, obs: np.ndarray, module_id: str | None = None) -> np.ndarray:
        """V(obs) under the learner's current parameters (of ``module_id``'s
        learner in a multi-agent config)."""
        if module_id is not None:
            module = self.learner_group.learners[module_id].module
        elif self.learner_group.local is not None:
            module = self.learner_group.local.module
        else:
            module = self._value_module
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

    def _postprocess_fragment(self, frag: SampleBatch, module_id: str) -> SampleBatch:
        """GAE over one contiguous (env, agent) fragment: the [T, B] math
        with B=1 and per-step NEXT_OBS bootstrapping. ray_tpu pads the
        value call's rows to a power of two to bound XLA's shapes and keeps
        the first n values; eager torch takes any row count, so the port
        calls it on the n rows, which gives the same values."""
        cfg = self.algo_config
        next_values = self._values(frag[NEXT_OBS], module_id)
        col = lambda a: np.asarray(a).reshape(-1, 1)  # noqa: E731
        adv, targets = compute_gae(
            col(frag[REWARDS]), col(frag[VF_PREDS]), next_values.reshape(-1, 1),
            col(frag[TERMINATEDS]), col(frag[TRUNCATEDS]), cfg.gamma, cfg.lambda_)
        frag[ADVANTAGES] = adv.reshape(-1)
        frag[VALUE_TARGETS] = targets.reshape(-1)
        return frag

    def _multi_agent_training_step(self) -> dict:
        """Reference: multi-agent PPO training_step — sample per-module
        episode fragments, GAE each, then per-module SGD epochs (one at a
        time, each module stopping once its KL passes kl_target)."""
        cfg = self.algo_config
        weights = self.learner_group.get_weights()
        per_module: dict[str, list[SampleBatch]] = {}
        total = 0
        while total < cfg.train_batch_size:
            for mid, flist in self.env_runner_group.sample_fragments(weights).items():
                for f in flist:
                    if self._learner_pipe is not None:
                        f = self._learner_pipe(f)  # before GAE, as on the single-agent path
                    per_module.setdefault(mid, []).append(self._postprocess_fragment(f, mid))
                    total += len(f)
        batches = {mid: SampleBatch.concat_samples(fl) for mid, fl in per_module.items()}
        metrics: dict = {}
        for _ in range(cfg.num_epochs):
            epoch = self.learner_group.update_epochs(
                batches, num_epochs=1, minibatch_size=cfg.minibatch_size)
            metrics.update(epoch)
            if cfg.kl_target is not None:
                batches = {mid: b for mid, b in batches.items()
                           if mid not in epoch or epoch[mid]["mean_kl"] <= cfg.kl_target}
                if not batches:
                    break
        # The flat aggregates over every module's last epoch.
        per = {mid: m for mid, m in metrics.items() if mid in self.learner_group.learners}
        for k in {k for m in per.values() for k in m}:
            metrics[k] = float(np.mean([m[k] for m in per.values() if k in m]))
        return {"num_env_steps_sampled": total, **metrics}

    def training_step(self) -> dict:
        cfg = self.algo_config
        if cfg.is_multi_agent:
            return self._multi_agent_training_step()
        weights = self.learner_group.get_weights()
        if self._value_module is not None:
            self._value_module.set_weights(weights)
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
        # 2. learn: every epoch in one call (remote learners average their
        # weights after it, as the reference's do); with kl_target, one
        # epoch at a time (the same minibatch shuffles) until the KL
        # passes it, remote learners averaging after each epoch.
        if cfg.kl_target is None:
            metrics = self.learner_group.update_epochs(
                batch, num_epochs=cfg.num_epochs, minibatch_size=cfg.minibatch_size)
        else:
            for _ in range(cfg.num_epochs):
                metrics = self.learner_group.update_epochs(
                    batch, num_epochs=1, minibatch_size=cfg.minibatch_size)
                if metrics["mean_kl"] > cfg.kl_target:
                    break
        return {"num_env_steps_sampled": len(batch), **metrics}
