"""IMPALA: asynchronous sampling + V-trace off-policy correction (port of
ray_tpu/rllib/algorithms/impala.py).

Counterpart of the reference's IMPALA (rllib/algorithms/impala/impala.py:599
— async sample queues, weight broadcast) with vtrace_torch.py's
recursion: ray_tpu's reverse ``lax.scan`` is a reverse loop over T here.
Env runners sample with slightly stale weights; the learner corrects
with clipped importance ratios. The asynchronous loop waits on the
runners' sample refs one at a time (``ray_tpu_torch.wait``): a runner is
re-armed with the newest weights the moment its batch lands, and the
learner updates on each [T*B] t-major batch as it arrives. With
``num_env_runners == 0`` the step raises ray_tpu's ValueError.
"""

from __future__ import annotations

import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, TorchLearner, batch_mean,
                                               make_optimizer)
from ray_tpu_torch.rllib.core.rl_module import categorical_entropy, categorical_logp
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    BEHAVIOR_LOGITS,
    NEXT_OBS,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
    SampleBatch,
)


@torch.no_grad()
def vtrace(
    target_logp,  # [T, B] log pi(a|s) under the learner policy
    behavior_logp,  # [T, B] log mu(a|s) under the sampling policy
    rewards,  # [T, B]
    values,  # [T, B] V(s_t) under the learner policy
    next_values,  # [T, B] V(s_{t+1}); at truncation, V(terminal obs)
    terminateds,  # [T, B] float {0,1}
    truncateds,  # [T, B] float {0,1}
    gamma: float,
    clip_rho_threshold: float = 1.0,
    clip_c_threshold: float = 1.0,
):
    """V-trace targets + policy-gradient advantages (reference:
    rllib/algorithms/impala/vtrace_torch.py; Espeholt et al. 2018).

    Returns (vs, pg_advantages), both [T, B], cut from autograd."""
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=clip_c_threshold)
    not_term = 1.0 - terminateds
    chain = not_term * (1.0 - truncateds)  # next row is a fresh episode
    deltas = clipped_rhos * (rewards + gamma * next_values * not_term - values)
    acc = torch.zeros_like(deltas[0])
    dvs = [None] * deltas.shape[0]
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * cs[t] * chain[t] * acc
        dvs[t] = acc
    vs = values + torch.stack(dvs)
    # vs_{t+1} for the pg advantage: shift; at rollout end approximate with
    # next_values (exact when the trajectory ends or bootstraps there).
    vs_next = torch.cat([vs[1:], next_values[-1:]], dim=0)
    vs_next = chain * vs_next + (1.0 - chain) * next_values
    pg_adv = clipped_rhos * (rewards + gamma * vs_next * not_term - values)
    return vs, pg_adv


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=IMPALA)
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        self.num_env_runners = 2  # async needs remote runners
        self.train_batch_size = 512
        self.max_requests_in_flight = 2


def vtrace_terms(params, apply_fn, batch, T: int, cfg):
    """What the IMPALA and APPO losses share: the t-major [T, B] logits,
    values, target and behavior log-probs, and V-trace's (vs, pg_adv)."""
    tm = lambda a: a.reshape((T, -1) + tuple(a.shape[1:]))  # noqa: E731  t-major
    obs, next_obs = tm(batch[OBS]), tm(batch[NEXT_OBS])
    actions = tm(batch[ACTIONS])
    out = apply_fn(params, obs)
    logits, values = out["action_dist_inputs"], out["vf_preds"]
    next_values = apply_fn(params, next_obs)["vf_preds"]
    target_logp = categorical_logp(logits, actions)
    behavior_logp = categorical_logp(tm(batch[BEHAVIOR_LOGITS]), actions)
    vs, pg_adv = vtrace(
        target_logp, behavior_logp, tm(batch[REWARDS]), values, next_values,
        tm(batch[TERMINATEDS]).float(), tm(batch[TRUNCATEDS]).float(),
        cfg.gamma, cfg.clip_rho_threshold, cfg.clip_c_threshold)
    return logits, values, target_logp, behavior_logp, vs, pg_adv


def make_impala_loss(cfg: IMPALAConfig, T: int):
    def loss_fn(params, apply_fn, batch):
        logits, values, target_logp, behavior_logp, vs, pg_adv = vtrace_terms(
            params, apply_fn, batch, T, cfg)
        policy_loss = -batch_mean(target_logp * pg_adv)
        vf_loss = 0.5 * batch_mean(torch.square(values - vs))
        entropy = batch_mean(categorical_entropy(logits))
        total = policy_loss + cfg.vf_loss_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss, "entropy": entropy,
                       "mean_rho": batch_mean(torch.exp(target_logp - behavior_logp))}

    return loss_fn


class IMPALA(Algorithm):
    config_class = IMPALAConfig

    def make_loss(self, cfg):
        """Loss factory hook; APPO overrides with the clipped variant."""
        return make_impala_loss(cfg, cfg.rollout_fragment_length)

    def build_learner(self, cfg: IMPALAConfig) -> None:
        tx = make_optimizer(cfg)
        loss_fn = self.make_loss(cfg)
        spec, seed = cfg.rl_module_spec(), cfg.seed

        def factory():
            return TorchLearner(spec.build(seed=seed), loss_fn, tx, mesh=cfg.mesh,
                                time_major_T=cfg.rollout_fragment_length)

        # IMPALA's learner is driver-local (the card belongs to the
        # driver); async scale-out is on the env-runner side.
        self.learner_group = LearnerGroup(factory, num_learners=0)
        self._inflight: dict = {}  # ObjectRef -> runner handle

    def _arm(self, runner, weights_ref) -> None:
        ref = runner.sample.remote(weights_ref)
        self._inflight[ref] = runner

    def training_step(self) -> dict:
        cfg = self.algo_config
        if not self.env_runner_group.remote_runners:
            raise ValueError("IMPALA requires num_env_runners >= 1 (async path)")
        weights_ref = ray_tpu_torch.put(self.learner_group.get_weights())
        # Prime the pipeline.
        for runner in self.env_runner_group.remote_runners:
            while (sum(1 for r in self._inflight.values() if r is runner)
                   < cfg.max_requests_in_flight):
                self._arm(runner, weights_ref)
        collected: list[SampleBatch] = []
        total = 0
        metrics: dict = {}
        num_updates = 0
        while total < cfg.train_batch_size:
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1)
            for ref in ready:
                runner = self._inflight.pop(ref)
                batch = ray_tpu_torch.get(ref)
                collected.append(batch)
                total += len(batch)
                # Re-arm at once with the newest weights (broadcast).
                self._arm(runner, weights_ref)
            # Learn on whatever has arrived (the off-policy correction
            # absorbs the staleness).
            while collected:
                metrics = self.learner_group.local.update(collected.pop(0))
                num_updates += 1
                weights_ref = ray_tpu_torch.put(self.learner_group.get_weights())
        metrics["num_env_steps_sampled"] = total
        metrics["num_learner_updates"] = num_updates
        return metrics

    def cleanup(self) -> None:
        # Drain the in-flight sample requests (bounded) before the runners
        # are killed.
        if self._inflight:
            ray_tpu_torch.wait(list(self._inflight), num_returns=len(self._inflight),
                               timeout=10.0)
        self._inflight.clear()
        super().cleanup()

    stop = cleanup
