"""BC: behavior cloning from offline data (port of
ray_tpu/rllib/algorithms/bc.py).

Counterpart of the reference's BC (rllib/algorithms/bc/ — offline RL via
the offline data pipeline, rllib/offline/). Data here is a dict of numpy
columns ({obs, actions}), a list of SampleBatches, or any object with a
``take_all()`` returning row dicts (a Dataset), minibatched into the
cross-entropy learner update. No env runners are required (env=None);
providing an env enables evaluation rollouts.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import (LearnerGroup, TorchLearner, batch_mean,
                                               make_optimizer)
from ray_tpu_torch.rllib.core.rl_module import categorical_logp
from ray_tpu_torch.rllib.sample_batch import ACTIONS, OBS, SampleBatch


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=BC)
        self.offline_data = None  # dict cols | list[SampleBatch] | Dataset
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_epochs = 1

    def offline(self, offline_data) -> "BCConfig":
        self.offline_data = offline_data
        return self


def make_bc_loss():
    def loss_fn(params, apply_fn, batch):
        logits = apply_fn(params, batch[OBS])["action_dist_inputs"]
        logp = categorical_logp(logits, batch[ACTIONS])
        loss = -batch_mean(logp)
        acc = batch_mean((logits.argmax(-1) == batch[ACTIONS]).float())
        return loss, {"bc_loss": loss, "action_accuracy": acc}

    return loss_fn


class BC(Algorithm):
    config_class = BCConfig

    def build_learner(self, cfg: BCConfig) -> None:
        if cfg.offline_data is None:
            raise ValueError("BC requires config.offline(offline_data=...)")
        self._dataset = _to_sample_batch(cfg.offline_data)
        tx = make_optimizer(cfg)
        spec, seed = cfg.rl_module_spec(), cfg.seed
        loss_fn = make_bc_loss()

        def factory():
            return TorchLearner(spec.build(seed=seed), loss_fn, tx, mesh=cfg.mesh)

        self.learner_group = LearnerGroup(factory, num_learners=cfg.num_learners,
                                          device=cfg.device)

    def training_step(self) -> dict:
        cfg = self.algo_config
        metrics = self.learner_group.update_epochs(
            self._dataset, num_epochs=cfg.num_epochs, minibatch_size=cfg.train_batch_size)
        metrics["num_offline_rows"] = len(self._dataset)
        return metrics


def _to_sample_batch(data) -> SampleBatch:
    if isinstance(data, SampleBatch):
        return data
    if isinstance(data, dict):
        return SampleBatch({k: np.asarray(v) for k, v in data.items()})
    if isinstance(data, list):
        return SampleBatch.concat_samples([_to_sample_batch(d) for d in data])
    take_all = getattr(data, "take_all", None)
    if take_all is not None:  # a Dataset of row dicts (duck-typed)
        rows = take_all()
        cols: dict[str, list] = {}
        for r in rows:
            for k, v in r.items():
                cols.setdefault(k, []).append(v)
        return SampleBatch({k: np.asarray(v) for k, v in cols.items()})
    raise TypeError(f"unsupported offline data type {type(data)}")
