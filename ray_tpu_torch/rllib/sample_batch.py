"""SampleBatch: columnar rollout storage (port of
ray_tpu/rllib/sample_batch.py, numpy as it is there).

Counterpart of the reference's rllib/policy/sample_batch.py SampleBatch
(dict of parallel arrays keyed by OBS/ACTIONS/REWARDS/...) — kept numpy
host-side; converted to tensors only in the learner's update."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
NEXT_OBS = "next_obs"
BEHAVIOR_LOGITS = "behavior_logits"


class SampleBatch(dict):
    """dict[str, np.ndarray] with batch helpers. All columns share dim 0."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return int(v.shape[0])
        return 0

    @property
    def count(self) -> int:
        return len(self)

    @staticmethod
    def concat_samples(batches: list["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys}
        )

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = len(self)
        for i in range(0, n - size + 1, size):
            yield SampleBatch({k: v[i : i + size] for k, v in self.items()})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def truncate(self, max_rows: int) -> "SampleBatch":
        """Drop rows beyond max_rows (keeps shapes the same across iters)."""
        return self if len(self) <= max_rows else self.slice(0, max_rows)


def compute_gae(
    rewards: np.ndarray,  # [T, B]
    values: np.ndarray,  # [T, B]  V(s_t)
    next_values: np.ndarray,  # [T, B]  V(s_{t+1}) — at truncation, V(terminal obs)
    terminateds: np.ndarray,  # [T, B] bool — true end, no bootstrap
    truncateds: np.ndarray,  # [T, B] bool — time limit, bootstrap but cut λ-chain
    gamma: float,
    lam: float,
) -> tuple[np.ndarray, np.ndarray]:
    """GAE(λ) advantages + value targets (reference:
    rllib/evaluation/postprocessing.py compute_advantages). Time-major
    numpy recursion host-side — O(T·B), negligible next to the learner
    step. Per-step next_values make mid-rollout resets exact:
    at termination the bootstrap is zeroed; at truncation the terminal
    observation's value bootstraps but the λ-chain is cut (the following
    row belongs to a fresh episode)."""
    T, B = rewards.shape
    adv = np.zeros((T, B), np.float32)
    gae = np.zeros(B, np.float32)
    for t in range(T - 1, -1, -1):
        not_term = 1.0 - terminateds[t].astype(np.float32)
        chain = not_term * (1.0 - truncateds[t].astype(np.float32))
        delta = rewards[t] + gamma * next_values[t] * not_term - values[t]
        gae = delta + gamma * lam * chain * gae
        adv[t] = gae
    targets = adv + values
    return adv, targets
