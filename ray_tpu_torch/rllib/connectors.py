"""Connectors v2: composable batch/observation transform pipelines (port
of ray_tpu/rllib/connectors.py, numpy as it is there).

Counterpart of the reference's connector framework
(reference: rllib/connectors/ — ConnectorV2 base connector_v2.py,
env-to-module pipelines applied by EnvRunners before the RLModule
forward, learner pipelines applied to train batches before the update;
wired via AlgorithmConfig.env_to_module_connector /
learner_connector). Same two hook points here:

- env-to-module: SingleAgentEnvRunner passes raw vector observations
  through the pipeline before every forward call; the transformed
  observations are what land in the sample batch.
- learner: algorithms pass each rollout batch through the pipeline
  BEFORE advantage postprocessing (so e.g. reward clipping shapes GAE
  too) and before the learner's update.

Connectors are host-side numpy transforms (dynamic shapes, python
logic), so the pipeline sits at the host/device boundary.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np


class ConnectorV2:
    """One transform stage (reference: connectors/connector_v2.py)."""

    def __call__(self, data: Any, **kwargs) -> Any:
        raise NotImplementedError

    def reset(self) -> None:
        """Hook for connectors carrying episode-scoped state. The built-in
        vectorized runner uses same-step autoreset and shares one pipeline
        across envs, so it never calls this — custom sequential runners
        may; built-in connectors keep running (episode-agnostic) state."""


class ConnectorPipelineV2(ConnectorV2):
    """Ordered composition (reference: connector_pipeline_v2.py)."""

    def __init__(self, connectors: Sequence[ConnectorV2] = ()):
        self.connectors = list(connectors)

    def __call__(self, data: Any, **kwargs) -> Any:
        for c in self.connectors:
            data = c(data, **kwargs)
        return data

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.insert(0, connector)
        return self

    def get_state(self) -> list:
        return [c.get_state() if hasattr(c, "get_state") else None
                for c in self.connectors]

    def set_state(self, states: list) -> None:
        if len(states) != len(self.connectors):
            raise ValueError(
                f"connector state has {len(states)} entries but the "
                f"pipeline has {len(self.connectors)} connectors — the "
                f"pipeline changed since the checkpoint was written"
            )
        for c, s in zip(self.connectors, states):
            if s is not None and hasattr(c, "set_state"):
                c.set_state(s)


class LambdaConnector(ConnectorV2):
    """Wrap a plain function as a connector."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, data: Any, **kwargs) -> Any:
        return self.fn(data)


class FlattenObservations(ConnectorV2):
    """[B, ...] -> [B, prod(...)] (reference:
    connectors/env_to_module/flatten_observations.py)."""

    def __call__(self, obs: np.ndarray, **kwargs) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        return obs.reshape(obs.shape[0], -1)


def _chan_combine(a: tuple, b: tuple) -> tuple:
    """Chan's parallel combine of two (count, mean, m2) triples."""
    n1, mean1, m21 = a
    n2, mean2, m22 = b
    if n2 == 0.0 or mean2 is None:
        return a
    if n1 == 0.0 or mean1 is None:
        return b
    n = n1 + n2
    delta = mean2 - mean1
    mean = mean1 + delta * (n2 / n)
    m2 = m21 + m22 + delta**2 * (n1 * n2 / n)
    return n, mean, m2


class NormalizeObservations(ConnectorV2):
    """Running mean/std normalization (reference:
    connectors/env_to_module/mean_std_filter.py — MeanStdFilter with
    cross-runner syncing: each runner accumulates a DELTA since the last
    sync on top of a shared synced base; EnvRunnerGroup merges the
    deltas via Chan's parallel combine and broadcasts the merged stats
    back, so with num_env_runners>1 every runner normalizes with the
    same converged statistics and nothing is double-counted)."""

    def __init__(self, epsilon: float = 1e-8, clip: float | None = 10.0):
        self.eps = epsilon
        self.clip = clip
        # Effective stats (base ⊕ delta), used for normalization.
        self._count = 0.0
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None
        # Shared base as of the last sync/restore.
        self._base = (0.0, None, None)
        # Locally accumulated since the last sync.
        self._d_count = 0.0
        self._d_mean: np.ndarray | None = None
        self._d_m2: np.ndarray | None = None

    def __call__(self, obs: np.ndarray, *, update: bool = True, **kwargs):
        obs = np.asarray(obs, np.float32)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:], np.float64)
            self._m2 = np.zeros(obs.shape[1:], np.float64)
        if self._d_mean is None:
            self._d_mean = np.zeros(obs.shape[1:], np.float64)
            self._d_m2 = np.zeros(obs.shape[1:], np.float64)
        if update:
            # Chan's parallel update: fold the whole [B, ...] block in one
            # vectorized step (no per-row Python loop on the hot path).
            block = obs.reshape(-1, *self._mean.shape).astype(np.float64)
            n_b = float(block.shape[0])
            if n_b > 0:
                mean_b = block.mean(axis=0)
                m2_b = ((block - mean_b) ** 2).sum(axis=0)
                self._count, self._mean, self._m2 = _chan_combine(
                    (self._count, self._mean, self._m2),
                    (n_b, mean_b, m2_b))
                self._d_count, self._d_mean, self._d_m2 = _chan_combine(
                    (self._d_count, self._d_mean, self._d_m2),
                    (n_b, mean_b, m2_b))
        var = self._m2 / max(self._count, 1.0)
        out = (obs - self._mean) / np.sqrt(var + self.eps)
        if self.clip is not None:
            out = np.clip(out, -self.clip, self.clip)
        return out.astype(np.float32)

    def get_state(self) -> dict:
        """Snapshot AND harvest (reference: MeanStdFilter clears its sync
        buffer when gathered): the returned delta is consumed by the
        merge, so it must not be re-reported at the next gather — that
        would double-count if a runner ever missed a broadcast. After a
        harvest the effective stats are this runner's own running filter,
        NOT derivable from base ⊕ delta (they retain harvested samples
        the base only gains when the merged broadcast lands)."""
        state = {
            "kind": "normalize_obs",
            "count": self._count, "mean": self._mean, "m2": self._m2,
            "base": self._base,
            "delta": (self._d_count, self._d_mean, self._d_m2),
        }
        self._d_count = 0.0
        self._d_mean = None
        self._d_m2 = None
        return state

    def set_state(self, state: dict) -> None:
        """Adopt state as the new synced base; the local delta restarts
        at zero (sync-broadcast and checkpoint-restore both land here)."""
        self._count = state["count"]
        self._mean = None if state["mean"] is None else np.array(
            state["mean"], np.float64)
        self._m2 = None if state["m2"] is None else np.array(
            state["m2"], np.float64)
        self._base = (self._count, self._mean, self._m2)
        self._d_count = 0.0
        self._d_mean = None
        self._d_m2 = None

    @staticmethod
    def merge_states(states: "list[dict]") -> dict:
        """Freshest base ⊕ every runner's harvested delta. Bases can
        diverge when a runner misses a broadcast (partial failure) or is
        recreated mid-training; taking the largest-count base keeps the
        longest shared history, and because deltas are harvested at
        gather time no sample can be folded in twice. States written
        before the base/delta split (no 'delta' key) merge their
        effectives — only correct for a single runner, which is all that
        format ever held."""
        if all("delta" in s for s in states):
            acc = max((tuple(s.get("base", (0.0, None, None)))
                       for s in states), key=lambda b: b[0])
            for s in states:
                acc = _chan_combine(acc, tuple(s["delta"]))
        else:
            acc = (0.0, None, None)
            for s in states:
                acc = _chan_combine(acc, (s["count"], s["mean"], s["m2"]))
        return {"kind": "normalize_obs",
                "count": acc[0], "mean": acc[1], "m2": acc[2]}


class ClipRewards(ConnectorV2):
    """Learner-side reward clipping (reference:
    connectors/learner/... reward clipping used by Atari configs)."""

    def __init__(self, limit: float = 1.0):
        self.limit = limit

    def __call__(self, batch, **kwargs):
        from ray_tpu_torch.rllib.sample_batch import REWARDS

        if REWARDS in batch:
            batch[REWARDS] = np.clip(batch[REWARDS], -self.limit, self.limit)
        return batch


def merge_pipeline_states(per_runner: "list[list]"
                          ) -> "tuple[list, list[bool]] | tuple[None, None]":
    """Position-wise merge of pipeline states gathered from N runners.

    Stateful connectors publish a self-describing ``kind`` so the merge
    can happen group-side without the connector instances (the group only
    sees pickled state from remote runner actors). Unknown state kinds
    fall back to the first runner's copy — usable for a checkpoint, but
    NOT safe to broadcast back (it would clobber the other runners'
    independent state), hence the per-position ``mergeable`` mask.

    Returns (merged_states, mergeable_mask).
    """
    per_runner = [s for s in per_runner if s is not None]
    if not per_runner:
        return None, None
    merged: list = []
    mergeable: list[bool] = []
    for states in zip(*per_runner):
        non_null = [s for s in states if s is not None]
        if not non_null:
            merged.append(None)
            mergeable.append(True)  # nothing to clobber
        elif all(isinstance(s, dict) and s.get("kind") == "normalize_obs"
                 for s in non_null):
            merged.append(NormalizeObservations.merge_states(non_null))
            mergeable.append(True)
        else:
            merged.append(non_null[0])
            mergeable.append(False)
    return merged, mergeable


def build_pipeline(spec) -> ConnectorPipelineV2 | None:
    """Normalize user input: None | callable-factory | connector |
    list-of-connectors -> pipeline."""
    if spec is None:
        return None
    if isinstance(spec, ConnectorPipelineV2):
        return spec
    if isinstance(spec, ConnectorV2):
        return ConnectorPipelineV2([spec])
    if callable(spec):  # factory (reference passes factories for actors)
        return build_pipeline(spec())
    if isinstance(spec, (list, tuple)):
        return ConnectorPipelineV2([
            c if isinstance(c, ConnectorV2) else LambdaConnector(c)
            for c in spec
        ])
    raise TypeError(f"cannot build a connector pipeline from {spec!r}")
