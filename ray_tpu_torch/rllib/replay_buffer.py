"""Replay buffers for off-policy algorithms (DQN/SAC) (port of
ray_tpu/rllib/replay_buffer.py, numpy as it is there).

Counterpart of the reference's replay buffer stack
(rllib/utils/replay_buffers/ — EpisodeReplayBuffer and the
MultiAgentReplayBuffer used by DQN/SAC). Storage is flat preallocated
numpy rings on the host (replay never touches the card); the learner
copies each sampled minibatch to its device in one go.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO ring over column arrays, preallocated on first add."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
        if n > self.capacity:
            batch = batch.slice(n - self.capacity, n)
            n = self.capacity
        idx = (self._next + np.arange(n)) % self.capacity
        for k, col in self._cols.items():
            col[idx] = np.asarray(batch[k])
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)

    def sample(self, num_items: int) -> SampleBatch:
        if self._size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = self._rng.integers(0, self._size, size=num_items)
        return SampleBatch({k: col[idx] for k, col in self._cols.items()})

    def state(self) -> dict:
        return {
            "cols": {k: v[: self._size].copy() for k, v in self._cols.items()},
            "next": self._next, "size": self._size,
        }
