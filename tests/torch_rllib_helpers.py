"""Shared pieces of the tests/test_torch_rllib*.py files: recording
what an algorithm's runners sample, leaf-wise comparison of parameter
trees, the top-2 gap of an argmax, the noise ray_tpu's CQL loss draws
from its key, as the port's batch columns, and the multi-agent
environments of ray_tpu's own multi-agent tests
(tests/test_rllib_multi_agent.py), which both packages' runners take."""

import jax
import numpy as np

from ray_tpu_torch.ops import tree as ttree
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnv


def record(algo):
    """Keep a copy of every batch the algorithm's runner group samples."""
    seen = []
    group = algo.env_runner_group
    real = group.sample_batches

    def sample_batches(weights=None):
        out = real(weights)
        seen.extend({k: np.array(v) for k, v in b.items()} for b in out)
        return out

    group.sample_batches = sample_batches
    return seen


def leaves_close(got_tree, want_tree, tol, floor):
    """Each leaf of ``got_tree`` within ``tol`` of the larger of the
    ``want_tree`` leaf's largest |value| and ``floor``."""
    got, want = ttree.flatten(got_tree), ttree.flatten(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), floor), err_msg=k)


def top2_gap(x):
    top2 = np.sort(x, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def cql_noise(key, B, d, n):
    """The draws ray_tpu's CQL loss makes from ``key``, as the port's
    batch columns."""
    k_pi, k_rand, k_cur, k_nxt = jax.random.split(key, 4)
    return {"noise_pi": np.asarray(jax.random.normal(k_pi, (B, d))),
            "rand_actions": np.asarray(jax.random.uniform(k_rand, (B * n, d),
                                                          minval=-1.0, maxval=1.0)),
            "noise_cur": np.asarray(jax.random.normal(k_cur, (B * n, d))),
            "noise_nxt": np.asarray(jax.random.normal(k_nxt, (B * n, d)))}


class SignalMatch(MultiAgentEnv):
    """Two agents each see a one-hot signal; reward 1 for matching action
    to the signal index. Trivially learnable: random policy scores 1/3."""

    possible_agents = ["a0", "a1"]
    observation_dims = {"a0": 3, "a1": 3}
    action_dims = {"a0": 3, "a1": 3}

    def __init__(self, episode_len: int = 8):
        self.episode_len = episode_len
        self._rng = np.random.default_rng(0)
        self.t = 0

    def _obs(self):
        self.signals = {a: int(self._rng.integers(3)) for a in self.possible_agents}
        return {a: np.eye(3, dtype=np.float32)[self.signals[a]] for a in self.possible_agents}

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.t = 0
        return self._obs(), {}

    def step(self, action_dict):
        rewards = {a: float(action_dict[a] == self.signals[a]) for a in action_dict}
        self.t += 1
        done = self.t >= self.episode_len
        obs = self._obs() if not done else {}
        return obs, rewards, {"__all__": done}, {"__all__": False}, {}


class TurnBased(MultiAgentEnv):
    """Agents alternate turns; the mover's reward arrives with the
    opponent's next move (tests open-transition reward accumulation)."""

    possible_agents = ["p0", "p1"]
    observation_dims = {"p0": 2, "p1": 2}
    action_dims = {"p0": 2, "p1": 2}

    def __init__(self):
        self.t = 0

    def reset(self, seed=None):
        self.t = 0
        return {"p0": np.zeros(2, np.float32)}, {}

    def step(self, action_dict):
        self.t += 1
        mover = "p0" if self.t % 2 == 1 else "p1"
        other = "p1" if mover == "p0" else "p0"
        assert list(action_dict) == [mover]
        done = self.t >= 6
        obs = {} if done else {other: np.full(2, self.t, np.float32)}
        # Reward for the PREVIOUS mover, delivered one step late.
        rewards = {other: 0.5} if self.t > 1 else {}
        return obs, rewards, {"__all__": done}, {"__all__": False}, {}


class EarlyLeave(MultiAgentEnv):
    """Agent a1 terminates at t=2 (its final obs IS included in the obs
    dict, reference convention); a0 plays to the end at t=5."""

    possible_agents = ["a0", "a1"]
    observation_dims = {"a0": 2, "a1": 2}
    action_dims = {"a0": 2, "a1": 2}

    def __init__(self):
        self.t = 0

    def reset(self, seed=None):
        self.t = 0
        return {a: np.zeros(2, np.float32) for a in self.possible_agents}, {}

    def step(self, acts):
        # A dead agent must never act again.
        if self.t >= 2:
            assert "a1" not in acts, f"a1 acted after termination (t={self.t})"
        self.t += 1
        done = self.t >= 5
        obs = {"a0": np.full(2, self.t, np.float32)}
        term = {"__all__": done}
        if self.t == 2:
            obs["a1"] = np.full(2, -1.0, np.float32)  # final obs
            term["a1"] = True
        rew = {a: 1.0 for a in (["a0", "a1"] if self.t <= 2 else ["a0"])}
        return obs, rew, term, {"__all__": False}, {}
