"""Shared pieces of the tests/test_torch_rllib*.py files: recording
what an algorithm's runners sample, leaf-wise comparison of parameter
trees, the top-2 gap of an argmax, and the noise ray_tpu's CQL loss
draws from its key, as the port's batch columns."""

import jax
import numpy as np

from ray_tpu_torch.ops import tree as ttree


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
