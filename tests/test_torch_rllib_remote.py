"""RLlib's remote env-runner and learner groups: the same script
(tests/torch_rllib_remote_parity_cases.py) under ray_tpu and under
ray_tpu_torch, in three parts each, the six processes side by side (each
with head_shards=1, every get bounded, every process under a timeout).

PPO with 2 remote runners and 2 remote learners on CartPole-v1 from the
same carried weights: the same observations, actions and rewards in
both iterations (every Gumbel argmax decided by more than MARGIN, the
runners' draws regenerated here from their seeds), metrics within 1e-4,
parameters within test_torch_rllib_algos.py's limit (1e-4 of the larger
of each leaf's largest |value| and the learning rate), and the two
learners' weights equal bit for bit after each iteration. A
LearnerGroup(num_learners=2) update gives the reference's averaged
weights; a one-row batch is replicated. Two runners' connector states
merge to the reference's statistics. IMPALA and APPO at their defaults
pass tests/test_rllib.py's checks. A multi-agent group's fragments have
the reference's module ids and row counts. stop() leaves no runner or
learner alive.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tests", "torch_rllib_remote_parity_cases.py")
MARGIN = 1e-4  # the least top-2 gap of a sampled argmax that the test trusts
PARTS = ("sync", "async", "groups")


@pytest.fixture(scope="module")
def outcomes():
    results, threads = {}, []

    def run(pkg, part):
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
        try:
            results[pkg, part] = subprocess.run(
                [sys.executable, SCRIPT, pkg, part], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=170)
        except subprocess.TimeoutExpired as e:
            results[pkg, part] = subprocess.CompletedProcess(e.cmd, "timeout", e.stdout, e.stderr)

    for pkg in ("ray_tpu", "ray_tpu_torch"):
        for part in PARTS:
            threads.append(threading.Thread(target=run, args=(pkg, part)))
            threads[-1].start()
    for t in threads:
        t.join(timeout=200)
        assert not t.is_alive()
    out = {"ray_tpu": {}, "ray_tpu_torch": {}}
    for (pkg, part), proc in results.items():
        assert proc.returncode == 0, (
            f"{pkg} {part} ({proc.returncode}):\n{(proc.stderr or '')[-4000:]}\n"
            f"{(proc.stdout or '')[-2000:]}")
        out[pkg].update(json.loads(proc.stdout.strip().splitlines()[-1]))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if tree and isinstance(tree[0], dict):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree, np.float64)]


def _weights_close(got, want, floor):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), floor))


def _top2_gap(x):
    top2 = np.sort(x, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_ppo_with_remote_runners_and_learners_matches_reference(outcomes):
    want, got = outcomes["ray_tpu"]["ppo"], outcomes["ray_tpu_torch"]["ppo"]
    T, B, lr = 32, 4, 3e-4
    # Runner i draws its Gumbel noise from default_rng(seed + 1000 (i + 1)),
    # one [B, A] draw a step, in order.
    draws = [np.random.default_rng(1000 * (i + 1)) for i in range(2)]
    for it in range(2):
        for r in range(2):
            jb, tb = want["samples"][it][r], got["samples"][it][r]
            logits = np.asarray(jb["behavior_logits"], np.float32).reshape(T, B, -1)
            noise = np.stack([draws[r].gumbel(size=logits.shape[1:]).astype(np.float32)
                              for _ in range(T)])
            assert _top2_gap(logits + noise).min() > MARGIN, (it, r)
            for key in ("obs", "actions", "rewards"):
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
            np.testing.assert_allclose(tb["behavior_logits"], jb["behavior_logits"], atol=1e-5)
        wm, gm = want["iterations"][it]["metrics"], got["iterations"][it]["metrics"]
        for key in ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl", "grad_norm",
                    "episode_return_mean"):
            np.testing.assert_allclose(gm[key], wm[key], rtol=1e-4, atol=1e-6, err_msg=key)
        assert gm["num_env_steps_sampled"] == wm["num_env_steps_sampled"] == 256
        _weights_close(got["iterations"][it]["weights"], want["iterations"][it]["weights"], lr)
        assert got["iterations"][it]["learners_equal"]
        assert want["iterations"][it]["learners_equal"]


@pytest.mark.parametrize("case", ["learner_group", "learner_group_one_row"])
def test_learner_group_averages_as_the_reference(outcomes, case):
    want, got = outcomes["ray_tpu"][case], outcomes["ray_tpu_torch"][case]
    assert got["metrics"].keys() == want["metrics"].keys()
    for key, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], v, rtol=1e-4, atol=1e-6, err_msg=key)
    _weights_close(got["weights"], want["weights"], 3e-4)
    if case == "learner_group_one_row":  # replicated: both learners update alike
        assert got["learners_equal"] and want["learners_equal"]


def test_connector_states_merge_as_the_reference(outcomes):
    want, got = outcomes["ray_tpu"], outcomes["ray_tpu_torch"]
    assert [s["kind"] for s in got["connector"]] == [s["kind"] for s in want["connector"]]
    for g, w in zip(got["connector"], want["connector"]):
        assert g["count"] == w["count"]
        for key in ("mean", "m2"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-6, err_msg=key)
    # the merged statistics went back to both runners
    assert got["connector_broadcast"] == want["connector_broadcast"]


@pytest.mark.parametrize("algo", ["IMPALAConfig", "APPOConfig"])
def test_async_algorithms_train_at_their_defaults(outcomes, algo):
    want, got = outcomes["ray_tpu"][algo], outcomes["ray_tpu_torch"][algo]
    assert got == want == {"updates_at_least_1": True, "finite": True, "rho_near_1": True,
                           "steps_at_least_batch": True}


def test_multi_agent_fragments_match_reference(outcomes):
    want, got = outcomes["ray_tpu"]["multi_agent"], outcomes["ray_tpu_torch"]["multi_agent"]
    assert got == want
    assert sorted(got) == ["m0", "m1"]


@pytest.mark.parametrize("key", ["stopped", "stopped_multi_agent"])
def test_stop_leaves_no_actor_alive(outcomes, key):
    assert all(outcomes["ray_tpu_torch"][key])
    assert outcomes["ray_tpu_torch"][key] == outcomes["ray_tpu"][key]


def test_the_port_loads_neither_jax_nor_ray_tpu(outcomes):
    assert outcomes["ray_tpu_torch"]["foreign_modules"] == []
