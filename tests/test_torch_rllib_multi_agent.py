"""ray_tpu_torch.rllib's multi-agent RL against ray_tpu.rllib's on the
CPU: the multi-agent env runner's per-module fragments (turn-based
reward attribution and one agent's early termination included), one
PPO ``train()`` iterations, the per-module learner group's update, the
``policies_to_train`` filter, ``kl_target`` per module, a shared-policy
checkpoint and the refusal of algorithms without multi-agent support.

The environments are ray_tpu's own test environments
(``torch_rllib_helpers``); the port's modules take the JAX modules'
weights. Every sampled action is a Gumbel argmax of the port's logits
decided by more than MARGIN, so the JAX runner's logits (within 1e-5)
pick the same one. Limits: values and log-probs 1e-5; one learner group
update's parameters 1e-5 of the larger of each leaf's largest |value|
and the learning rate; after a whole iteration 1e-4.
"""

import copy

import numpy as np
import pytest

from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.env import multi_agent as jma
from ray_tpu_torch.ops import tree as ttree
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import dreamerv3 as tdreamer
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.env import multi_agent as tma
from torch_rllib_helpers import EarlyLeave, SignalMatch, TurnBased, leaves_close, top2_gap

MARGIN = 1e-4  # the least top-2 gap of a sampled argmax that the test trusts
TOL = 1e-5
LR = 3e-2


def _by_agent(agent_id, env_index=0, **kw):
    return agent_id


def _shared(*a, **kw):
    return "shared"


def _ma_config(ppo, env=SignalMatch, policies=("a0", "a1"), mapping=_by_agent,
               envs=4, fragment=16, **training):
    cfg = (ppo.PPOConfig().environment(env=env)
           .multi_agent(policies=list(policies), policy_mapping_fn=mapping)
           .env_runners(num_envs_per_env_runner=envs, rollout_fragment_length=fragment)
           .training(train_batch_size=128, minibatch_size=64, num_epochs=4, lr=LR,
                     entropy_coeff=0.0, **training)
           .debugging(seed=7))
    if ppo is tppo:
        cfg.learners(device="cpu")
    return cfg


@pytest.fixture
def margins(monkeypatch):
    """The least top-2 gap of every Gumbel argmax the port's multi-agent
    runner takes (its logits plus the noise its generator is about to
    draw)."""
    gaps = []
    real = tma.gumbel_sample_logits

    def recording(logits, rng):
        noise = copy.deepcopy(rng).gumbel(size=logits.shape).astype(np.float32)
        gaps.append(top2_gap(logits + noise).min())
        return real(logits, rng)

    monkeypatch.setattr(tma, "gumbel_sample_logits", recording)
    return gaps


def _runners(env, policies, mapping, envs, fragment):
    jcfg = _ma_config(jppo, env, policies, mapping, envs, fragment)
    tcfg = _ma_config(tppo, env, policies, mapping, envs, fragment)
    jcfg._infer_spaces()
    tcfg._infer_spaces()
    jr, tr = jma.MultiAgentEnvRunner(jcfg, seed=0), tma.MultiAgentEnvRunner(tcfg, seed=0)
    tr.set_weights(jr.get_weights())
    return jr, tr


def _same_fragments(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for mid in want:
        assert len(got[mid]) == len(want[mid]), mid
        for g, w in zip(got[mid], want[mid]):
            assert g.keys() == w.keys()
            for k in ("obs", "actions", "rewards", "terminateds", "truncateds", "next_obs"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{mid} {k}")
            for k in ("vf_preds", "action_logp"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=TOL, err_msg=f"{mid} {k}")


def test_runner_fragments_match_reference(margins):
    """Two rollouts of 4 SignalMatch envs, one module per agent: the same
    fragments, module by module, as ray_tpu's runner with its weights."""
    jr, tr = _runners(SignalMatch, ("a0", "a1"), _by_agent, 4, 16)
    for _ in range(2):
        want, got = jr.sample(), tr.sample()
        assert min(margins) > MARGIN
        _same_fragments(got, want)
        assert all(len(f) <= 8 for fl in got.values() for f in fl)
    assert tr.get_metrics() == jr.get_metrics()
    tr.stop()
    jr.stop()


def test_turn_based_reward_attribution(margins):
    """One 6-turn episode, one shared module: each move's reward arrives
    with the opponent's next move, the last mover's never."""
    jr, tr = _runners(TurnBased, ("shared",), _shared, 1, 6)
    want, got = jr.sample(), tr.sample()
    assert min(margins) > MARGIN
    _same_fragments(got, want)
    total = np.concatenate([f["rewards"] for f in got["shared"]])
    assert len(total) == 6
    assert float(total.sum()) == pytest.approx(0.5 * 5, abs=1e-6)


def test_per_agent_early_termination(margins):
    """a1 acts once and terminates at t=2 with the rewards of t=1 and t=2;
    a0 plays 5-step episodes, as with ray_tpu's runner."""
    jr, tr = _runners(EarlyLeave, ("shared",), _shared, 1, 10)
    want, got = jr.sample(), tr.sample()
    assert min(margins) > MARGIN
    _same_fragments(got, want)
    frags = got["shared"]
    a1 = [f for f in frags if len(f) == 1]
    assert a1 and all(f["terminateds"][-1] and f["rewards"][0] == pytest.approx(2.0)
                      for f in a1)
    a0 = [f for f in frags if len(f) == 5]
    assert a0 and all(f["terminateds"][-1] for f in a0)


def test_ppo_iteration_matches_reference(margins):
    """Two multi-agent PPO iterations (64 rows a module from 4 envs):
    the same metrics and each module's parameters as ray_tpu's."""
    jalgo, talgo = _ma_config(jppo).build(), _ma_config(tppo).build()
    talgo.learner_group.set_weights(jalgo.learner_group.get_weights())
    for _ in range(2):
        want, got = jalgo.train(), talgo.train()
        assert min(margins) > MARGIN
        assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"]
        assert got["episode_return_mean"] == want["episode_return_mean"]
        for mid in ("a0", "a1"):
            for k in ("total_loss", "policy_loss", "vf_loss", "entropy", "grad_norm"):
                np.testing.assert_allclose(got[mid][k], want[mid][k], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{mid} {k}")
        leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, LR)
    jalgo.cleanup()
    talgo.cleanup()


def _module_batch(rng, n):
    return {"obs": np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
            + 0.1 * rng.standard_normal((n, 3)).astype(np.float32),
            "actions": rng.integers(0, 3, n).astype(np.int64),
            "action_logp": (np.log(1 / 3) + 0.3 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}


def test_learner_group_update_matches_reference():
    """One update_epochs of the per-module learner group (2 epochs; a0 in
    64-row minibatches, a1's 40 rows shrunk to 32-row ones), from the
    same weights, batches and shuffles: each module's parameters and
    metrics as ray_tpu's MultiAgentLearnerGroup's."""
    jalgo, talgo = _ma_config(jppo).build(), _ma_config(tppo).build()
    talgo.learner_group.set_weights(jalgo.learner_group.get_weights())
    rng = np.random.default_rng(3)
    raw = {"a0": _module_batch(rng, 64), "a1": _module_batch(rng, 40)}
    out = []
    for algo, batch_cls in ((jalgo, jppo.SampleBatch), (talgo, tppo.SampleBatch)):
        batches = {mid: batch_cls(dict(b)) for mid, b in raw.items()}
        out.append(algo.learner_group.update_epochs(
            batches, num_epochs=2, minibatch_size=64, rng=np.random.default_rng(5)))
    want, got = out
    for mid in ("a0", "a1"):
        assert got[mid].keys() == want[mid].keys()
        for k in want[mid]:
            np.testing.assert_allclose(got[mid][k], want[mid][k], rtol=TOL, atol=1e-7,
                                       err_msg=f"{mid} {k}")
    for k in ("total_loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL)
    leaves_close(talgo.get_weights(), jalgo.get_weights(), TOL, LR)


def test_policies_to_train_leaves_the_other_module():
    algo = _ma_config(tppo).multi_agent(policies_to_train=["a0"]).build()
    before = ttree.flatten(algo.get_weights())
    result = algo.train()
    after = ttree.flatten(algo.get_weights())
    assert "a0" in result and "a1" not in result
    assert all(np.array_equal(after[k], v) for k, v in before.items() if k.startswith("a1."))
    assert not all(np.array_equal(after[k], v) for k, v in before.items()
                   if k.startswith("a0."))
    algo.cleanup()


def test_shared_policy_checkpoint_round_trip(tmp_path):
    """Every agent on the default module: its weights and Adam state keyed
    by the module id, restored bit for bit into a fresh algorithm, and
    the restored module's next update equal to the original's."""
    def cfg():
        return (tppo.PPOConfig().environment(env=SignalMatch).learners(device="cpu")
                .multi_agent(policies=[tma.DEFAULT_MODULE_ID])
                .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
                .training(train_batch_size=32, minibatch_size=16, num_epochs=1))
    algo = cfg().build()
    algo.train()
    assert set(algo.get_weights()) == {tma.DEFAULT_MODULE_ID}
    path = algo.save(str(tmp_path))
    restored = cfg().build()
    restored.restore(path)
    assert restored.iteration == algo.iteration == 1
    batch = _module_batch(np.random.default_rng(0), 32)
    nxt = []
    for a in (algo, restored):
        a.learner_group.update_epochs({tma.DEFAULT_MODULE_ID: tppo.SampleBatch(dict(batch))},
                                      num_epochs=1, minibatch_size=16,
                                      rng=np.random.default_rng(1))
        nxt.append(ttree.flatten(a.learner_group.get_state()))
    assert nxt[0].keys() == nxt[1].keys()
    assert all(np.array_equal(nxt[0][k], nxt[1][k]) for k in nxt[0])
    greedy = restored.compute_single_action(np.eye(3, dtype=np.float32)[1],
                                            module_id=tma.DEFAULT_MODULE_ID)
    assert greedy == algo.compute_single_action(np.eye(3, dtype=np.float32)[1])
    algo.cleanup()
    restored.cleanup()


@pytest.mark.parametrize("name", ["DQN", "BC", "DreamerV3"])
def test_algorithms_without_multi_agent_refuse_it(name):
    """ray_tpu's ValueError, word for word."""
    def build(cfg):
        cfg.environment(env=SignalMatch).multi_agent(policies=["a0"])
        with pytest.raises(ValueError) as err:
            cfg.build()
        return str(err.value)

    if name == "DreamerV3":
        from ray_tpu.rllib.algorithms import dreamerv3 as jdreamer
        jcfg, tcfg = jdreamer.DreamerV3Config(), tdreamer.DreamerV3Config()
    else:
        jmod, tmod = {"DQN": (jdqn, tdqn), "BC": (jbc, tbc)}[name]
        jcfg, tcfg = getattr(jmod, f"{name}Config")(), getattr(tmod, f"{name}Config")()
    assert build(tcfg.learners(device="cpu")) == build(jcfg)


@pytest.mark.parametrize("kl_target,updates", [(None, 4), (-1.0, 1)])
def test_kl_target_stops_each_modules_epochs(kl_target, updates):
    """kl_target, read on the single-agent path, stops each module's epochs
    too (64 rows a module: one minibatch an epoch, 4 epochs)."""
    algo = _ma_config(tppo, kl_target=kl_target).build()
    seen = {}
    for mid, learner in algo.learner_group.learners.items():
        real = learner.update

        def update(batch, mid=mid, real=real):
            seen[mid] = seen.get(mid, 0) + 1
            return real(batch)

        learner.update = update
    algo.train()
    assert seen == {"a0": updates, "a1": updates}
    algo.cleanup()
