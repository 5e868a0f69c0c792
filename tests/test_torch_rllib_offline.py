"""ray_tpu_torch.rllib against ray_tpu.rllib on the CPU, part 2: the
offline algorithms (BC and MARWIL's ``train()``, CQL's with ray_tpu's
noise fed to the port), IMPALA's and APPO's learner updates on a
runner's batch, greedy evaluation and ``compute_single_action``,
checkpoints (a JAX PPO checkpoint's learner parameters read into the
port through ``params_from_jax``; the port's own restored state giving
the same next update bit for bit), and what the port refuses until the
runtime core.

Inputs are made with numpy from a seed, or sampled by the runners;
both packages start from the JAX algorithm's weights. Parameters within
1e-4 of the larger of each leaf's largest |value| and the learning rate.
"""

import os
import pickle

import jax
import numpy as np
import pytest

from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.sample_batch import SampleBatch as JBatch
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.ops import tree as ttree
from ray_tpu_torch.rllib import SampleBatch
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.core import rl_module as tmod
from torch_rllib_helpers import SignalMatch, cql_noise, leaves_close


def _episodes(seed, n=256, obs_dim=4, n_actions=2):
    """Row-ordered episodic data: 8 episodes of n/8 steps."""
    rng = np.random.default_rng(seed)
    term = np.zeros(n, bool)
    term[n // 8 - 1::n // 8] = True
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, n_actions, n).astype(np.int64),
            "rewards": rng.random(n).astype(np.float32),
            "terminateds": term}


def _pair(jcfg, tcfg):
    jalgo = jcfg.build()
    talgo = tcfg.learners(device="cpu").build()
    talgo.learner_group.set_weights(jalgo.learner_group.get_weights())
    return jalgo, talgo


@pytest.mark.parametrize("algo", ["bc", "marwil"])
def test_offline_discrete_algorithms_match_reference(algo):
    """Two iterations of BC (minibatches of 64) or MARWIL (MC returns,
    the moving advantage norm): metrics and parameters as ray_tpu's."""
    data = _episodes(0)
    jmod_, tmod_ = (jbc, tbc) if algo == "bc" else (jmarwil, tmarwil)
    cfgs = []
    for mod in (jmod_, tmod_):
        cfg = (mod.BCConfig() if algo == "bc" else mod.MARWILConfig())
        cfgs.append(cfg.offline({k: v.copy() for k, v in data.items()})
                    .environment(observation_dim=4, action_dim=2)
                    .training(train_batch_size=64).debugging(seed=3))
    jalgo, talgo = _pair(*cfgs)
    for _ in range(2):
        want, got = jalgo.train(), talgo.train()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, cfgs[0].lr)


class JaxCQLNoise:
    """The draws ray_tpu's CQL makes each gradient step: the TD targets'
    from kt, the loss's four from ku."""

    def __init__(self, seed, d, n):
        self.key, self.d, self.n = jax.random.PRNGKey(seed), d, n

    def __call__(self, batch_size):
        self.key, kt, ku = jax.random.split(self.key, 3)
        return (np.asarray(jax.random.normal(kt, (batch_size, self.d))),
                cql_noise(ku, batch_size, self.d, self.n))


def test_cql_matches_reference_with_the_jax_noise():
    """Two iterations of 4 gradient steps (BC warm-up for the first 4,
    then the SAC actor): metrics, parameters and the polyak targets as
    ray_tpu's, with ray_tpu's noise fed to the port."""
    rng = np.random.default_rng(4)
    n = 256
    data = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
            "actions": rng.uniform(-0.95, 0.95, (n, 2)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, 3)).astype(np.float32)}
    cfgs = [mod.CQLConfig().offline({k: v.copy() for k, v in data.items()})
            .environment(observation_dim=3, action_dim=2)
            .training(num_gradient_steps=4, bc_iters=4, train_batch_size=32)
            .debugging(seed=5) for mod in (jcql, tcql)]
    jalgo, talgo = _pair(*cfgs)
    w0 = jalgo.learner_group.get_weights()
    talgo.target_q = ttree.tree_map(lambda a: tmod.to_tensor(a, "cpu"),
                                   {"q1": w0["q1"], "q2": w0["q2"]})
    talgo._draw_noise = JaxCQLNoise(5, 2, cfgs[0].num_actions)
    for _ in range(2):
        want, got = jalgo.train(), talgo.train()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["num_gradient_updates"] == 8
    lr = cfgs[0].lr
    leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, lr)
    leaves_close(ttree.tree_map(lambda t: t.numpy(), talgo.target_q),
                  jax.device_get(jalgo.target_q), 1e-4, lr)


@pytest.mark.parametrize("appo", [False, True])
def test_impala_and_appo_learner_updates_match_reference(appo):
    """The local runner's batch (8 envs x 64 steps, behavior logits) and
    two learner updates on it; the asynchronous training step raises
    ray_tpu's ValueError without remote runners."""
    jm, tm = (jappo, tappo) if appo else (jimpala, timpala)
    cfgs = [(m.APPOConfig() if appo else m.IMPALAConfig()).environment("CartPole-v1")
            .env_runners(num_env_runners=0).debugging(seed=6) for m in (jm, tm)]
    jalgo, talgo = _pair(*cfgs)
    w = jalgo.learner_group.get_weights()
    jb = jalgo.env_runner_group.sample(w)
    tb = talgo.env_runner_group.sample(w)
    np.testing.assert_array_equal(tb["actions"], jb["actions"])
    for _ in range(2):
        want = jalgo.learner_group.local.update(JBatch(dict(jb)))
        got = talgo.learner_group.local.update(SampleBatch(dict(jb)))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, cfgs[0].lr)
    for algo in (jalgo, talgo):
        with pytest.raises(ValueError, match="num_env_runners >= 1"):
            algo.train()


def test_evaluation_and_single_actions_match_reference():
    cfgs = [m.PPOConfig().environment("CartPole-v1").debugging(seed=7) for m in (jppo, tppo)]
    jalgo, talgo = _pair(*cfgs)
    assert talgo.evaluate(2) == jalgo.evaluate(2)
    obs = np.random.default_rng(8).standard_normal((16, 4)).astype(np.float32)
    assert ([talgo.compute_single_action(o) for o in obs]
            == [jalgo.compute_single_action(o) for o in obs])


def test_jax_ppo_checkpoint_params_load_into_the_port(tmp_path):
    """ray_tpu's PPO checkpoint (a pickle of numpy state): its learner
    parameters, through params_from_jax, give the JAX module's outputs
    in a port module and in a port algorithm's learner."""
    jalgo = jppo.PPOConfig().environment("CartPole-v1").debugging(seed=9).build()
    jalgo.train()
    path = jalgo.save(str(tmp_path / "jax"))
    with open(os.path.join(path, "algo_state.pkl"), "rb") as f:
        state = pickle.load(f)
    params = params_from_jax(state["learner"]["params"], "cpu")
    talgo = tppo.PPOConfig().environment("CartPole-v1").learners(device="cpu").build()
    talgo.learner_group.local.module.params = params
    obs = np.random.default_rng(10).standard_normal((32, 4)).astype(np.float32)
    want = jalgo.get_module().forward_inference(obs)
    got = talgo.get_module().forward_inference(obs)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_restored_checkpoint_gives_the_same_next_update(tmp_path, algo):
    """save() after an iteration, restore() into a fresh algorithm: the
    iteration, parameters, Adam state and extra state (SAC's target
    critics and noise generator) come back, and the next learner update
    on one batch gives the same bits in both."""
    if algo == "ppo":
        make = lambda: (tppo.PPOConfig().environment("CartPole-v1")  # noqa: E731
                        .learners(device="cpu").debugging(seed=11).build())
    else:
        make = lambda: (tsac.SACConfig().environment("Pendulum-v1")  # noqa: E731
                        .training(learning_starts=256, num_gradient_steps=2)
                        .learners(device="cpu").debugging(seed=11).build())
    a = make()
    a.train()
    path = a.save(str(tmp_path / "ckpt"))
    b = make()
    b.restore(path)
    assert b.iteration == a.iteration == 1
    batch = a.env_runner_group.sample(a.get_weights())
    if algo == "sac":
        batch = a.buffer.sample(32)
        noise = [x._draw_noise(32) for x in (a, b)]
        for k in noise[0][1]:
            np.testing.assert_array_equal(noise[0][1][k], noise[1][1][k])
        for x in (a, b):
            x._gradient_step(SampleBatch(dict(batch)), {})
        for ta, tb in zip(ttree.flatten(a.target_q).values(), ttree.flatten(b.target_q).values()):
            assert (ta == tb).all()
    else:
        for x in (a, b):
            x.learner_group.local.update(x._postprocess(SampleBatch(dict(batch))))
    for k, v in ttree.flatten(a.get_weights()).items():
        np.testing.assert_array_equal(ttree.flatten(b.get_weights())[k], v)


def test_what_waits_raises():
    """Nothing waits any more (the name is kept from when remote runners
    and learners raised): remote runners and learners configure for
    single- and multi-agent configs alike, and a remote runner's config
    (``host_config``) puts every module on the CPU while the learners
    keep the config's device."""
    from ray_tpu_torch.rllib.env.env_runner import host_config

    cfg = tppo.PPOConfig().environment("CartPole-v1").learners(device="cpu")
    multi = (tppo.PPOConfig().environment(SignalMatch)
             .multi_agent(policies=["a0", "a1"], policy_mapping_fn=lambda a, i=0, **k: a))
    multi._infer_spaces()
    for c in (cfg, multi):
        remote = c.copy().env_runners(num_env_runners=2).learners(num_learners=2)
        assert (remote.num_env_runners, remote.num_learners) == (2, 2)
        hosted = host_config(remote)
        assert hosted.device == "cpu" and hosted.mesh is None
        assert {s.device for s in hosted.rl_module_specs().values()} == {"cpu"}
    assert {s.device for s in multi.rl_module_specs().values()} == {"cuda"}
    assert cfg.rl_module_spec().device == "cpu"
    assert tppo.PPOConfig().device == "cuda"


@pytest.mark.parametrize("set_option,read", [
    (lambda c: c.env_runners(num_cpus_per_env_runner=2.0), "num_cpus_per_env_runner"),
    (lambda c: timpala.IMPALAConfig().training(max_requests_in_flight=4),
     "max_requests_in_flight"),
], ids=["num_cpus_per_env_runner", "max_requests_in_flight"])
def test_remote_runner_options_raise(set_option, read):
    """Options that only size remote runners (refused while the port had
    none, whence the name) are kept now, as ray_tpu keeps them."""
    assert getattr(set_option(tppo.PPOConfig()), read) in (2.0, 4)


@pytest.mark.parametrize("kl_target,updates", [(None, 6), (1e9, 6), (-1.0, 2)])
def test_ppo_kl_target_stops_the_epochs(kl_target, updates):
    """kl_target unset or never passed: every epoch runs (3 of 2
    minibatches); passed after the first epoch: the other two are
    skipped."""
    cfg = (tppo.PPOConfig().environment("CartPole-v1").learners(device="cpu")
           .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
           .training(train_batch_size=32, minibatch_size=16, num_epochs=3,
                     kl_target=kl_target))
    algo = cfg.build()
    learner = algo.learner_group.local
    real, seen = learner.update, []

    def update(batch):
        out = real(batch)
        seen.append(out["mean_kl"])
        return out

    learner.update = update
    metrics = algo.train()
    assert len(seen) == updates
    assert metrics["mean_kl"] == seen[-1]
