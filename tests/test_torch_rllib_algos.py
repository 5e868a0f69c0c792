"""ray_tpu_torch.rllib's algorithms against ray_tpu.rllib's on the CPU,
end to end on gymnasium's environments: PPO's ``train()`` for two
iterations on CartPole-v1 at the default widths (8 envs, 64-step
fragments, batch 512, 4 epochs of 128-row minibatches, hidden (64, 64)),
DQN for one iteration past ``learning_starts`` on CartPole-v1, and SAC
past ``learning_starts`` on Pendulum-v1 with ray_tpu's noise fed to the
port (``SAC._draw_noise``).

Both packages start from the JAX algorithm's weights and the same seed.
Sampled observations and actions must be identical (for discrete
actions after checking each sampled action's margin: the Gumbel or
epsilon-greedy argmax of f32 values that differ by ~1e-7 between the
packages; SAC's continuous actions and the Pendulum observations and
rewards they lead to within 1e-5, relative and absolute). Parameters afterwards within 1e-4 of the larger of
each leaf's largest |value| and the learning rate (a bias that starts at
0 can end as a cancellation of steps of up to lr).
"""

import jax
import numpy as np

from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu_torch.ops import tree as ttree
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.core import rl_module as tmod
from torch_rllib_helpers import leaves_close, record, top2_gap

MARGIN = 1e-4  # the least top-2 gap of a sampled argmax that the test trusts


def test_ppo_two_iterations_match_reference():
    """PPO at its defaults: the same observations and actions in both
    iterations (every Gumbel argmax decided by more than MARGIN), the
    same metrics and parameters after each."""
    seed = 0
    jalgo = jppo.PPOConfig().environment("CartPole-v1").debugging(seed=seed).build()
    talgo = (tppo.PPOConfig().environment("CartPole-v1").learners(device="cpu")
             .debugging(seed=seed).build())
    talgo.learner_group.set_weights(jalgo.learner_group.get_weights())
    jseen, tseen = record(jalgo), record(talgo)
    cfg = jalgo.algo_config
    gumbel = np.random.default_rng(seed)  # the runner's draws, in order
    for it in range(2):
        want, got = jalgo.train(), talgo.train()
        for key in ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
        assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"] == 512
        jb, tb = jseen[it], tseen[it]
        logits = jb["behavior_logits"].reshape(cfg.rollout_fragment_length,
                                               cfg.num_envs_per_env_runner, -1)
        noise = np.stack([gumbel.gumbel(size=logits.shape[1:]).astype(np.float32)
                          for _ in range(cfg.rollout_fragment_length)])
        assert top2_gap(logits + noise).min() > MARGIN, it
        np.testing.assert_array_equal(tb["obs"], jb["obs"])
        np.testing.assert_array_equal(tb["actions"], jb["actions"])
        np.testing.assert_array_equal(tb["rewards"], jb["rewards"])
        np.testing.assert_allclose(tb["behavior_logits"], jb["behavior_logits"], atol=1e-5)
        leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, cfg.lr)
    assert talgo.iteration == jalgo.iteration == 2


def test_dqn_iteration_past_learning_starts_matches_reference():
    """DQN with learning_starts = one iteration's rows: epsilon-greedy
    actions (every greedy one decided by more than MARGIN), the replay
    minibatches, 8 double-Q updates and the target sync as ray_tpu's."""
    seed = 1
    kw = dict(learning_starts=512, num_gradient_steps=8, target_network_update_freq=512)
    jalgo = jdqn.DQNConfig().environment("CartPole-v1").training(**kw).debugging(seed=seed).build()
    talgo = (tdqn.DQNConfig().environment("CartPole-v1").training(**kw).learners(device="cpu")
             .debugging(seed=seed).build())
    w0 = jalgo.learner_group.get_weights()
    talgo.learner_group.set_weights(w0)
    talgo.target_weights = talgo._on_device(w0)
    jseen, tseen = record(jalgo), record(talgo)
    want, got = jalgo.train(), talgo.train()
    jb, tb = jseen[0], tseen[0]
    # The greedy rows: the runner's draws are (integers, random) a step.
    cfg, rng = jalgo.algo_config, np.random.default_rng(seed)
    B, eps_steps = cfg.num_envs_per_env_runner, cfg.epsilon_timesteps
    jq = cfg.rl_module_spec().build()
    jq.set_weights(w0)
    q = jq.forward_inference(jb["obs"])["q_values"]
    greedy = []
    for t in range(cfg.rollout_fragment_length):
        rng.integers(0, q.shape[-1], size=B)
        eps = 1.0 + min(1.0, t * B / eps_steps) * (0.05 - 1.0)
        greedy.append(rng.random(B) >= eps)
    greedy = np.concatenate(greedy)
    assert greedy.any() and top2_gap(q[greedy]).min() > MARGIN
    np.testing.assert_array_equal(tb["obs"], jb["obs"])
    np.testing.assert_array_equal(tb["actions"], jb["actions"])
    for key in ("qf_loss", "qf_mean", "td_error_abs", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert got["num_env_steps_sampled"] == want["num_env_steps_sampled"] == 512
    leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, cfg.lr)
    leaves_close(ttree.tree_map(lambda t: t.numpy(), talgo.target_weights),
                  jax.device_get(jalgo.target_weights), 1e-4, cfg.lr)


class JaxSACNoise:
    """The draws ray_tpu's SAC makes from its key each gradient step (the
    TD targets' from kt, the loss's from the first half of ku), as
    ``SAC._draw_noise`` returns them."""

    def __init__(self, seed, action_dim):
        self.key, self.d = jax.random.PRNGKey(seed), action_dim

    def __call__(self, batch_size):
        self.key, kt, ku = jax.random.split(self.key, 3)
        k1, _ = jax.random.split(ku)
        shape = (batch_size, self.d)
        return (np.asarray(jax.random.normal(kt, shape)),
                {"noise_pi": np.asarray(jax.random.normal(k1, shape))})


def test_sac_past_learning_starts_matches_reference_with_the_jax_noise():
    """SAC on Pendulum-v1: one iteration to fill the buffer, one with 4
    gradient steps (TD targets, the summed loss, polyak targets); the
    port draws ray_tpu's noise."""
    seed = 2
    kw = dict(learning_starts=512, num_gradient_steps=4)
    jalgo = jsac.SACConfig().environment("Pendulum-v1").training(**kw).debugging(seed=seed).build()
    talgo = (tsac.SACConfig().environment("Pendulum-v1").training(**kw).learners(device="cpu")
             .debugging(seed=seed).build())
    w0 = jalgo.learner_group.get_weights()
    talgo.learner_group.set_weights(w0)
    talgo.target_q = ttree.tree_map(lambda a: tmod.to_tensor(a, "cpu"),
                                   {"q1": w0["q1"], "q2": w0["q2"]})
    talgo._draw_noise = JaxSACNoise(seed, jalgo.algo_config.action_dim)
    jseen, tseen = record(jalgo), record(talgo)
    for _ in range(2):
        want, got = jalgo.train(), talgo.train()
    for jb, tb in zip(jseen, tseen):
        for key in ("obs", "actions", "rewards", "next_obs"):
            np.testing.assert_allclose(tb[key], jb[key], rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("critic_loss", "actor_loss", "alpha_loss", "alpha", "entropy", "q1_mean"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)
    lr = jalgo.algo_config.lr
    leaves_close(talgo.get_weights(), jalgo.get_weights(), 1e-4, lr)
    leaves_close(ttree.tree_map(lambda t: t.numpy(), talgo.target_q),
                  jax.device_get(jalgo.target_q), 1e-4, lr)
