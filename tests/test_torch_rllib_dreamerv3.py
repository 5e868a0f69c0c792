"""ray_tpu_torch's DreamerV3 against ray_tpu's on the CPU: the symlog,
twohot, GRU and categorical helpers, the world-model loss, imagination,
the actor-critic loss and their gradients, one whole update, a
``train()`` iteration, a checkpoint and the options it refuses.

At ray_tpu's test config (tests/test_rllib_dreamerv3.py), with the JAX
module's weights and jax.random's own Gumbel draws fed to the port: the
reference's ``wm_loss``, ``imagine``, ``lambda_returns`` and
``ac_loss`` are closures of its update, reached through
``inspect.getclosurevars``; ``jax.random.categorical(key, lg)`` is the
argmax of ``lg + jax.random.gumbel(key, lg.shape)``, so replaying the
update's key splits gives the port the same noise. Every categorical
argmax is checked to be decided by more than MARGIN. Limits: helpers
1e-6; losses, their terms and gradients 1e-5 (of each gradient leaf's
largest |value|); parameters after one update 1e-4 of each leaf's
largest |value|, after an iteration 1e-4 of the larger of that and
the learning rate.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms import dreamerv3 as jd
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.ops import tree as ttree
from ray_tpu_torch.rllib.algorithms import dreamerv3 as td
from torch_rllib_helpers import leaves_close, top2_gap

MARGIN = 1e-4
TOL = 1e-5
SMALL = dict(hidden=32, deter=32, stoch=4, classes=4, batch_size_B=4, batch_length_T=8,
             horizon_H=5, learning_starts=64, training_ratio=4, num_bins=31)


def _config(pkg, **training):
    cfg = (pkg.DreamerV3Config().environment(env="CartPole-v1")
           .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=16)
           .training(**{**SMALL, **training}).debugging(seed=0))
    if pkg is td:
        cfg.learners(device="cpu")
    return cfg


@pytest.fixture(scope="module")
def algos():
    """(JAX DreamerV3, the port's with its weights), untrained."""
    jalgo, talgo = _config(jd).build(), _config(td).build()
    talgo.module.set_weights(params_from_jax(jax.device_get(jalgo.module.params), "cpu"))
    yield jalgo, talgo
    jalgo.cleanup()
    talgo.cleanup()


@pytest.fixture
def margins(monkeypatch):
    """The least top-2 gap of every categorical argmax the port takes
    (latents and imagined actions, and the runner's actions)."""
    gaps = []
    real_argmax, real_actions = td._gumbel_argmax, td.gumbel_sample_logits

    def argmax(logits, gumbel):
        gaps.append(top2_gap((logits + gumbel).detach().numpy()).min())
        return real_argmax(logits, gumbel)

    def actions(logits, rng):
        noise = copy.deepcopy(rng).gumbel(size=logits.shape).astype(np.float32)
        gaps.append(top2_gap(logits + noise).min())
        return real_actions(logits, rng)

    monkeypatch.setattr(td, "_gumbel_argmax", argmax)
    monkeypatch.setattr(td, "gumbel_sample_logits", actions)
    return gaps


def _closures(jalgo):
    update = inspect.getclosurevars(jalgo._update.__wrapped__).nonlocals
    ac = inspect.getclosurevars(update["ac_loss"]).nonlocals
    return update["wm_loss"], ac["imagine"], ac["lambda_returns"], update["ac_loss"]


def _batch(seed, cfg):
    rng = np.random.default_rng(seed)
    B, T = cfg.batch_size_B, cfg.batch_length_T
    first = rng.random((B, T)) < 0.15
    first[:, 0] = True
    return {"obs": rng.standard_normal((B, T, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, (B, T)).astype(np.int64),
            "rewards": rng.uniform(0.0, 2.0, (B, T)).astype(np.float32),
            "terminateds": rng.random((B, T)) < 0.1,
            "is_first": first}


def _wm_noise(key, cfg):
    """The Gumbel draws of wm_loss's categorical samples from ``key``."""
    out = []
    for _ in range(cfg.batch_length_T):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(
            k, (cfg.batch_size_B, cfg.stoch, cfg.classes), jnp.float32)))
    return np.stack(out)


def _imagine_noise(key, cfg, action_dim=2):
    """The Gumbel draws of imagine's actions and latents from ``key``."""
    N = cfg.batch_size_B * cfg.batch_length_T
    act, z = [], []
    for _ in range(cfg.horizon_H):
        key, ka, kz = jax.random.split(key, 3)
        act.append(np.asarray(jax.random.gumbel(ka, (N, action_dim), jnp.float32)))
        z.append(np.asarray(jax.random.gumbel(kz, (N, cfg.stoch, cfg.classes), jnp.float32)))
    return np.stack(act), np.stack(z)


def _update_noise(key, cfg):
    k1, k2 = jax.random.split(key)
    act, z = _imagine_noise(k2, cfg)
    return {"wm": _wm_noise(k1, cfg), "act": act, "z": z}


def _live(tree):
    return ttree.tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(True), tree)


def _grads(loss, live):
    flat = ttree.flatten(live)
    return dict(zip(flat, (g.numpy() for g in torch.autograd.grad(loss, list(flat.values()),
                                                                    retain_graph=True))))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol * 1e-2)


def test_helpers_match_reference():
    rng = np.random.default_rng(0)
    x = np.array([-30.0, -1.0, 0.0, 0.5, 12.0, 19.99, -25.0], np.float32)
    bins = np.linspace(-20.0, 20.0, 31).astype(np.float32)
    for fn in ("symlog", "symexp"):
        np.testing.assert_allclose(getattr(td, fn)(torch.tensor(x / 10)).numpy(),
                                   getattr(jd, fn)(jnp.asarray(x / 10)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.twohot(torch.tensor(x), torch.tensor(bins)).numpy(),
                               jd.twohot(jnp.asarray(x), jnp.asarray(bins)), atol=1e-6)
    # jnp.linspace takes start·(1 − s) + stop·s: near 0 its bins are off
    # by up to an ulp of 20 (1.9e-6); torch.linspace's are not.
    np.testing.assert_allclose(td._bins(td.DreamerV3Config()).numpy(),
                               jd._bins(jd.DreamerV3Config()), rtol=0, atol=2 * 2.0 ** -19)
    logits = rng.standard_normal((5, 31)).astype(np.float32)
    np.testing.assert_allclose(td.twohot_mean(torch.tensor(logits), torch.tensor(bins)).numpy(),
                               jd.twohot_mean(jnp.asarray(logits), jnp.asarray(bins)),
                               rtol=1e-6, atol=1e-6)
    gru = jax.device_get(jd._gru_init(jax.random.PRNGKey(1), 10, 8))
    gru["b"] = rng.standard_normal(24).astype(np.float32)
    h, inp = rng.standard_normal((3, 8)).astype(np.float32), rng.standard_normal(
        (3, 10)).astype(np.float32)
    np.testing.assert_allclose(
        td._gru(ttree.tree_map(torch.tensor, gru), torch.tensor(h), torch.tensor(inp)).numpy(),
        jd._gru(gru, jnp.asarray(h), jnp.asarray(inp)), rtol=1e-6, atol=1e-6)
    cfg = jd.DreamerV3Config().training(stoch=4, classes=4)
    a, b = (rng.standard_normal((3, 4, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(td._kl_categorical(torch.tensor(a), torch.tensor(b)).numpy(),
                               jd._kl_categorical(jnp.asarray(a), jnp.asarray(b)),
                               rtol=1e-6, atol=1e-6)
    flat = rng.standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_array_equal(td._categorical_mode(torch.tensor(flat), cfg).numpy(),
                                  jd._categorical_mode(jnp.asarray(flat), cfg))
    # The module's forward and its initial EMA critic.
    params = td.DreamerV3Config().learners(device="cpu").environment(
        observation_dim=4, action_dim=2).rl_module_spec().build(seed=3).params
    assert all(torch.equal(a, b) for a, b in zip(ttree.tree_leaves(params["critic"]),
                                                  ttree.tree_leaves(params["critic_ema"])))


def test_world_model_loss_and_gradients_match_reference(algos, margins):
    jalgo, talgo = algos
    wm_loss = _closures(jalgo)[0]
    cfg = jalgo.algo_config
    batch, key = _batch(1, cfg), jax.random.PRNGKey(11)
    wm = {k: jalgo.module.params[k] for k in td.WM_KEYS}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(wm_loss, has_aux=True))(
        wm, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    live = _live(jax.device_get(wm))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    loss, aux = talgo.wm_loss(live, tb, torch.tensor(_wm_noise(key, cfg)))
    assert min(margins) > MARGIN
    _close(loss.item(), jloss)
    for k in ("recon_loss", "reward_loss", "continue_loss", "kl_dyn", "kl_rep"):
        _close(aux[k].item(), jaux[k])
    np.testing.assert_allclose(aux["feat"].detach().numpy(), jaux["feat"], atol=TOL)
    leaves_close(_grads(loss, live), jax.device_get(jgrads), TOL, 1e-12)


def test_imagination_and_actor_critic_loss_match_reference(algos, margins):
    jalgo, talgo = algos
    wm_loss, imagine, lambda_returns, ac_loss = _closures(jalgo)
    cfg = jalgo.algo_config
    params = jalgo.module.params
    batch = {k: jnp.asarray(v) for k, v in _batch(2, cfg).items()}
    feat0 = jax.jit(wm_loss)({k: params[k] for k in td.WM_KEYS}, batch,
                             jax.random.PRNGKey(3))[1]["feat"]
    frozen = {k: v for k, v in params.items() if k not in ("actor", "critic")}
    key, pcts = jax.random.PRNGKey(5), jnp.asarray([-0.5, 2.0], jnp.float32)
    act_g, z_g = (torch.tensor(a) for a in _imagine_noise(key, cfg))
    tfrozen = params_from_jax(jax.device_get(frozen), "cpu")
    tfeat0 = torch.tensor(np.asarray(feat0))

    # Imagination: the same actions, states, rewards and continues.
    want = jax.jit(imagine)(frozen, params["actor"], feat0, key)
    got = talgo.imagine(tfrozen, params_from_jax(jax.device_get(params["actor"]), "cpu"),
                        tfeat0, act_g, z_g)
    assert min(margins) > MARGIN
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    values = np.random.default_rng(0).standard_normal(
        (cfg.horizon_H + 1, want[3].shape[1])).astype(np.float32)
    np.testing.assert_allclose(
        talgo.lambda_returns(torch.tensor(np.asarray(want[3])), torch.tensor(np.asarray(want[4])),
                             torch.tensor(values)).numpy(),
        jax.jit(lambda_returns)(want[3], want[4], jnp.asarray(values)), rtol=TOL, atol=TOL)

    # The actor-critic loss and both gradients.
    (jtotal, jaux), (ga, gc) = jax.jit(jax.value_and_grad(ac_loss, argnums=(0, 1),
                                                          has_aux=True))(
        params["actor"], params["critic"], frozen, feat0, key, pcts)
    a_live, c_live = _live(jax.device_get(params["actor"])), _live(
        jax.device_get(params["critic"]))
    total, aux = talgo.ac_loss(a_live, c_live, tfrozen, tfeat0, act_g, z_g,
                               torch.tensor(np.asarray(pcts)))
    _close(total.item(), jtotal)
    for k in ("actor_loss", "critic_loss", "dream_return_mean", "actor_entropy"):
        _close(aux[k].item(), jaux[k])
    np.testing.assert_allclose(aux["pcts"].numpy(), jaux["pcts"], rtol=TOL, atol=TOL)
    leaves_close(_grads(total, a_live), jax.device_get(ga), TOL, 1e-12)
    leaves_close(_grads(total, c_live), jax.device_get(gc), TOL, 1e-12)


def test_one_update_matches_reference(margins):
    """The whole update (world model, actor, critic, EMA critic and
    percentiles) from the same state, batch and draws."""
    jalgo, talgo = _config(jd).build(), _config(td).build()
    talgo.module.set_weights(params_from_jax(jax.device_get(jalgo.module.params), "cpu"))
    cfg = jalgo.algo_config
    batch, key = _batch(4, cfg), jax.random.PRNGKey(9)
    fresh = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the update donates)
    params, *_, pcts, metrics = jalgo._update(
        fresh(jalgo.module.params), fresh(jalgo._wm_state), fresh(jalgo._actor_state),
        fresh(jalgo._critic_state), {k: jnp.asarray(v) for k, v in batch.items()}, key,
        fresh(jalgo._ret_percentiles))
    got = talgo._update(batch, _update_noise(key, cfg))
    assert min(margins) > MARGIN
    leaves_close(talgo.module.get_weights(), jax.device_get(params), 1e-4, 1e-12)
    for k, v in metrics.items():
        _close(got[k].item(), v, 1e-4)
    np.testing.assert_allclose(talgo._ret_percentiles.numpy(), pcts, rtol=1e-4, atol=1e-6)
    jalgo.cleanup()
    talgo.cleanup()


def test_iteration_matches_reference(margins):
    """One train() (64 env rows, then 8 updates), the port drawing the
    noise of ray_tpu's key splits: the same replay, metrics and
    parameters."""
    jalgo, talgo = _config(jd).build(), _config(td).build()
    talgo.module.set_weights(params_from_jax(jax.device_get(jalgo.module.params), "cpu"))
    cfg = jalgo.algo_config
    keys = {"key": jax.random.PRNGKey(cfg.seed)}  # ray_tpu's self._key, split the same way

    def draw_noise():
        keys["key"], k = jax.random.split(keys["key"])
        return _update_noise(k, cfg)

    talgo._draw_noise = draw_noise
    want, got = jalgo.train(), talgo.train()
    assert min(margins) > MARGIN
    assert got["num_updates"] == want["num_updates"] == 8
    assert got["replay_rows"] == want["replay_rows"] == 64
    for k in ("wm_loss", "recon_loss", "actor_loss", "critic_loss", "dream_return_mean"):
        assert np.isfinite(got[k])
        _close(got[k], want[k], 1e-4)
    leaves_close(talgo.module.get_weights(), jax.device_get(jalgo.module.params), 1e-4,
                 cfg.actor_lr)
    jalgo.cleanup()
    talgo.cleanup()


def test_checkpoint_round_trip(tmp_path):
    """A restored DreamerV3 (parameters, the three Adam states, the
    percentiles and the noise generator) gives the original's next update
    bit for bit."""
    algo = _config(td).build()
    for _ in range(2):
        algo.train()
    path = algo.save(str(tmp_path))
    restored = _config(td).build()
    restored.restore(path)
    assert restored.iteration == algo.iteration == 2
    batch = _batch(6, algo.algo_config)
    for a in (algo, restored):
        a._update(batch, a._draw_noise())
    want = ttree.flatten(algo.get_extra_state())
    got = ttree.flatten(restored.get_extra_state())
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    algo.cleanup()
    restored.cleanup()


def test_refused_options():
    """num_learners > 0 raises ray_tpu's ValueError; so does a learner
    mesh, which ray_tpu would accept and not use (any mesh: the check
    comes before it is read)."""
    with pytest.raises(ValueError, match="locally"):
        _config(td).learners(num_learners=2).build()
    with pytest.raises(ValueError, match="locally"):
        _config(jd).learners(num_learners=2).build()
    with pytest.raises(ValueError, match="no learner mesh"):
        _config(td).learners(mesh=object()).build()
