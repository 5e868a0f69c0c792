"""ray_tpu_torch.rllib's pieces against ray_tpu.rllib's on the CPU: GAE,
V-trace, the connectors' running statistics and their merge, the replay
buffer, the Gumbel sampler, the modules' forward, every algorithm's loss
and its gradients on one batch, and learner updates (Adam with global-norm
clipping).

Inputs are made with numpy from a seed; the port's modules take the JAX
modules' weights (jax.random and torch draw different inits). Where a
loss draws noise (SAC, CQL), the port is fed the draws of the JAX key the
reference's loss splits. Limits: losses, metrics and gradients within
1e-5 (relative, or of each gradient leaf's largest |value|); parameters
after learner updates within 1e-5 of the larger of each leaf's largest
|value| and the learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import replay_buffer as jreplay
from ray_tpu.rllib.algorithms import appo as jappo
from ray_tpu.rllib.algorithms import bc as jbc
from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.algorithms import ppo as jppo
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.core import learner as jlearner
from ray_tpu.rllib.core import rl_module as jmod
from ray_tpu.rllib.env import env_runner as jrunner
from ray_tpu.rllib.sample_batch import SampleBatch as JBatch
from ray_tpu.rllib.sample_batch import compute_gae as jgae
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.ops import tree as ttree
from ray_tpu_torch.rllib import connectors as tconn
from ray_tpu_torch.rllib import replay_buffer as treplay
from ray_tpu_torch.rllib.algorithms import appo as tappo
from ray_tpu_torch.rllib.algorithms import bc as tbc
from ray_tpu_torch.rllib.algorithms import cql as tcql
from ray_tpu_torch.rllib.algorithms import dqn as tdqn
from ray_tpu_torch.rllib.algorithms import impala as timpala
from ray_tpu_torch.rllib.algorithms import marwil as tmarwil
from ray_tpu_torch.rllib.algorithms import ppo as tppo
from ray_tpu_torch.rllib.algorithms import sac as tsac
from ray_tpu_torch.rllib.core import learner as tlearner
from ray_tpu_torch.rllib.core import rl_module as tmod
from ray_tpu_torch.rllib.env import env_runner as trunner
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.sample_batch import compute_gae as tgae
from torch_rllib_helpers import cql_noise

OBS_DIM, N_ACT, ACT_DIM = 4, 3, 2
TOL = 1e-5


def _batch(seed, n, *, continuous=False, obs_dim=OBS_DIM):
    rng = np.random.default_rng(seed)
    b = {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
         "rewards": rng.standard_normal(n).astype(np.float32),
         "terminateds": rng.random(n) < 0.1,
         "truncateds": rng.random(n) < 0.05,
         "action_logp": (np.log(1.0 / N_ACT) + 0.3 * rng.standard_normal(n)).astype(np.float32),
         "advantages": rng.standard_normal(n).astype(np.float32),
         "value_targets": rng.standard_normal(n).astype(np.float32),
         "behavior_logits": rng.standard_normal((n, N_ACT)).astype(np.float32),
         "td_targets": rng.standard_normal(n).astype(np.float32),
         "mc_returns": (3 * rng.standard_normal(n)).astype(np.float32)}
    if continuous:
        b["actions"] = rng.uniform(-2.0, 2.0, (n, ACT_DIM)).astype(np.float32)
    else:
        b["actions"] = rng.integers(0, N_ACT, n).astype(np.int64)
    return b


def _modules(*, obs_dim=OBS_DIM, act_dim=N_ACT, hidden=(16, 16), jcls=None,
             tcls=None):
    """(JAX module, port module on the CPU holding the JAX weights)."""
    jm = jmod.RLModuleSpec(obs_dim, act_dim, hidden, module_class=jcls).build(seed=3)
    tm = tmod.RLModuleSpec(obs_dim, act_dim, hidden, module_class=tcls, device="cpu").build()
    tm.set_weights(params_from_jax(jax.device_get(jm.params), "cpu"))
    return jm, tm


def _jax_loss(loss_fn, jm, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=1)
    (loss, metrics), grads = fn(jm.params, jm.apply, jb)
    return float(loss), {k: float(v) for k, v in metrics.items()}, jax.device_get(grads)


def _torch_loss(loss_fn, tm, batch):
    live = ttree.tree_map(lambda t: t.detach().clone().requires_grad_(True), tm.params)
    tb = {k: tmod.to_tensor(v, "cpu") for k, v in batch.items()}
    loss, metrics = loss_fn(live, tm.apply, tb)
    leaves = list(ttree.flatten(live).values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = {k: (torch.zeros_like(p) if g is None else g).numpy()
             for (k, p), g in zip(ttree.flatten(live).items(), grads)}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def _assert_leaves_close(got: dict, want_tree, tol=TOL, what="", floor=1e-12):
    """Each leaf within ``tol`` of the larger of its largest |value| and
    ``floor``."""
    want = ttree.flatten(want_tree)
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, (what, k)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), floor),
                                   err_msg=f"{what} {k}")


def _assert_loss_matches(jfn, tfn, jm, tm, jbatch, tbatch=None):
    jl, jmet, jg = _jax_loss(jfn, jm, jbatch)
    tl, tmet, tg = _torch_loss(tfn, tm, tbatch if tbatch is not None else jbatch)
    assert tmet.keys() == jmet.keys()
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=1e-6)
    for k in jmet:
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=TOL, atol=1e-6, err_msg=k)
    _assert_leaves_close(tg, jg, what="gradient")


# -- numpy pieces ---------------------------------------------------------------

def test_compute_gae_matches_reference():
    b = _batch(0, 8 * 16)
    shape = lambda a: a.reshape(16, 8)  # noqa: E731
    nv = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    args = [shape(b["rewards"]), shape(b["value_targets"]), nv, shape(b["terminateds"]),
            shape(b["truncateds"]), 0.97, 0.9]
    for got, want in zip(tgae(*args), jgae(*args)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.5, 2.0)])
def test_vtrace_matches_reference(clip):
    rng = np.random.default_rng(2)
    T, B = 12, 5
    args = [rng.standard_normal((T, B)).astype(np.float32) * s for s in (0.5, 0.5, 1, 1, 1)]
    args += [(rng.random((T, B)) < 0.15).astype(np.float32),
             (rng.random((T, B)) < 0.1).astype(np.float32)]
    want = jimpala.vtrace(*map(jnp.asarray, args), 0.95, *clip)
    got = timpala.vtrace(*map(torch.from_numpy, args), 0.95, *clip)
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=1e-6)


def test_normalizer_states_and_their_merge_match_reference():
    """Three runners' running normalizers fed the same blocks: outputs,
    harvested states and the position-wise pipeline merge are ray_tpu's."""
    rng = np.random.default_rng(3)
    blocks = [[rng.standard_normal((6, 3)).astype(np.float32) * (r + 1) + r for _ in range(3)]
              for r in range(3)]
    states = []
    for mod in (jconn, tconn):
        per = []
        for r in range(3):
            pipe = mod.build_pipeline([mod.NormalizeObservations(clip=2.0),
                                       mod.LambdaConnector(lambda x: x * 2)])
            outs = [pipe(b) for b in blocks[r]]
            per.append((outs, pipe.get_state()))
        merged, mask = mod.merge_pipeline_states([s for _, s in per])
        states.append((per, merged, mask))
    (jper, jmerged, jmask), (tper, tmerged, tmask) = states
    assert tmask == jmask == [True, True]
    for (jo, js), (to, ts) in zip(jper, tper):
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(a, b)
        assert ts[1] is js[1] is None
    for key in ("count", "mean", "m2"):
        np.testing.assert_allclose(tmerged[0][key], jmerged[0][key], rtol=1e-12)
    # The merged state, set on a fresh pipeline, normalizes alike.
    outs = []
    for mod, merged in ((jconn, jmerged), (tconn, tmerged)):
        n = mod.NormalizeObservations()
        n.set_state(merged[0])
        outs.append(n(blocks[0][0], update=False))
    np.testing.assert_array_equal(outs[1], outs[0])
    clip = {"rewards": np.array([-3.0, 0.5, 2.0], np.float32)}
    np.testing.assert_array_equal(tconn.ClipRewards()(dict(clip))["rewards"],
                                  jconn.ClipRewards()(dict(clip))["rewards"])


def test_replay_buffer_samples_match_reference():
    bufs = [jreplay.ReplayBuffer(50, seed=4), treplay.ReplayBuffer(50, seed=4)]
    for i in range(4):
        b = _batch(10 + i, 20)
        for buf, cls in zip(bufs, (JBatch, SampleBatch)):
            buf.add(cls(b))
    j, t = bufs[0].sample(32), bufs[1].sample(32)
    assert len(bufs[1]) == len(bufs[0]) == 50
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


def test_gumbel_sampling_matches_reference():
    logits = np.random.default_rng(5).standard_normal((64, N_ACT)).astype(np.float32)
    ja, jl = jrunner.gumbel_sample_logits(logits, np.random.default_rng(6))
    ta, tl = trunner.gumbel_sample_logits(logits, np.random.default_rng(6))
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tl, jl)


def test_module_forward_matches_reference():
    """The actor-critic module and DQN's Q module on carried weights."""
    obs = np.random.default_rng(7).standard_normal((32, OBS_DIM)).astype(np.float32)
    for jcls, tcls in ((None, None), (jdqn.QModule, tdqn.QModule)):
        jm, tm = _modules(jcls=jcls, tcls=tcls)
        want, got = jm.forward_inference(obs), tm.forward_inference(obs)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=1e-6, err_msg=k)


def test_params_from_jax_carries_lists():
    jm, tm = _modules()
    assert isinstance(tm.params["torso"], list) and len(tm.params["torso"]) == 2
    for k, v in ttree.flatten(jax.device_get(jm.params)).items():
        assert np.array_equal(ttree.flatten(tm.params)[k].numpy(), v)
    assert params_from_jax((np.ones(2),), "cpu")[0].tolist() == [1.0, 1.0]


# -- losses on one batch -------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"entropy_coeff": 0.01, "vf_clip_param": 0.5}])
def test_ppo_loss_matches_reference(kw):
    jcfg, tcfg = jppo.PPOConfig().training(**kw), tppo.PPOConfig().training(**kw)
    jm, tm = _modules()
    _assert_loss_matches(jppo.make_ppo_loss(jcfg), tppo.make_ppo_loss(tcfg), jm, tm,
                         _batch(20, 128))


def test_dqn_loss_matches_reference():
    jm, tm = _modules(jcls=jdqn.QModule, tcls=tdqn.QModule)
    b = _batch(21, 64)
    b["td_targets"] = b["td_targets"] * 3  # beyond Huber's quadratic zone too
    _assert_loss_matches(jdqn.make_dqn_loss(), tdqn.make_dqn_loss(), jm, tm, b)


def test_bc_and_marwil_losses_match_reference():
    jm, tm = _modules()
    b = _batch(22, 96)
    _assert_loss_matches(jbc.make_bc_loss(), tbc.make_bc_loss(), jm, tm, b)
    for beta in (1.0, 0.0):
        jcfg, tcfg = jmarwil.MARWILConfig(), tmarwil.MARWILConfig()
        jcfg.beta = tcfg.beta = beta
        mb = dict(b, ma_adv_norm=np.float32(1.7))
        _assert_loss_matches(jmarwil.make_marwil_loss(jcfg), tmarwil.make_marwil_loss(tcfg),
                             jm, tm, mb)


def test_attach_mc_returns_matches_reference():
    b = _batch(23, 40)
    want = jmarwil.attach_mc_returns(JBatch(b), 0.9)["mc_returns"]
    got = tmarwil.attach_mc_returns(SampleBatch(b), 0.9)["mc_returns"]
    np.testing.assert_allclose(got, want, rtol=TOL)


@pytest.mark.parametrize("appo", [False, True])
def test_impala_and_appo_losses_match_reference(appo):
    T, B = 8, 4
    jm, tm = _modules()
    jcfg = (jappo.APPOConfig() if appo else jimpala.IMPALAConfig())
    tcfg = (tappo.APPOConfig() if appo else timpala.IMPALAConfig())
    jfn = (jappo.make_appo_loss if appo else jimpala.make_impala_loss)(jcfg, T)
    tfn = (tappo.make_appo_loss if appo else timpala.make_impala_loss)(tcfg, T)
    _assert_loss_matches(jfn, tfn, jm, tm, _batch(24, T * B))


def _sac_modules(center, half, alpha=0.7):
    jcls = jsac._sac_module_factory(alpha, center, half)
    tcls = tsac._sac_module_factory(alpha, center, half)
    return _modules(obs_dim=3, act_dim=ACT_DIM, jcls=jcls, tcls=tcls)


def test_sac_loss_matches_reference_with_the_jax_noise():
    center, half = jsac._action_affine(np.full(ACT_DIM, -2.0), np.array([2.0, 1.0]))
    jm, tm = _sac_modules(center, half)
    cfg = jsac.SACConfig()
    key = jax.random.PRNGKey(8)
    b = _batch(25, 48, continuous=True, obs_dim=3)
    k1, _ = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k1, (48, ACT_DIM)))
    _assert_loss_matches(jsac.make_sac_loss(cfg, center, half, -2.0),
                         tsac.make_sac_loss(tsac.SACConfig(), center, half, -2.0), jm, tm,
                         dict(b, rng=np.asarray(key)), dict(b, noise_pi=noise))


@pytest.mark.parametrize("use_bc", [1.0, 0.0])
def test_cql_loss_matches_reference_with_the_jax_noise(use_bc):
    center, half = 0.0, 1.0
    jm, tm = _sac_modules(center, half)
    jcfg, tcfg = jcql.CQLConfig(), tcql.CQLConfig()
    key = jax.random.PRNGKey(9)
    B = 32
    b = _batch(26, B, continuous=True, obs_dim=3)
    b["actions"] = np.clip(b["actions"], -0.99, 0.99)
    b["use_bc"] = np.float32(use_bc)
    _assert_loss_matches(jcql.make_cql_loss(jcfg, center, half, -2.0),
                         tcql.make_cql_loss(tcfg, center, half, -2.0), jm, tm,
                         dict(b, rng=np.asarray(key)),
                         dict(b, **cql_noise(key, B, ACT_DIM, jcfg.num_actions)))


# -- learner updates -------------------------------------------------------------

@pytest.mark.parametrize("grad_clip", [0.5, None])
def test_learner_updates_match_reference(grad_clip):
    """Three PPO updates (Adam, with and without global-norm clipping):
    parameters, metrics and the Adam moments' count as ray_tpu's. Each
    parameter leaf within 1e-5 of the larger of its largest |value| and
    the learning rate: Adam moves an element by up to lr a step, and a
    bias that starts at 0 can end as a cancellation of such steps (one
    ended at 4e-6 after three steps of 3e-4)."""
    jcfg, tcfg = jppo.PPOConfig(), tppo.PPOConfig()
    jcfg.grad_clip = tcfg.grad_clip = grad_clip
    jm, tm = _modules()
    jl = jlearner.JaxLearner(jm, jppo.make_ppo_loss(jcfg), jlearner.make_optimizer(jcfg))
    tl = tlearner.TorchLearner(tm, tppo.make_ppo_loss(tcfg), tlearner.make_optimizer(tcfg))
    for i in range(3):
        b = _batch(30 + i, 128)
        want, got = jl.update(JBatch(b)), tl.update(SampleBatch(b))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=1e-6, err_msg=k)
    if grad_clip is not None:
        assert want["grad_norm"] > grad_clip  # the clip took part
    got = {k: v.numpy() for k, v in ttree.flatten(tm.params).items()}
    _assert_leaves_close(got, jax.device_get(jm.params), what="params", floor=jcfg.lr)
    state = tl.get_state()
    tl.set_state(state)
    adam = state["opt_state"][-1][0] if grad_clip is not None else state["opt_state"][0]
    assert int(adam.count) == 3
