"""DreamerV3: model-based RL via imagination in a learned world model
(port of ray_tpu/rllib/algorithms/dreamerv3.py).

Counterpart of the reference's DreamerV3 (rllib/algorithms/dreamerv3/ —
world-model RSSM + actor/critic trained on dreamed trajectories, with
DreamerV3Learner orchestrating the three losses). One update trains the
world model, then the actor and the critic on imagined rollouts, each
with its own optimizer (the optax-style chains of ``ops/optim.py``):

- RSSM with grouped categorical stochastic latents (``stoch`` groups x
  ``classes``), a GRU deterministic path, a symlog MSE decoder, a
  twohot-symlog reward head and a continue head; straight-through
  gradients, 1% unimix, free-bits KL balancing split into dyn/rep terms.
- Actor/critic trained on imagined rollouts from replayed posterior
  states: lambda-returns, percentile (95-5) return normalisation, an EMA
  critic regulariser.
- Sequences may cross episode boundaries; is_first flags reset the
  recurrent state mid-sequence (reference: episodes_to_batch handling).

ray_tpu compiles the update to one XLA program with ``lax.scan`` over the
T replayed steps and the H imagined ones; here they are Python loops of
eager ops on the module's device, and ``.detach()`` stands for
``stop_gradient``. ray_tpu draws each step's categorical samples from
jax.random keys inside the program; here ``DreamerV3._draw_noise`` draws
the update's Gumbel noise on the host from one ``torch.Generator``
(seeded by the config's seed, checkpointed with the algorithm) and
hands it to the update, so an update is a pure function of its inputs
and a test can feed it jax.random's own draws (``jax.random.categorical``
is the argmax of the logits plus ``jax.random.gumbel`` of their shape).

Env stepping stays on the host through the standard env runner path
(``module.explore_actions``). The learner runs locally: remote learners
raise ray_tpu's ValueError, and so does a learner mesh, which ray_tpu
accepts and ignores (its update does not go through JaxLearner).
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import optim
from ray_tpu_torch.ops.tree import flatten, tree_map, unflatten
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.rl_module import (
    RLModule,
    _mlp_apply,
    _mlp_init,
    to_numpy,
    to_tensor,
)
from ray_tpu_torch.rllib.env.env_runner import gumbel_sample_logits
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    OBS,
    REWARDS,
    TERMINATEDS,
    TRUNCATEDS,
    SampleBatch,
)

IS_FIRST = "is_first"

WM_KEYS = ("enc", "post", "prior", "gru", "dec", "rew", "cont")


# -- symlog / twohot helpers (reference: dreamerv3/utils) ------------------

def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def twohot(x, bins):
    """Soft two-hot encoding of scalars over ``bins`` [K]."""
    K = bins.shape[0]
    x = torch.clamp(x, bins[0], bins[-1])
    idx = torch.clamp(torch.searchsorted(bins, x.contiguous(), right=True) - 1, 0, K - 2)
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    return (F.one_hot(idx, K) * (1.0 - w_hi)[..., None]
            + F.one_hot(idx + 1, K) * w_hi[..., None])


def twohot_mean(logits, bins):
    return (torch.softmax(logits, -1) * bins).sum(-1)


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__(algo_class=DreamerV3)
        self.hidden = 128          # MLP width
        self.deter = 256           # GRU deterministic state size
        self.stoch = 8             # latent groups
        self.classes = 8           # categories per group
        self.batch_size_B = 8      # replay sequences per update
        self.batch_length_T = 16   # replay sequence length
        self.horizon_H = 15        # imagination horizon
        self.gamma = 0.997
        self.gae_lambda = 0.95
        self.entropy_scale = 3e-4
        self.free_bits = 1.0
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.world_model_lr = 1e-3
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.critic_ema_decay = 0.98
        self.replay_capacity = 50_000
        self.training_ratio = 32   # replayed rows trained per env row
        self.num_bins = 63
        self.learning_starts = 256
        self.grad_clip = 100.0

    def rl_module_spec(self):
        spec = super().rl_module_spec()
        if spec.module_class is None:
            spec.module_class = DreamerV3Module
        spec.algo_config = self  # the module needs the RSSM dims
        return spec


# -- RSSM pieces -----------------------------------------------------------

def _gru_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    s_i, s_h = 1.0 / math.sqrt(in_dim), 1.0 / math.sqrt(hidden)
    return {"wi": torch.empty(in_dim, 3 * hidden).uniform_(-s_i, s_i, generator=gen),
            "wh": torch.empty(hidden, 3 * hidden).uniform_(-s_h, s_h, generator=gen),
            "b": torch.zeros(3 * hidden)}


def _gru(params, h, x):
    """The reference's GRU cell, h' = (1-z)*n + z*h with n = tanh(xn + r*hn)
    and one bias, on the input side (not nn.GRUCell's layout)."""
    xr, xz, xn = torch.chunk(x @ params["wi"] + params["b"], 3, dim=-1)
    hr, hz, hn = torch.chunk(h @ params["wh"], 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def _bins(cfg: DreamerV3Config, device=None):
    return torch.linspace(-20.0, 20.0, cfg.num_bins, device=device)


def _unimix_log_probs(logits, cfg):
    """log(0.99 softmax + 0.01 uniform) over [..., stoch, classes]."""
    lg = logits.reshape(*logits.shape[:-1], cfg.stoch, cfg.classes)
    return torch.log(0.99 * torch.softmax(lg, -1) + 0.01 / cfg.classes)


def _gumbel_argmax(logits, gumbel):
    """A draw from the categorical of ``logits`` over the last axis, given
    its Gumbel noise: jax.random.categorical's argmax(logits + gumbel)."""
    return torch.argmax(logits + gumbel, -1)


def _categorical_sample(logits, gumbel, cfg):
    """Straight-through sample of grouped categoricals, each group's
    category the argmax of its unimixed log-probs plus ``gumbel`` (noise
    of shape [..., stoch, classes]); returns (one-hot-ish sample
    [..., S*C], unimixed log-probs [..., S, C])."""
    shape = logits.shape[:-1]
    lg = logits.reshape(*shape, cfg.stoch, cfg.classes)
    probs = 0.99 * torch.softmax(lg, -1) + 0.01 / cfg.classes  # unimix
    lg = torch.log(probs)
    hard = F.one_hot(_gumbel_argmax(lg, gumbel), cfg.classes).to(probs.dtype)
    st = (hard - probs).detach() + probs
    return st.reshape(*shape, cfg.stoch * cfg.classes), lg


def _categorical_mode(logits, cfg):
    shape = logits.shape[:-1]
    lg = logits.reshape(*shape, cfg.stoch, cfg.classes)
    hard = F.one_hot(lg.argmax(-1), cfg.classes).to(logits.dtype)
    return hard.reshape(*shape, cfg.stoch * cfg.classes)


def _kl_categorical(lhs_logits, rhs_logits):
    """KL(lhs || rhs) over [..., S, C] log-prob inputs, summed over S."""
    lhs = torch.log_softmax(lhs_logits, -1)
    rhs = torch.log_softmax(rhs_logits, -1)
    return (torch.exp(lhs) * (lhs - rhs)).sum(-1).sum(-1)


class DreamerV3Module(RLModule):
    """World model + actor + critic in one parameter tree.

    The env runner calls explore_actions on flat observations; acting
    uses the posterior with a zero deterministic context (sufficient for
    the fully observed vector envs this module targets; image or partial
    observability would carry the GRU state in the runner)."""

    def init_params(self, gen: torch.Generator):
        s = self.spec
        cfg: DreamerV3Config = s.algo_config
        H, D = cfg.hidden, cfg.deter
        Z = cfg.stoch * cfg.classes
        params = {
            "enc": _mlp_init(gen, [s.observation_dim, H, H]),
            "post": _mlp_init(gen, [D + H, Z]),
            "prior": _mlp_init(gen, [D, H, Z]),
            "gru": _gru_init(gen, Z + s.action_dim, D),
            "dec": _mlp_init(gen, [D + Z, H, s.observation_dim]),
            "rew": _mlp_init(gen, [D + Z, H, cfg.num_bins]),
            "cont": _mlp_init(gen, [D + Z, H, 1]),
            "actor": _mlp_init(gen, [D + Z, H, s.action_dim]),
            "critic": _mlp_init(gen, [D + Z, H, cfg.num_bins]),
        }
        # The EMA critic starts equal to the critic (ray_tpu draws both
        # from one key).
        params["critic_ema"] = tree_map(torch.clone, params["critic"])
        return params

    def apply(self, params, obs) -> dict:
        cfg: DreamerV3Config = self.spec.algo_config
        deter = torch.zeros((obs.shape[0], cfg.deter), dtype=obs.dtype, device=obs.device)
        e = _mlp_apply(params["enc"], symlog(obs), activate_last=True)
        z = _categorical_mode(_mlp_apply(params["post"], torch.cat([deter, e], -1)), cfg)
        feat = torch.cat([deter, z], -1)
        return {"action_dist_inputs": _mlp_apply(params["actor"], feat),
                "vf_preds": symexp(twohot_mean(_mlp_apply(params["critic"], feat),
                                               _bins(cfg, obs.device)))}

    def explore_actions(self, obs, rng: np.random.Generator):
        logits = self.forward_inference(obs)["action_dist_inputs"]
        actions, _ = gumbel_sample_logits(logits, rng)
        return actions, {}


class DreamerV3(Algorithm):
    config_class = DreamerV3Config

    def build_learner(self, cfg: DreamerV3Config) -> None:
        if cfg.num_learners > 0:
            raise ValueError("DreamerV3 drives its learner locally")
        if cfg.mesh is not None:
            raise ValueError("DreamerV3 drives its own update, which takes no learner "
                             "mesh; build it without learners(mesh=...)")
        spec = cfg.rl_module_spec()
        self._spec = spec
        self.module = spec.build(seed=cfg.seed)
        self._device = self.module.device
        self._gen = torch.Generator().manual_seed(cfg.seed)
        self._bins = _bins(cfg, self._device)
        self._action_dim = spec.action_dim

        def clipped_adam(lr):
            return optim.chain(optim.clip_by_global_norm(cfg.grad_clip), optim.adam(lr))

        self._wm_opt = clipped_adam(cfg.world_model_lr)
        self._actor_opt = clipped_adam(cfg.actor_lr)
        self._critic_opt = clipped_adam(cfg.critic_lr)
        p = self.module.params
        self._wm_state = self._wm_opt.init(flatten({k: p[k] for k in WM_KEYS}))
        self._actor_state = self._actor_opt.init(flatten(p["actor"]))
        self._critic_state = self._critic_opt.init(flatten(p["critic"]))

        self._episodes: list[SampleBatch] = []
        self._replay_rows = 0
        self._ret_percentiles = torch.tensor([0.0, 1.0], device=self._device)
        self._last_metrics: dict = {}

    # -- the losses -------------------------------------------------------

    def wm_loss(self, wm_params, batch, gumbel):
        """The world-model loss over [B, T] sequences; ``gumbel`` [T, B,
        stoch, classes] draws each step's posterior sample. Returns (loss,
        metrics), the metrics holding ``feat`` [T*B, D+Z] t-major."""
        cfg, params = self.algo_config, wm_params
        obs = batch[OBS]                                         # [B, T, obs]
        acts = F.one_hot(batch[ACTIONS].long(), self._action_dim).to(obs.dtype)
        first = batch[IS_FIRST].to(obs.dtype)                    # [B, T]
        B, T = obs.shape[:2]
        e = _mlp_apply(params["enc"], symlog(obs), activate_last=True)
        deter = obs.new_zeros((B, cfg.deter))
        z = obs.new_zeros((B, cfg.stoch * cfg.classes))
        deters, zs, post_l, prior_l = [], [], [], []
        for t in range(T):
            # Episode boundary inside the sequence: reset the state.
            keep = (1.0 - first[:, t])[:, None]
            deter, z = deter * keep, z * keep
            deter = _gru(params["gru"], deter, torch.cat([z, acts[:, t]], -1))
            post_logits = _mlp_apply(params["post"], torch.cat([deter, e[:, t]], -1))
            z, post_lg = _categorical_sample(post_logits, gumbel[t], cfg)
            deters.append(deter)
            zs.append(z)
            post_l.append(post_lg)
            prior_l.append(_unimix_log_probs(_mlp_apply(params["prior"], deter), cfg))
        feat = torch.cat([torch.stack(deters), torch.stack(zs)], -1)  # [T, B, D+Z]
        post_l, prior_l = torch.stack(post_l), torch.stack(prior_l)
        obs_t = obs.transpose(0, 1)
        recon = _mlp_apply(params["dec"], feat)
        recon_loss = torch.square(recon - symlog(obs_t)).sum(-1).mean()
        rew_t = batch[REWARDS].transpose(0, 1)
        rew_logits = _mlp_apply(params["rew"], feat)
        rew_loss = -(twohot(symlog(rew_t), self._bins)
                     * torch.log_softmax(rew_logits, -1)).sum(-1).mean()
        cont_t = 1.0 - batch[TERMINATEDS].to(obs.dtype).transpose(0, 1)
        cont_logit = _mlp_apply(params["cont"], feat)[..., 0]
        cont_loss = F.binary_cross_entropy_with_logits(cont_logit, cont_t)
        dyn = torch.clamp(_kl_categorical(post_l.detach(), prior_l), min=cfg.free_bits).mean()
        rep = torch.clamp(_kl_categorical(post_l, prior_l.detach()), min=cfg.free_bits).mean()
        loss = (recon_loss + rew_loss + cont_loss
                + cfg.kl_dyn_scale * dyn + cfg.kl_rep_scale * rep)
        return loss, {"wm_loss": loss, "recon_loss": recon_loss, "reward_loss": rew_loss,
                      "continue_loss": cont_loss, "kl_dyn": dyn, "kl_rep": rep,
                      "feat": feat.reshape(-1, feat.shape[-1])}

    def imagine(self, frozen, actor_params, feat0, act_gumbel, z_gumbel):
        """Dream H steps from [N, D+Z] starts; step h's action is the
        argmax of the actor's logits plus ``act_gumbel[h]`` [N, actions],
        its latent drawn with ``z_gumbel[h]`` [N, stoch, classes]. Returns
        states s_0..s_H (H+1), actions/logits at s_0..s_{H-1}, rewards and
        continues for transitions into s_1..s_H."""
        cfg = self.algo_config
        D = cfg.deter
        feat = feat0
        feats, acts, a_logits, rews, conts = [], [], [], [], []
        for h in range(cfg.horizon_H):
            logits = _mlp_apply(actor_params, feat)
            a = _gumbel_argmax(logits, act_gumbel[h])
            deter = _gru(frozen["gru"], feat[:, :D],
                         torch.cat([feat[:, D:], F.one_hot(a, self._action_dim).to(feat.dtype)],
                                   -1))
            z, _ = _categorical_sample(_mlp_apply(frozen["prior"], deter), z_gumbel[h], cfg)
            nfeat = torch.cat([deter, z], -1)
            feats.append(feat)
            acts.append(a)
            a_logits.append(logits)
            rews.append(symexp(twohot_mean(_mlp_apply(frozen["rew"], nfeat), self._bins)))
            conts.append(torch.sigmoid(_mlp_apply(frozen["cont"], nfeat)[..., 0]))
            feat = nfeat
        return (torch.stack(feats + [feat]), torch.stack(acts), torch.stack(a_logits),
                torch.stack(rews), torch.stack(conts))

    def lambda_returns(self, rews, conts, values):
        """R_t = r_{t+1} + g*c_{t+1}[(1-l)V(s_{t+1}) + l R_{t+1}],
        R_H = V(s_H). rews/conts [H, N], values [H+1, N] -> [H, N]."""
        cfg = self.algo_config
        disc = conts * cfg.gamma
        nxt = values[-1]
        rets = [None] * cfg.horizon_H
        for t in range(cfg.horizon_H - 1, -1, -1):
            nxt = rews[t] + disc[t] * ((1 - cfg.gae_lambda) * values[t + 1]
                                       + cfg.gae_lambda * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def ac_loss(self, actor_params, critic_params, frozen, feat0, act_gumbel, z_gumbel, pcts):
        """The actor's and the critic's losses on an imagined rollout from
        ``feat0``; ``frozen`` (the world model and the EMA critic) takes no
        gradient."""
        cfg, bins = self.algo_config, self._bins
        feats_all, acts, a_logits, rews, conts = self.imagine(
            frozen, actor_params, feat0, act_gumbel, z_gumbel)
        v_logits_all = _mlp_apply(critic_params, feats_all)
        values_all = symexp(twohot_mean(v_logits_all, bins))           # [H+1, N]
        rets = self.lambda_returns(rews, conts, values_all.detach())     # [H, N]
        # Trajectory weight: product of predicted continues, shifted so
        # the start state has weight 1.
        weight = torch.cumprod(torch.cat([torch.ones_like(conts[:1]), conts[:-1]], 0),
                               0).detach()
        scale = torch.clamp(pcts[1] - pcts[0], min=1.0)
        adv = ((rets - values_all[:-1]) / scale).detach()
        logp = torch.log_softmax(a_logits, -1)
        act_logp = logp.gather(-1, acts[..., None])[..., 0]
        entropy = -(torch.exp(logp) * logp).sum(-1)
        actor_loss = -(weight * (act_logp * adv + cfg.entropy_scale * entropy)).mean()
        # Critic: twohot CE to lambda-returns (+ EMA regulariser) on the H
        # start states of each imagined transition.
        v_lp = torch.log_softmax(v_logits_all[:-1], -1)
        critic_ce = -(twohot(symlog(rets.detach()), bins) * v_lp).sum(-1)
        ema_probs = torch.softmax(_mlp_apply(frozen["critic_ema"], feats_all[:-1]),
                                  -1).detach()
        critic_reg = -(ema_probs * v_lp).sum(-1)
        critic_loss = (weight * (critic_ce + critic_reg)).mean()
        # jnp.percentile's default interpolation is torch.quantile's: linear.
        flat = rets.detach().reshape(-1)
        new_pcts = torch.stack([torch.quantile(flat, 0.05), torch.quantile(flat, 0.95)])
        return actor_loss + critic_loss, {
            "actor_loss": actor_loss, "critic_loss": critic_loss,
            "dream_return_mean": rets.mean(), "actor_entropy": entropy.mean(),
            "pcts": new_pcts}

    # -- one update --------------------------------------------------------

    def _draw_noise(self) -> dict:
        """One update's Gumbel noise, drawn on the host from the
        algorithm's generator: ``wm`` [T, B, stoch, classes] for the
        posterior samples, ``act`` [H, B*T, actions] and ``z`` [H, B*T,
        stoch, classes] for imagination."""
        cfg, g = self.algo_config, self._gen
        B, T, H, N = cfg.batch_size_B, cfg.batch_length_T, cfg.horizon_H, (
            cfg.batch_size_B * cfg.batch_length_T)

        def gumbel(*shape):
            u = torch.rand(shape, generator=g).clamp_(min=torch.finfo(torch.float32).tiny)
            return -torch.log(-torch.log(u))

        return {"wm": gumbel(T, B, cfg.stoch, cfg.classes),
                "act": gumbel(H, N, self._action_dim),
                "z": gumbel(H, N, cfg.stoch, cfg.classes)}

    @staticmethod
    def _step(opt, state, params: dict, grads: dict):
        updates, state = opt.update(grads, state, params)
        optim.apply_updates(params, updates)
        return state

    def _update(self, batch: dict, noise: dict) -> dict:
        """One update on ``batch`` ([B, T] columns) with ``noise``
        (``_draw_noise``'s keys): the world model's step, then the actor's
        and the critic's on the updated (frozen) world model, the EMA
        critic and the return percentiles. Parameters and optimizer states
        change in place; returns the metrics as tensors."""
        cfg, dev = self.algo_config, self._device
        params = self.module.params
        tb = {k: to_tensor(v, dev) for k, v in batch.items()}
        noise = {k: to_tensor(v, dev) for k, v in noise.items()}

        wm_flat = flatten({k: params[k] for k in WM_KEYS})
        live = {k: p.detach().requires_grad_(True) for k, p in wm_flat.items()}
        with torch.enable_grad():
            wl, wm_aux = self.wm_loss(unflatten({k: params[k] for k in WM_KEYS}, live), tb,
                                      noise["wm"])
        grads = dict(zip(live, torch.autograd.grad(wl, list(live.values()))))
        self._wm_state = self._step(self._wm_opt, self._wm_state, wm_flat, grads)

        feat0 = wm_aux.pop("feat").detach()
        frozen = {k: tree_map(torch.Tensor.detach, v) for k, v in params.items()
                  if k not in ("actor", "critic")}
        a_flat, c_flat = flatten(params["actor"]), flatten(params["critic"])
        a_live = {k: p.detach().requires_grad_(True) for k, p in a_flat.items()}
        c_live = {k: p.detach().requires_grad_(True) for k, p in c_flat.items()}
        with torch.enable_grad():
            total, ac_aux = self.ac_loss(
                unflatten(params["actor"], a_live), unflatten(params["critic"], c_live),
                frozen, feat0, noise["act"], noise["z"], self._ret_percentiles)
        g = torch.autograd.grad(total, list(a_live.values()) + list(c_live.values()))
        self._actor_state = self._step(self._actor_opt, self._actor_state, a_flat,
                                       dict(zip(a_live, g[:len(a_live)])))
        self._critic_state = self._step(self._critic_opt, self._critic_state, c_flat,
                                        dict(zip(c_live, g[len(a_live):])))
        decay = cfg.critic_ema_decay
        with torch.no_grad():
            for e, c in zip(flatten(params["critic_ema"]).values(), c_flat.values()):
                e.copy_(decay * e + (1 - decay) * c)
            self._ret_percentiles = 0.99 * self._ret_percentiles + 0.01 * ac_aux.pop("pcts")
        return {**{k: v.detach() for k, v in wm_aux.items()},
                **{k: v.detach() for k, v in ac_aux.items()}, "total_wm_loss": wl.detach()}

    # -- replay -------------------------------------------------------------

    def _store_batch(self, batch: SampleBatch) -> None:
        """Split the runner's flat t-major [T*B] batch into per-env
        sequences with is_first flags derived from done rows."""
        cfg = self.algo_config
        T = cfg.rollout_fragment_length
        Bn = len(batch) // T
        done = (np.asarray(batch[TERMINATEDS]).reshape(T, Bn)
                | np.asarray(batch[TRUNCATEDS]).reshape(T, Bn))
        for i in range(Bn):
            rows = {k: np.asarray(v).reshape(T, Bn, *np.asarray(v).shape[1:])[:, i]
                    for k, v in batch.items()}
            first = np.zeros(T, bool)
            first[1:] = done[:-1, i]
            rows[IS_FIRST] = first
            self._episodes.append(SampleBatch(rows))
            self._replay_rows += T
        while self._replay_rows > cfg.replay_capacity and len(self._episodes) > 1:
            self._replay_rows -= len(self._episodes.pop(0))

    def _sample_sequences(self, rng) -> SampleBatch | None:
        cfg = self.algo_config
        B, T = cfg.batch_size_B, cfg.batch_length_T
        usable = [e for e in self._episodes if len(e) >= T]
        if not usable:
            return None
        keys = (OBS, ACTIONS, REWARDS, TERMINATEDS, IS_FIRST)
        cols: dict[str, list] = {k: [] for k in keys}
        for _ in range(B):
            ep = usable[rng.integers(len(usable))]
            start = rng.integers(0, len(ep) - T + 1)
            for k in keys:
                cols[k].append(np.asarray(ep[k][start:start + T]))
        return SampleBatch({k: np.stack(v) for k, v in cols.items()})

    # -- training -------------------------------------------------------------

    def training_step(self) -> dict:
        cfg = self.algo_config
        batch = self.env_runner_group.sample(self.module.get_weights())
        self._store_batch(batch)
        metrics: dict = {"replay_rows": self._replay_rows}
        if self._replay_rows < cfg.learning_starts:
            return metrics
        rng = np.random.default_rng(int(self.iteration))
        updates = max(1, (len(batch) * cfg.training_ratio)
                      // (cfg.batch_size_B * cfg.batch_length_T))
        done_updates = 0
        for _ in range(updates):
            seqs = self._sample_sequences(rng)
            if seqs is None:
                break
            self._last_metrics = self._update(dict(seqs), self._draw_noise())
            done_updates += 1
        if self._last_metrics:
            # One copy to the host for all of them.
            names = list(self._last_metrics)
            values = torch.stack([self._last_metrics[k].float() for k in names]).tolist()
            metrics.update(zip(names, values))
        metrics["num_updates"] = done_updates
        return metrics

    def get_weights(self):
        return self.module.get_weights()

    # -- checkpointing --------------------------------------------------------

    def get_extra_state(self) -> dict:
        return {"params": self.module.get_weights(),
                "wm_state": tree_map(to_numpy, self._wm_state),
                "actor_state": tree_map(to_numpy, self._actor_state),
                "critic_state": tree_map(to_numpy, self._critic_state),
                "pcts": to_numpy(self._ret_percentiles),
                "generator": self._gen.get_state().numpy()}

    def set_extra_state(self, state: dict) -> None:
        on_dev = lambda t: tree_map(lambda a: to_tensor(a, self._device).clone(), t)  # noqa: E731
        self.module.set_weights(state["params"])
        self._wm_state = on_dev(state["wm_state"])
        self._actor_state = on_dev(state["actor_state"])
        self._critic_state = on_dev(state["critic_state"])
        self._ret_percentiles = to_tensor(state["pcts"], self._device).clone()
        self._gen.set_state(torch.from_numpy(np.asarray(state["generator"])))

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "wb") as f:
            pickle.dump({"iteration": self.iteration, "extra": self.get_extra_state()}, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algo_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.iteration = state["iteration"]
        self.set_extra_state(state["extra"])

    def cleanup(self) -> None:
        if getattr(self, "env_runner_group", None) is not None:
            self.env_runner_group.stop()
