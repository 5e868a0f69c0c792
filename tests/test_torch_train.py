"""The PyTorch port's training path (losses, FusedClipAdamW, the train
step, remat) against the JAX package's, on the CPU, from the same
parameters carried across by ray_tpu_torch.interop.params_from_jax and the
same numpy batches.

Tolerances: gradients of the losses agree to 1e-4 (the JAX suite's,
test_models.py) — both frameworks compute in float32 and differ only in
the order of their sums; the optimizers (FusedClipAdamW against ray_tpu's,
the optax-style transforms against optax) to 1e-7 over 4 steps
(test_models.py's optax parity); the train steps to 1e-5 in loss and
grad_norm (relative) and 1e-5 in the parameters after 3 AdamW steps.
AdamW divides each gradient component by its own magnitude plus eps, so
its update moves by up to |dg| / eps for a summation-order difference dg
(~1e-9 here) of a component near zero; the step comparison takes
eps=1e-6, bounding that at 3 steps x lr x 1e-3 = 3e-6 (at the default
1e-8 one component of |g| ~ 5e-10 moved by 3e-5).

The JAX side runs under jax.jit so each test compiles once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as J
from ray_tpu.ops.optim import FusedClipAdamW as JFused
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops import optim
from ray_tpu_torch.ops.optim import FusedClipAdamW
from ray_tpu_torch.ops.tree import tree_leaves, tree_unflatten

ARCHS = {
    "gpt2": dict(dtype="float32"),
    "llama_gqa": dict(dtype="float32", arch="llama", n_kv_heads=2),
}


def _configs(arch="gpt2", **kw):
    jc = J.tiny(**ARCHS[arch], **kw)
    return jc, T.TransformerConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def gpt2_params():
    jc, _ = _configs()
    jp = jax.jit(lambda key: J.init_params(key, jc))(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _tokens(b, t, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, t))


def _mask(b, t, seed=2):
    return (np.random.default_rng(seed).uniform(size=(b, t)) > 0.2).astype(np.float32)


def _pairs(jtree, ttree, path=()):
    """(path, JAX leaf as numpy, torch leaf as numpy) over the JAX tree."""
    for key, jv in jtree.items():
        if isinstance(jv, dict):
            yield from _pairs(jv, ttree[key], path + (key,))
        else:
            yield path + (key,), np.asarray(jv), ttree[key].detach().numpy()


def _assert_trees_close(jtree, ttree, atol):
    for path, a, b in _pairs(jtree, ttree):
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg="/".join(path))


def _torch_loss_and_grads(tp, batch, tc, **kw):
    metrics, grads = T.loss_and_grads(tp, batch, tc, **kw)
    return metrics, tree_unflatten(tp, grads)


# -- losses: loss, accuracy and every gradient leaf, f32 atol 1e-4 ----------

@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("ce", ["dense", "fused", "checkpoint"])
def test_lm_loss_matches_jax(gpt2_params, ce, z_loss):
    """loss_chunk=24 over 2x32 targets: two full chunks and a short one."""
    jp, tp = gpt2_params
    kw = {} if ce == "dense" else dict(loss_chunk=24, ce_impl=ce)
    jc, tc = _configs(**kw)
    toks, mask = _tokens(2, 33), _mask(2, 33)
    jbatch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    tbatch = {"tokens": torch.as_tensor(toks), "mask": torch.as_tensor(mask)}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: J.lm_loss(p, jbatch, jc, z_loss=z_loss), has_aux=True))(jp)
    tm, tg = _torch_loss_and_grads(tp, tbatch, tc, z_loss=z_loss)
    for key in ("loss", "accuracy", "perplexity"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    _assert_trees_close(jg, tg, atol=1e-4)


def test_lm_loss_inputs_targets_form(gpt2_params):
    """The {"inputs", "targets", "mask"} batch form, no accuracy metric."""
    jp, tp = gpt2_params
    jc, tc = _configs(loss_chunk=32, ce_accuracy=False)
    toks, mask = _tokens(2, 17), _mask(2, 16)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}
    jl, jm = jax.jit(lambda p, b: J.lm_loss(p, b, jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = T.lm_loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()}, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tm["accuracy"]) == float(jm["accuracy"]) == 0.0


def test_lm_loss_rejects_unknown_ce_impl(gpt2_params):
    _, tp = gpt2_params
    _, tc = _configs(loss_chunk=16, ce_impl="scan")
    with pytest.raises(ValueError, match="ce_impl"):
        T.lm_loss(tp, {"tokens": torch.as_tensor(_tokens(1, 9))}, tc)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5))
    mask = _mask(2, 5)
    for m in (None, mask):
        jl, jm = J.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                      mask=None if m is None else jnp.asarray(m),
                                      z_loss=1e-3)
        tl, tm = T.cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(tgt),
                                      mask=None if m is None else torch.as_tensor(m),
                                      z_loss=1e-3)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]))


# -- optimizer: 4 steps alternating below/above the clip, atol 1e-7 ---------

def test_fused_clip_adamw_matches_jax(gpt2_params):
    jp, _ = gpt2_params
    host = jax.device_get(jp)
    tp = params_from_jax(host, device="cpu")
    jopt = JFused(learning_rate=3e-4, weight_decay=0.1, clip_norm=1.0)
    topt = FusedClipAdamW(learning_rate=3e-4, weight_decay=0.1, clip_norm=1.0)
    js, ts = jopt.init(jp), topt.init(tp)
    japply = jax.jit(jopt.apply)
    rng = np.random.default_rng(5)
    jparams = jp
    for i in range(4):
        scale = 3.0 if i % 2 else 0.01
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale
                                    ).astype(np.float32), host)
        jparams, js, jn = japply(jax.tree.map(jnp.asarray, g), js, jparams)
        tparams, ts, tn = topt.apply(params_from_jax(g, device="cpu"), ts, tp)
        assert tparams is tp  # updated in place
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees_close(jparams, tp, atol=1e-7)
        _assert_trees_close(js["m"], ts["m"], atol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 4


def test_fused_clip_adamw_mu_dtype_and_no_clip():
    opt = FusedClipAdamW(learning_rate=1e-2, clip_norm=None, mu_dtype=torch.bfloat16)
    params = {"w": torch.ones(4), "b": {"x": torch.zeros(3)}}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["v"]["b"]["x"].dtype == torch.float32
    grads = {"w": torch.full((4,), 10.0), "b": {"x": torch.zeros(3)}}
    _, state, gnorm = opt.apply(grads, state, params)
    assert float(gnorm) == pytest.approx(20.0)
    # Unclipped Adam's first step moves each weight by lr * g/|g|.
    np.testing.assert_allclose(params["w"].numpy(), np.full(4, 0.99), atol=1e-6)
    assert float(params["b"]["x"].abs().sum()) == 0.0


OPTAX_PAIRS = {
    "sgd": lambda o: o.sgd(1e-2),
    "sgd_momentum": lambda o: o.sgd(1e-2, momentum=0.9),
    "sgd_nesterov": lambda o: o.sgd(1e-2, momentum=0.9, nesterov=True),
    "adam": lambda o: o.adam(1e-3, eps_root=1e-8),
    "adamw": lambda o: o.adamw(1e-3, weight_decay=0.1),
    "clip_by_global_norm": lambda o: o.clip_by_global_norm(1.0),
    "chain_clip_adamw": lambda o: o.chain(o.clip_by_global_norm(1.0),
                                          o.adamw(3e-4, weight_decay=0.1)),
}


def _state_leaves(state):
    """The tensors of an optax or port optimizer state, in order."""
    if isinstance(state, dict):
        for v in state.values():
            yield from _state_leaves(v)
    elif isinstance(state, tuple):  # chain's tuple and the NamedTuple states
        for v in state:
            yield from _state_leaves(v)
    else:
        yield np.asarray(state.numpy() if isinstance(state, torch.Tensor) else state)


@pytest.mark.parametrize("name", sorted(OPTAX_PAIRS))
def test_optax_style_transform_matches_optax(gpt2_params, name):
    """4 updates from the same gradients, alternating below and above the
    clip: the updates, the parameters after apply_updates and every state
    leaf (count int32 included) agree with optax's to 1e-7. optax runs
    eagerly, one rounding per operation as in the port (under jit XLA
    fuses (1-b)·g + b·t into one FMA, an ulp away: 1.2e-7 at |p| = 1)."""
    jp, _ = gpt2_params
    host = jax.device_get(jp)
    tp = params_from_jax(host, device="cpu")
    jopt, topt = OPTAX_PAIRS[name](optax), OPTAX_PAIRS[name](optim)
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(6)
    jparams = jp
    for i in range(4):
        scale = 3.0 if i % 2 else 0.01
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale
                                    ).astype(np.float32), host)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, ts = topt.update(params_from_jax(g, device="cpu"), ts, tp)
        assert optim.apply_updates(tp, tu) is tp  # updated in place
        _assert_trees_close(ju, tu, atol=1e-7)
        _assert_trees_close(jparams, tp, atol=1e-7)
    jleaves, tleaves = list(_state_leaves(js)), list(_state_leaves(ts))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, atol=1e-7, rtol=0)
    np.testing.assert_allclose(float(optim.global_norm(tp)),
                               float(optax.global_norm(jparams)), rtol=1e-6)


# -- the train step against the JAX step, 3 steps ----------------------------

def _uneven_mask():
    """test_models.py's uneven mask: rows 2-3 mostly masked."""
    mask = np.ones((4, 33), np.float32)
    mask[2:, 5:] = 0.0
    return mask


def _assert_steps_match_jax(jc, tc, batch, accum_steps=1, opts=None):
    """3 steps of the JAX and the port's train step from the same
    parameters: loss and grad_norm each step, the parameters after.
    ``opts`` is a (JAX, port) optimizer pair, FusedClipAdamW's by
    default."""
    jopt, topt = opts or (
        JFused(learning_rate=1e-3, eps=1e-6, weight_decay=0.1, clip_norm=1.0),
        FusedClipAdamW(learning_rate=1e-3, eps=1e-6, weight_decay=0.1,
                       clip_norm=1.0))
    jstate = jax.jit(lambda key: J.init_train_state(key, jc, jopt))(
        jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jstate["params"]), device="cpu")
    tstate = {"params": tp, "opt_state": topt.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(J.make_train_step(jc, jopt, accum_steps=accum_steps))
    tstep = T.make_train_step(tc, topt, accum_steps=accum_steps)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=key)
    assert int(tstate["step"]) == 3
    _assert_trees_close(jstate["params"], tstate["params"], atol=1e-5)


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_matches_jax(arch, impl):
    jc, tc = _configs(arch, attn_impl=impl, loss_chunk=48)
    _assert_steps_match_jax(jc, tc, {"tokens": _tokens(4, 33)})


@pytest.mark.parametrize("arch,policy", [("gpt2", "full"), ("llama_gqa", "dots")])
def test_accumulated_remat_step_matches_jax(arch, policy):
    """accum_steps=2 with remat against the JAX step with the same
    settings, on test_models.py's unevenly masked batch, through the
    flash path."""
    jc, tc = _configs(arch, attn_impl="flash", loss_chunk=48, remat=True,
                      remat_policy=policy)
    batch = {"tokens": _tokens(4, 33), "mask": _uneven_mask()}
    _assert_steps_match_jax(jc, tc, batch, accum_steps=2)


STEP_OPTIMIZERS = {
    "chain_clip_adamw": lambda o: o.chain(o.clip_by_global_norm(1.0),
                                          o.adamw(1e-3, eps=1e-6, weight_decay=0.1)),
    "sgd": lambda o: o.sgd(1e-1),
}


@pytest.mark.parametrize("name", sorted(STEP_OPTIMIZERS))
def test_optax_style_train_step_matches_jax(name):
    """The optimizer.update path: the port's transform in the port's step
    against optax's in ray_tpu's, 3 steps."""
    jc, tc = _configs(loss_chunk=48)
    opts = tuple(STEP_OPTIMIZERS[name](o) for o in (optax, optim))
    _assert_steps_match_jax(jc, tc, {"tokens": _tokens(4, 33)}, opts=opts)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=2 over 4 rows matches the plain step on the same rows,
    also with an uneven mask (microbatches weighted by valid tokens)."""
    _, tc = _configs(loss_chunk=64)
    opt = FusedClipAdamW(learning_rate=1e-3, clip_norm=None)
    toks, mask = _tokens(4, 33), _uneven_mask()
    full = T.make_train_step(tc, opt)
    acc = T.make_train_step(tc, opt, accum_steps=2)
    for batch in ({"tokens": toks}, {"tokens": toks, "mask": mask}):
        states = [T.init_train_state(torch.Generator().manual_seed(0), tc, opt,
                                     device="cpu") for _ in range(2)]
        s_full, m_full = full(states[0], batch)
        s_acc, m_acc = acc(states[1], batch)
        np.testing.assert_allclose(float(m_acc["loss"]), float(m_full["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m_acc["grad_norm"]),
                                   float(m_full["grad_norm"]), rtol=1e-4)
        for a, b in zip(tree_leaves(s_full["params"]), tree_leaves(s_acc["params"])):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)


def test_grad_accumulation_rejects_uneven_split():
    _, tc = _configs()
    opt = FusedClipAdamW()
    state = T.init_train_state(torch.Generator().manual_seed(0), tc, opt, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        T.make_train_step(tc, opt, accum_steps=2)(state, {"tokens": _tokens(3, 9)})


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_gradients(gpt2_params, policy, monkeypatch):
    """remat recomputes each layer (through the flash Function too) and
    gives the gradients of remat=False; "dots" keeps some products."""
    _, tp = gpt2_params
    decisions = []
    save_dots = T._save_dots

    def counting(ctx, op, *args, **kwargs):
        decisions.append(save_dots(ctx, op, *args, **kwargs))
        return decisions[-1]

    monkeypatch.setattr(T, "_save_dots", counting)
    batch = {"tokens": torch.as_tensor(_tokens(2, 33))}
    _, tc = _configs(attn_impl="flash", loss_chunk=32)
    _, g_plain = _torch_loss_and_grads(tp, batch, tc)
    _, g_remat = _torch_loss_and_grads(
        tp, batch, dataclasses.replace(tc, remat=True, remat_policy=policy))
    for a, b in zip(tree_leaves(g_plain), tree_leaves(g_remat)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)
    saved = [d for d in decisions if d == T.CheckpointPolicy.MUST_SAVE]
    assert (len(saved) > 0) == (policy == "dots")


def test_unstacked_layers_give_one_stacked_gradient(gpt2_params):
    """The layer leaves are split once per forward: each stacked leaf gets
    one gradient node (unbind), not one indexing node per layer."""
    _, tp = gpt2_params
    _, tc = _configs()
    w = tp["layers"]["attn"]["wq"].detach().requires_grad_()
    layers = T._unstack_layers(dict(tp["layers"], attn=dict(tp["layers"]["attn"], wq=w)))
    assert len(layers) == tc.n_layers
    assert layers[0]["attn"]["wq"].grad_fn is layers[1]["attn"]["wq"].grad_fn


def test_train_step_refuses_what_is_not_ported():
    """Nothing is refused any more: mesh= builds the sharded step (held
    against ray_tpu's in test_torch_parallel.py), and MoE configs and
    optax-style optimizers are accepted."""
    _, tc = _configs()
    assert callable(T.make_train_step(tc, FusedClipAdamW(), mesh=object()))
    assert callable(T.make_train_step(T.tiny_moe(), optim.sgd(1e-2), mesh=object()))
    moe = T.tiny_moe(remat=False)
    opt = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-3))
    state = T.init_train_state(torch.Generator().manual_seed(0), moe, opt, device="cpu")
    state, metrics = T.make_train_step(moe, opt)(state, {"tokens": _tokens(2, 9)})
    assert int(state["step"]) == 1 and int(state["opt_state"][1][0].count) == 1
    assert np.isfinite(float(metrics["loss"])) and float(metrics["router_aux"]) > 0.0


def test_train_step_learns_on_cpu():
    _, tc = _configs(attn_impl="flash", loss_chunk=32)
    opt = FusedClipAdamW(learning_rate=1e-2)
    state = T.init_train_state(torch.Generator().manual_seed(0), tc, opt, device="cpu")
    assert state["params"]["embed"]["tokens"].device.type == "cpu"
    step = T.make_train_step(tc, opt)
    batch = {"tokens": _tokens(4, 33)}
    state, m0 = step(state, batch)
    for _ in range(4):
        state, m = step(state, batch)
    assert float(m["loss"]) < float(m0["loss"])
    assert int(state["step"]) == 5 and int(state["opt_state"]["count"]) == 5
    assert np.isfinite(float(m["grad_norm"]))
