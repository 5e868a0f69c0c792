"""The PyTorch port's MoE path (ray_tpu_torch.ops.moe and the MoE branch of
the transformer) against the JAX package's, on the CPU, from the same
numpy inputs or the same parameters carried across by
ray_tpu_torch.interop.params_from_jax. Mirrors tests/test_moe.py.

Routing is compared first, exactly: the set of experts each token is
kept by, per layer and per step. Only then are values compared, so a
near-tie that the two frameworks' summation orders split differently
shows as a routing failure, not as a value mismatch.

Tolerances (float32, the two frameworks differ only in the order of
their sums): dispatch equal; combine and aux to 1e-6 (the router softmax
in an ulp or two); moe_swiglu's output and aux to 1e-5, its gradients
to 1e-4 (test_models.py's); forward logits to 1e-4 (test_torch_
transformer.py's); lm_loss metrics to 1e-5 relative and gradients to
1e-4; the train steps as in test_torch_train.py: loss and grad_norm to
1e-5 relative each step, the parameters to 1e-5 after 3 steps with
AdamW's eps at 1e-6.

The JAX side runs under jax.jit: one compile per test, and the routing
probe (the JAX model with its layers unrolled) once per attention impl,
shared by every test through one input shape, [2, 32].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as J
from ray_tpu.ops import moe as JM
from ray_tpu.ops.layers import swiglu as jswiglu
from ray_tpu.ops.optim import FusedClipAdamW as JFused
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops import moe as TM
from ray_tpu_torch.ops import optim
from ray_tpu_torch.ops.layers import swiglu
from ray_tpu_torch.ops.tree import tree_unflatten


def _configs(**kw):
    jc = J.tiny_moe(dtype="float32", **kw)
    return jc, T.TransformerConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def moe_params():
    jc, _ = _configs()
    jp = jax.jit(lambda key: J.init_params(key, jc))(jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _tokens(b, t, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, t))


def _uneven_mask():
    """test_models.py's uneven mask: rows 2-3 mostly masked."""
    mask = np.ones((4, 33), np.float32)
    mask[2:, 5:] = 0.0
    return mask


# -- routing probes -------------------------------------------------------------

def _kept(dispatch):
    """[..., g, E, C] dispatch -> bool [..., g, E]: the experts that keep
    each token."""
    return dispatch.sum(-1) > 0


def _jax_kept(x, router_w, top_k, capacity_factor=1.25, group_size=1024):
    """The routing of JAX's moe_swiglu (its first lines, as written there)."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    g = JM._group_size(B * S, group_size)
    xg = jnp.asarray(x).reshape(B * S // g, g, D)
    logits = jnp.einsum("ngd,de->nge", xg.astype(jnp.float32),
                        jnp.asarray(router_w).astype(jnp.float32))
    C = JM.expert_capacity(g, E, top_k, capacity_factor)
    return _kept(jax.vmap(lambda lg: JM.topk_dispatch(lg, top_k, C)[0])(logits))


def _torch_kept(x, router_w, top_k, capacity_factor=1.25, group_size=1024):
    with torch.no_grad():
        return _kept(TM.route(x, router_w, top_k=top_k,
                              capacity_factor=capacity_factor,
                              group_size=group_size)[1]).numpy()


def _assert_same_routing(jkept, tkept):
    assert len(jkept) == len(tkept) > 0
    for i, (a, b) in enumerate(zip(jkept, tkept)):
        a = np.asarray(a)
        assert a.shape == b.shape
        differ = int((a != b).any(-1).sum())
        assert differ == 0, f"layer {i}: {differ} tokens routed differently"


def _spied(module, kept, run):
    """Run ``run()`` with a spy on ``module.moe_swiglu``; return what
    ``kept`` made of each call's inputs (one entry per layer)."""
    rec, orig = [], module.moe_swiglu

    def spy(x, router_w, *w, top_k, capacity_factor=1.25, **kw):
        rec.append(kept(x, router_w, top_k, capacity_factor))
        return orig(x, router_w, *w, top_k=top_k, capacity_factor=capacity_factor,
                    **kw)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(module, "moe_swiglu", spy)
        run()
    return rec


@pytest.fixture(scope="module")
def routing():
    """``routing(jp, jc, tp, tc, inputs)`` asserts that the JAX model and
    the port keep each token of ``inputs`` [B, T] by the same experts in
    every layer, each seen at its own model's MoE input, and returns the
    JAX forward's (logits, aux). The JAX side is one jitted forward per
    attention impl with the layers unrolled (the same values as the
    scan), returning the spy's arrays (traced once per shape).
    ``routing.jax(jp, jc, inputs)`` gives the JAX side alone: (the experts
    keeping each token, per layer; (logits, aux))."""
    probes = {}

    def jax_side(jp, jc, inputs):
        key = (jc.attn_impl, jc.dtype)
        if key not in probes:
            c = dataclasses.replace(jc, scan_layers=False, remat=False)

            def probe(p, t):
                out = []
                kept = _spied(JM, _jax_kept, lambda: out.extend(
                    J.forward(p, t, c, return_aux=True)))
                return kept, out

            probes[key] = jax.jit(probe)
        return probes[key](jp, jnp.asarray(inputs))

    def check(jp, jc, tp, tc, inputs):
        jkept, jout = jax_side(jp, jc, inputs)

        def run():
            with torch.no_grad():
                T.forward(tp, torch.as_tensor(inputs), tc)

        _assert_same_routing(jkept, _spied(T, _torch_kept, run))
        return jout

    check.jax = jax_side
    return check


# -- ops ----------------------------------------------------------------------------

def _zero_logits():
    return np.zeros((16, 8), np.float32)


def _overflow_logits():
    """test_moe.py:32: everything routed to expert 0 (G=16, C=8)."""
    return np.stack([np.full(16, 10.0), np.full(16, -10.0)], -1).astype(np.float32)


DISPATCH_CASES = {
    "random": (lambda: np.random.default_rng(0).standard_normal((32, 4)).astype(
        np.float32), 2, 24),
    "all_tie": (_zero_logits, 2, 8),
    "overflow": (_overflow_logits, 1, 8),
    "groups": (lambda: np.random.default_rng(1).standard_normal((3, 20, 4)).astype(
        np.float32), 2, 8),
}


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_topk_dispatch_matches_jax(case):
    """Leading dims are independent groups (JAX: jax.vmap). A zero router
    ties every expert: both pick the lowest indices. Overflow drops the
    same tokens."""
    make, k, C = DISPATCH_CASES[case]
    logits = make()
    fn = lambda lg: JM.topk_dispatch(lg, k, C)  # noqa: E731
    for _ in range(logits.ndim - 2):
        fn = jax.vmap(fn)
    jd, jc, ja = (np.asarray(a) for a in jax.jit(fn)(jnp.asarray(logits)))
    td, tc, ta = (a.numpy() for a in TM.topk_dispatch(torch.as_tensor(logits), k, C))
    assert td.shape == jd.shape and tc.shape == jc.shape and ta.shape == ja.shape
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ta, ja, atol=1e-6, rtol=0)
    if case == "all_tie":  # experts 0 and 1 for the first C tokens, then drops
        kept = _kept(td)
        assert kept[:C, :2].all() and not kept[C:].any() and not kept[:, 2:].any()
    if case == "overflow":
        kept = td.sum(axis=(1, 2))
        assert kept.sum() == C
        assert np.allclose(tc.sum(axis=(1, 2))[kept == 0], 0.0)


def _moe_inputs(B, S, D=16, E=4, F=32, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return (f(B, S, D), f(D, E, scale=0.5), f(E, D, F, scale=0.1),
            f(E, D, F, scale=0.1), f(E, F, D, scale=0.1), f(B, S, D))


@pytest.mark.parametrize("B,S,D", [(2, 16, 16), (2, 513, 8)])
def test_moe_swiglu_matches_jax(B, S, D):
    """(2, 513): G = 1026, which 1024 does not divide, so _group_size
    picks 513 (two groups). The gradients of x, router and experts come
    from loss = sum(out · dout) + aux, against jax.grad."""
    assert TM._group_size(B * S, 1024) == (B * S if B * S <= 1024 else B * S // 2)
    *args, dout = _moe_inputs(B, S, D=D)

    def jloss(*a):
        out, aux = JM.moe_swiglu(*a, top_k=2)
        return (out * dout).sum() + aux, (out, aux, _jax_kept(a[0], a[1], 2))

    (_, (jo, ja, jkept)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True))(*map(jnp.asarray, args))
    _assert_same_routing([jkept], [_torch_kept(torch.as_tensor(args[0]),
                                               torch.as_tensor(args[1]), 2)])
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    to, ta = TM.moe_swiglu(*targs, top_k=2)
    tg = torch.autograd.grad((to * torch.as_tensor(dout)).sum() + ta, targs)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(ta.detach()), float(ja), atol=1e-5, rtol=0)
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"), jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_single_expert_matches_dense_swiglu():
    """E=1, top-1, ample capacity: the dense expert (test_moe.py:45), in
    the port and against JAX's dense swiglu."""
    x, _, wg, wu, wd, _ = _moe_inputs(2, 8, E=1)
    router = np.zeros((x.shape[-1], 1), np.float32)
    out, _ = TM.moe_swiglu(*map(torch.as_tensor, (x, router, wg, wu, wd)),
                           top_k=1, capacity_factor=4.0)
    dense = swiglu(*map(torch.as_tensor, (x, wg[0], wu[0], wd[0])))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jswiglu(x, wg[0], wu[0], wd[0])),
                               atol=1e-4, rtol=0)


def test_capacity_and_group_size_match_jax():
    for n in (1, 4, 100, 128, 1000, 8192):
        for e in (1, 4, 8):
            for k in (1, 2):
                for cf in (1.0, 1.25, 2.0):
                    assert TM.expert_capacity(n, e, k, cf) == \
                        JM.expert_capacity(n, e, k, cf)
    for total in (1, 90, 128, 1000, 1500, 8192):
        for target in (1, 32, 1024):
            assert TM._group_size(total, target) == JM._group_size(total, target)


def test_constrain_fn_is_refused():
    """constrain_fn is no longer refused: as in ray_tpu it is applied to the
    dispatched activations and to the experts' outputs, both [n, E, C, D],
    and an annotation that returns its input leaves the result as it was
    (expert parallelism passes parallel._collectives.ExpertShard, held
    against ray_tpu by tests/test_torch_parallel.py's expert-parallel
    case)."""
    x, r, wg, wu, wd, _ = _moe_inputs(1, 8)
    shapes = {"jax": [], "torch": []}

    def seen(key):
        return lambda t: shapes[key].append(tuple(t.shape)) or t

    jo, ja = JM.moe_swiglu(*map(jnp.asarray, (x, r, wg, wu, wd)), top_k=2,
                           constrain_fn=seen("jax"))
    args = list(map(torch.as_tensor, (x, r, wg, wu, wd)))
    to, ta = TM.moe_swiglu(*args, top_k=2, constrain_fn=seen("torch"))
    plain = TM.moe_swiglu(*args, top_k=2)
    assert shapes["torch"] == shapes["jax"] and len(shapes["torch"]) == 2
    assert shapes["torch"][0][1] == r.shape[1]  # the expert dim
    np.testing.assert_array_equal(to.numpy(), plain[0].numpy())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-5, rtol=0)


# -- the model ------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_forward_with_aux_matches_jax(moe_params, impl, routing):
    jp, tp = moe_params
    jc, tc = _configs(attn_impl=impl)
    toks = _tokens(2, 32)
    jl, ja = routing(jp, jc, tp, tc, toks)
    with torch.no_grad():
        tl, ta = T.forward(tp, torch.as_tensor(toks), tc, return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=0)
    assert float(ta) > 0.0


@pytest.mark.parametrize("ce", ["dense", "fused", "checkpoint"])
def test_lm_loss_matches_jax(moe_params, ce, routing):
    """The loss is CE + router_aux_weight · aux; perplexity stays the
    CE's; every gradient leaf (router and experts included)."""
    jp, tp = moe_params
    kw = {} if ce == "dense" else dict(loss_chunk=24, ce_impl=ce)
    jc, tc = _configs(attn_impl="reference", remat=False, **kw)
    toks = _tokens(2, 33)
    routing(jp, jc, tp, tc, toks[:, :-1])
    jbatch = {"tokens": jnp.asarray(toks)}
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: J.lm_loss(p, jbatch, jc), has_aux=True))(jp)
    tm, tg = T.loss_and_grads(tp, {"tokens": torch.as_tensor(toks)}, tc)
    assert set(tm) == set(jm) >= {"loss", "router_aux", "perplexity", "accuracy"}
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    ce_loss = float(jm["loss"]) - jc.router_aux_weight * float(jm["router_aux"])
    np.testing.assert_allclose(float(tm["perplexity"]), np.exp(ce_loss), rtol=1e-5)
    tg = tree_unflatten(tp, tg)
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        keys = [p.key for p in path]
        b = tg
        for key in keys:
            b = b[key]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0,
                                   err_msg="/".join(keys))
    assert float(np.abs(tg["layers"]["router"]["w"].numpy()).sum()) > 0.0


# -- the train step ---------------------------------------------------------------------

def _optimizers(kind):
    if kind == "fused":
        return (JFused(learning_rate=1e-3, eps=1e-6, weight_decay=0.1, clip_norm=1.0),
                optim.FusedClipAdamW(learning_rate=1e-3, eps=1e-6, weight_decay=0.1,
                                     clip_norm=1.0))
    return (optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(1e-3, eps=1e-6, weight_decay=0.1)),
            optim.chain(optim.clip_by_global_norm(1.0),
                        optim.adamw(1e-3, eps=1e-6, weight_decay=0.1)))


@pytest.mark.parametrize("opt,accum,policy,impl", [("fused", 1, None, "flash"),
                                                   ("optax", 2, "dots", "reference")])
def test_train_step_matches_jax(moe_params, opt, accum, policy, impl, routing):
    """3 steps from the same parameters; the routing of every (micro)batch
    is compared before each step. accum_steps=2 with remat "dots" runs on
    test_models.py's unevenly masked batch [4, 33] with the optax-style
    chain, the other on [2, 33]."""
    kw = dict(remat=False) if policy is None else dict(remat=True, remat_policy=policy)
    jc, tc = _configs(attn_impl=impl, loss_chunk=48, **kw)
    batch = {"tokens": _tokens(4 if accum > 1 else 2, 33)}
    if accum > 1:
        batch["mask"] = _uneven_mask()
    jopt, topt = _optimizers(opt)
    jp = moe_params[0]
    jstate = {"params": jp, "opt_state": jopt.init(jp), "step": jnp.zeros((), jnp.int32)}
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    tstate = {"params": tp, "opt_state": topt.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(J.make_train_step(jc, jopt, accum_steps=accum))
    tstep = T.make_train_step(tc, topt, accum_steps=accum)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        for micro in np.split(batch["tokens"][:, :-1], accum):
            routing(jstate["params"], jc, tstate["params"], tc, micro)
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm)
        for key in ("loss", "grad_norm", "router_aux"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5,
                                       err_msg=key)
    assert int(tstate["step"]) == 3
    for path, a in jax.tree_util.tree_leaves_with_path(jstate["params"]):
        b = tstate["params"]
        for p in path:
            b = b[p.key]
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


def test_fused_and_chain_split_no_tokens_in_bf16(moe_params, routing):
    """FusedClipAdamW against chain(clip_by_global_norm, adamw), 3 steps each
    from one seed on tiny_moe in bf16 compute, with the clip below the grad
    norm so that both clip: ray_tpu's pair (optax's chain) routes every
    token-layer pair alike and gives the same losses and grad norms, bit
    for bit, at every step; the port's pair must do the same. (On the card
    the port's pair once parted in bf16, 4,410 of 98,304 pairs rerouted by
    step 3 on moe_small: its FusedClipAdamW summed the norm in another
    order and clipped as g·(c/n), where optax computes (g/n)·c.)"""
    jc, tc = _configs(loss_chunk=48)
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    tokens = _tokens(8, 129)
    inputs = tokens[:, :-1]
    hyper = dict(learning_rate=1e-3, weight_decay=0.1)
    jax_opts = {"fused": JFused(clip_norm=0.1, **hyper),
                "chain": optax.chain(optax.clip_by_global_norm(0.1), optax.adamw(
                    hyper["learning_rate"], weight_decay=hyper["weight_decay"]))}
    port_opts = {"fused": optim.FusedClipAdamW(clip_norm=0.1, **hyper),
                 "chain": optim.chain(optim.clip_by_global_norm(0.1), optim.adamw(
                     hyper["learning_rate"], weight_decay=hyper["weight_decay"]))}

    def run_jax(opt):
        state = {"params": moe_params[0], "opt_state": opt.init(moe_params[0]),
                 "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(J.make_train_step(jc, opt))
        rows = []
        for _ in range(3):
            kept = [np.asarray(k) for k in routing.jax(state["params"], jc, inputs)[0]]
            state, m = step(state, {"tokens": jnp.asarray(tokens)})
            rows.append((kept, float(m["loss"]), float(m["grad_norm"])))
        return rows

    def run_port(opt):
        tp = params_from_jax(jax.device_get(moe_params[0]), device="cpu")
        state = {"params": tp, "opt_state": opt.init(tp),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = T.make_train_step(tc, opt)
        rows = []
        for _ in range(3):
            def forward(params=state["params"]):
                with torch.no_grad():
                    T.forward(params, torch.as_tensor(inputs), tc)

            kept = _spied(T, _torch_kept, forward)
            state, m = step(state, {"tokens": tokens})
            rows.append((kept, float(m["loss"]), float(m["grad_norm"])))
        return rows

    for name, run, opts in (("ray_tpu", run_jax, jax_opts), ("port", run_port, port_opts)):
        fused, chain = run(opts["fused"]), run(opts["chain"])
        for i, ((kf, lf, gf), (kc, lc, gc)) in enumerate(zip(fused, chain), 1):
            rerouted = sum(int((a != b).any(-1).sum()) for a, b in zip(kf, kc))
            assert rerouted == 0, f"{name} step {i}: {rerouted} token-layer pairs rerouted"
            assert (lf, gf) == (lc, gc), (f"{name} step {i}: loss gap {lc - lf}, "
                                          f"grad-norm gap {gc - gf}")
