"""The port's multi-LoRA serving (ray_tpu_torch.llm.lora, the runner's
LoRA hooks and the engine's adapter registry) against ray_tpu's, on the
CPU from the same parameters and adapter factors: lora_delta and the
prefill/decode logits within 1e-4, LoRAManager's ids the same over the
same operations, and mixed batches with the JAX engine's greedy tokens."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import lora as jlora
from ray_tpu.llm import model_runner as jmr
from ray_tpu_torch.llm import lora as tlora
from ray_tpu_torch.llm import model_runner as tmr
from torch_llm_helpers import (JMODEL, TMODEL, assert_same, base_params,
                               engine_pair, run, sampling)

TOL = 1e-4
C = JMODEL
HDH = C.n_heads * C.head_dim
DIMS = {"wq": (C.d_model, HDH), "wk": (C.d_model, HDH),
        "wv": (C.d_model, HDH), "wo": (HDH, C.d_model)}


def _adapter(seed, targets=("wq", "wk", "wv", "wo"), rank=4, scale=0.5):
    rng = np.random.default_rng(seed)
    return {t: (rng.normal(size=(C.n_layers, DIMS[t][0], rank)).astype(
                    np.float32) * scale,
                rng.normal(size=(C.n_layers, rank, DIMS[t][1])).astype(
                    np.float32) * scale)
            for t in targets}


def _merged(params, adapter, scale):
    """The base params with ``adapter`` merged into its projections:
    W + scale * A @ B in each layer (wo's input is the flattened heads)."""
    attn = dict(params["layers"]["attn"])
    for t, (a, b) in adapter.items():
        w = attn[t]
        delta = np.einsum("ldr,lro->ldo", a, b) * scale
        attn[t] = w + jnp.asarray(delta.reshape(w.shape))
    return {**params, "layers": {**params["layers"], "attn": attn}}


def _managers():
    kw = dict(max_adapters=4, max_rank=8)
    return (jlora.LoRAManager(C.n_layers, DIMS, **kw),
            tlora.LoRAManager(C.n_layers, DIMS, **kw, device="cpu"))


def _trees_equal(jm, tm):
    jt, tt = jm.lora_tree(), tm.lora_tree()
    assert np.array_equal(tt["scales"].numpy(), np.asarray(jt["scales"]))
    for t in DIMS:
        for f in ("A", "B"):
            assert np.array_equal(tt[t][f].numpy(), np.asarray(jt[t][f]))


def test_manager_matches_reference_ids():
    """add / overwrite / remove (in flight: retired) / reclaim: the same
    indices, names, retired state and stacked factors."""
    jm, tm = _managers()
    ops = [("add", "a", 0), ("add", "b", 1), ("add", "a", 2),
           ("remove", "b", {2}), ("add", "c", 3), ("reclaim", None, set()),
           ("add", "d", 4), ("remove", "a", set()), ("add", "e", 5)]
    for op, name, arg in ops:
        for m, mod in ((jm, jlora), (tm, tlora)):
            if op == "add":
                m.add(mod.LoRAAdapter(name, _adapter(arg, rank=2 + arg % 3),
                                      alpha=8.0))
            elif op == "remove":
                m.remove(name, active=arg)
            else:
                m.reclaim(active=arg)
        assert tm.loaded() == jm.loaded()
        assert [tm.index_of(n) for n in tm.loaded()] == [
            jm.index_of(n) for n in jm.loaded()]
        assert tm.has_retired() == jm.has_retired()
        _trees_equal(jm, tm)
    with pytest.raises(RuntimeError):
        tm.add(tlora.LoRAAdapter("f", _adapter(6)))  # pool full
    with pytest.raises(ValueError):
        tm.add(tlora.LoRAAdapter("g", _adapter(7, rank=9)))  # rank > max


def test_adapter_load_from_npz(tmp_path):
    f = tmp_path / "ad.npz"
    ad = _adapter(1, targets=("wq", "wo"))
    np.savez(f, **{f"{t}.{k}": v for t, (a, b) in ad.items()
                   for k, v in (("A", a), ("B", b))})
    j = jlora.LoRAAdapter.load("x", str(f))
    t = tlora.LoRAAdapter.load("x", str(f))
    assert sorted(t.tensors) == sorted(j.tensors) and t.scale == j.scale


def test_lora_delta_matches_reference():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(3, 5, 16)).astype(np.float32)
    layer = {"A": rng.normal(size=(4, 16, 8)).astype(np.float32),
             "B": rng.normal(size=(4, 8, 12)).astype(np.float32)}
    aix = np.array([0, 3, 1], np.int32)
    scales = np.array([0.0, 2.0, 0.5, 4.0], np.float32)
    j = jlora.lora_delta(jnp.asarray(h), {k: jnp.asarray(v) for k, v in
                                          layer.items()},
                         jnp.asarray(aix), jnp.asarray(scales))
    t = tlora.lora_delta(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v
                                               in layer.items()},
                         torch.from_numpy(aix).long(), torch.from_numpy(scales))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)
    assert not t[0].any()  # the null adapter adds exactly zero


def test_prefill_and_decode_with_lora_match_reference():
    """Batched prefill and a decode step over two rows, one on an adapter
    and one on the null adapter: logits within 1e-4."""
    jp, tp = base_params()
    jm, tm = _managers()
    jm.add(jlora.LoRAAdapter("a", _adapter(0)))
    tm.add(tlora.LoRAAdapter("a", _adapter(0)))
    toks = np.random.default_rng(1).integers(0, 256, (2, 8))
    aix = np.array([1, 0])
    jc, tc = jmr.init_slot_cache(C, 2, 16), tmr.init_slot_cache(TMODEL, 2, 16,
                                                                  device="cpu")
    jl, jc = jmr.prefill_batch(jp, jnp.asarray(toks, jnp.int32),
                               jnp.asarray([8, 6], jnp.int32),
                               jnp.asarray([0, 1], jnp.int32), jc, config=C,
                               lora=jm.lora_tree(),
                               lora_ix=jnp.asarray(aix, jnp.int32))
    tl, tc = tmr.prefill_batch(tp, torch.from_numpy(toks), [8, 6], [0, 1], tc,
                               config=TMODEL, lora=tm.lora_tree(),
                               lora_ix=torch.from_numpy(aix))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    pos = np.array([8, 6])
    last = np.array([3, 4])
    _, jl, _ = jmr.decode(jp, jnp.asarray(last, jnp.int32),
                          jnp.asarray(pos, jnp.int32), jc,
                          jnp.zeros((2,), jnp.float32), jax.random.PRNGKey(0),
                          config=C, lora=jm.lora_tree(),
                          lora_ix=jnp.asarray(aix, jnp.int32))
    _, tl, _ = tmr.decode(tp, torch.from_numpy(last), torch.from_numpy(pos), tc,
                          torch.zeros(2), torch.Generator(), config=TMODEL,
                          lora=tm.lora_tree(), lora_ix=torch.from_numpy(aix))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)


def test_engine_mixed_batch_matches_reference():
    """Two adapters and the base model in one batch (admitted in one
    batched prefill, decoded together), then removal with a sequence in
    flight: the JAX engine's tokens, and the slot recycled after."""
    je, te = engine_pair(max_num_seqs=4, lora={"max_adapters": 4,
                                                "max_rank": 8})
    for eng in (je, te):
        eng.add_lora("a1", _adapter(1, scale=2.0), alpha=16.0)
        eng.add_lora("a2", _adapter(2, targets=("wq", "wv"), scale=2.0))
    prompts = ["hello", "hello", "world", "lora!"]
    js = [sampling(max_tokens=8, extra=e) for e in
          ({}, {"lora": "a1"}, {"lora": "a2"}, {"lora": "a1"})]
    jo = run(je, prompts, [j for j, _ in js])
    to = run(te, prompts, [t for _, t in js])
    # The base request against the base model, each adapter request
    # against the base weights with its adapter merged in (the margins of
    # both checked there).
    merged = {"a1": _merged(je.params, _adapter(1, scale=2.0), 16.0 / 4),
              "a2": _merged(je.params, _adapter(2, targets=("wq", "wv"),
                                                 scale=2.0), 16.0 / 4)}
    for i, (p, (j_sp, _)) in enumerate(zip(prompts, js)):
        name = j_sp.extra.get("lora")
        ref = je if name is None else SimpleNamespace(
            params=merged[name], model_config=C, tokenizer=je.tokenizer,
            max_len=je.max_len)
        assert_same(ref, jo[i:i + 1], to[i:i + 1], [p])
    assert to[1].token_ids != to[0].token_ids
    # Select the adapter by the model suffix instead.
    te.add_request("m", "hello", sampling(max_tokens=8)[1], model="tiny:a1")
    done = []
    while te.has_unfinished():
        done += te.step()
    assert done[0].token_ids == to[1].token_ids
    # Remove with a sequence in flight: retired, then recycled.
    te.add_request("f", "hello", js[1][1])
    assert te.step() == []
    ix = te.lora_mgr.index_of("a1")
    assert te.remove_lora("a1") and te.lora_mgr.has_retired()
    outs = []
    while te.has_unfinished():
        outs += te.step()
    assert outs[0].token_ids == to[1].token_ids
    assert not te.lora_mgr.has_retired() and ix in te.lora_mgr._free
    te.add_lora("a3", _adapter(3))
    assert te.list_loras() == ["a2", "a3"]
    with pytest.raises(ValueError):
        te.add_request("x", "hi", sampling(extra={"lora": "a1"})[1])
