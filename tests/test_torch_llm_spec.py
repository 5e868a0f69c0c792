"""The port's speculative decoding (ray_tpu_torch.llm.model_runner.verify
and the engine's draft model, windows and greedy acceptance) and its .npz
checkpoints against ray_tpu's, on the CPU: verify's logits within 1e-4,
and engines whose draft and target come from one .npz give the JAX
engine's greedy tokens and acceptance counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import model_runner as jmr
from ray_tpu.models import transformer as J
from ray_tpu_torch.llm import model_runner as tmr
from ray_tpu_torch.llm import LLMConfig, LLMEngine
from torch_llm_helpers import (GEOMETRY, JMODEL, TMODEL, assert_same,
                               base_params, engine_pair, run, sampling)

PROMPTS = ["the quick brown fox", "pack my box with five dozen"]
DRAFT = J.tiny(vocab_size=512, max_seq_len=128, dtype="float32", n_layers=1,
               d_model=32, n_heads=2)


def _save_npz(params, path):
    """Flat dotted keys, the layout both engines read."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jax.device_get(params), "")
    np.savez(path, **flat)
    return str(path)


def test_verify_matches_reference():
    """Windows of 4 for two slots, one near the cache end (its last rows
    pass the cache and write nothing): logits within 1e-4, same cache."""
    jp, tp = base_params()
    T = 16
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(2, 2, T, 4, 16)).astype(np.float32)
    jc = {"k": jnp.asarray(cache), "v": jnp.asarray(cache * 0.5)}
    tc = {"k": torch.from_numpy(cache.copy()),
          "v": torch.from_numpy(cache * 0.5)}
    toks = rng.integers(0, 256, (2, 4))
    pos = np.array([5, 14])
    jl, jc = jmr.verify(jp, jnp.asarray(toks, jnp.int32),
                        jnp.asarray(pos, jnp.int32), jc, config=JMODEL)
    tl, tc = tmr.verify(tp, torch.from_numpy(toks), torch.from_numpy(pos), tc,
                        config=TMODEL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    je, te = engine_pair(max_num_seqs=2)
    d = tmp_path_factory.mktemp("ckpt")
    draft = J.init_params(jax.random.PRNGKey(5), DRAFT)
    return (je, te, _save_npz(je.params, d / "target.npz"),
            _save_npz(draft, d / "draft.npz"))


def test_checkpoint_npz_loads_the_same_params(target):
    je, _, target_npz, _ = target
    te = LLMEngine(LLMConfig(model=TMODEL, checkpoint_path=target_npz,
                             max_num_seqs=2, **GEOMETRY), device="cpu")
    js, ts = sampling(max_tokens=8)
    assert_same(je, run(je, PROMPTS, js), run(te, PROMPTS, ts), PROMPTS)


@pytest.mark.parametrize("draft", ["target", "small"])
def test_speculative_engine_matches_reference(target, draft):
    """A perfect draft (the target's own weights, from the .npz: every
    proposal accepted) and a small random one (mostly rejected): both
    give plain greedy's tokens, and the JAX engine's acceptance counts."""
    je, _, target_npz, draft_npz = target
    kw = (dict(speculative_model=JMODEL, speculative_checkpoint_path=target_npz)
          if draft == "target" else
          dict(speculative_model=DRAFT, speculative_checkpoint_path=draft_npz))
    js_e, ts_e = engine_pair(max_num_seqs=2,
                             num_speculative_tokens=4, **kw)
    js, ts = sampling(max_tokens=12)
    want = run(je, PROMPTS, js)
    jo, to = run(js_e, PROMPTS, js), run(ts_e, PROMPTS, ts)
    assert [o.token_ids for o in jo] == [o.token_ids for o in want]
    assert_same(je, jo, to, PROMPTS)
    assert ts_e.spec_stats == js_e.spec_stats
    assert ts_e.spec_stats["spec_steps"] > 0
    if draft == "target":
        st = ts_e.spec_stats
        assert st["accepted"] == st["proposed"] > 0


def test_speculative_fallback_and_capacity(target):
    """A sampled request forces fallback steps (the greedy one's draft
    rows are still written, so a perfect draft stays perfect), and slots
    near the cache end stop at "length" like plain decoding."""
    je, _, target_npz, _ = target
    js_e, ts_e = engine_pair(max_num_seqs=2, max_seq_len=24,
                             speculative_model=JMODEL,
                             speculative_checkpoint_path=target_npz)
    jg, tg = sampling(max_tokens=30)
    _, tsamp = sampling(max_tokens=3, temperature=0.9)
    jo = run(js_e, PROMPTS[:1], jg)
    to = run(ts_e, [PROMPTS[0], "hi"], [tg, tsamp])
    assert_same(je, jo, to[:1], PROMPTS[:1])
    assert to[0].finish_reason == "length"
    st = ts_e.spec_stats
    assert st["fallback_steps"] > 0 and st["spec_steps"] > 0
    assert st["accepted"] == st["proposed"]
