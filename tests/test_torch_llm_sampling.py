"""The port's extended sampling (ray_tpu_torch.llm.model_runner's
penalize_logits, filter_top_k_top_p, advanced_sample,
reset_slot_sampling, and the engine's host sampling, stop rules and
logprobs) against ray_tpu's, on the CPU from the same inputs.

The filters and penalties agree within 1e-6 with the same masked
positions (but where the nucleus test is a float32 tie). Seeded sampling cannot reproduce jax.random's streams, so it
is held to its contract instead: the same seed gives the same tokens
whatever the batch holds, and a seeded request's first token (sampled on
the host with numpy, as ray_tpu does) equals the JAX engine's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import model_runner as jmr
from ray_tpu_torch.llm import model_runner as tmr
from torch_llm_helpers import (assert_decided, assert_same, engine_pair,
                               forward_logits, run, sampling)

B, V = 4, 64


def _logits(seed=0):
    return np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32) * 3


def _both(fn_j, fn_t, *arrays):
    return (np.asarray(fn_j(*(jnp.asarray(a) for a in arrays))),
            fn_t(*(torch.from_numpy(np.asarray(a)) for a in arrays)).numpy())


def test_penalize_logits_matches_reference():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    prompt = rng.random((B, V)) < 0.2
    pres = np.array([0.0, 0.5, 1.0, -0.3], np.float32)
    freq = np.array([0.0, 0.2, 0.7, 0.1], np.float32)
    rep = np.array([1.0, 1.3, 0.8, 2.0], np.float32)
    j, t = _both(jmr.penalize_logits, tmr.penalize_logits, _logits(), counts,
                 prompt, pres, freq, rep)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("top_k,top_p,min_p", [
    ([0, 1, 5, 64], [1.0, 1.0, 1.0, 1.0], [0.0] * 4),
    ([0, 0, 0, 0], [0.9, 0.5, 0.0, 0.99], [0.0] * 4),
    ([3, 0, 10, 0], [0.8, 1.0, 0.7, 1.0], [0.0, 0.1, 0.05, 0.5]),
])
def test_filters_match_reference(top_k, top_p, min_p):
    args = (_logits(2), np.array(top_k, np.int32), np.array(top_p, np.float32),
            np.array(min_p, np.float32))
    j, t = _both(jmr.filter_top_k_top_p, tmr.filter_top_k_top_p, *args)
    # The same tokens masked, except where a token's nucleus test is a
    # float32 tie: the probability mass before it lies within 1e-6 of
    # top_p, and the two frameworks' cumsums round it to either side (at
    # top_p = 1.0, a tail token of probability ~1e-7).
    x = args[0].astype(np.float64)
    order = np.argsort(-x, axis=-1, kind="stable")
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    before = np.cumsum(np.take_along_axis(p, order, -1), -1) - np.take_along_axis(
        p, order, -1)
    tie = np.zeros_like(x, bool)
    np.put_along_axis(tie, order, np.abs(before - args[2][:, None]) < 1e-6, -1)
    differ = (t <= -1e29) != (j <= -1e29)
    assert not (differ & ~tie).any()
    assert differ.sum() <= 1
    np.testing.assert_allclose(t[~differ], j[~differ], rtol=0, atol=1e-6)


def test_top_k_ties_keep_every_tied_token():
    x = np.zeros((1, 8), np.float32)
    x[0, [2, 5, 6]] = 1.0
    t = tmr.filter_top_k_top_p(torch.from_numpy(x), torch.tensor([2]),
                               torch.tensor([1.0]), torch.tensor([0.0]))
    assert (t[0] > -1).nonzero()[:, 0].tolist() == [2, 5, 6]


def _advanced(mod, arr, logits, *, temps, seeds, steps, counts=None,
              bias=None, max_logprobs=0):
    z = np.zeros(B, np.float32)
    args = [logits, temps, np.array([0, 3, 0, 8], np.int32),
            np.array([1.0, 1.0, 0.9, 1.0], np.float32), z,
            np.array([0.0, 0.5, 0.0, 0.2], np.float32), z,
            np.array([1.0, 1.2, 1.0, 1.0], np.float32),
            np.zeros((B, V), np.int32) if counts is None else counts,
            np.zeros((B, V), bool), seeds, steps]
    if bias is not None:
        args += list(bias)
    return mod.advanced_sample(*(arr(a) for a in args),
                               max_logprobs=max_logprobs)


def test_advanced_sample_greedy_rows_match_reference():
    """Greedy rows (with penalties and logit_bias): the same tokens,
    chosen logprobs and top logprobs within 1e-6, the same counts."""
    logits = _logits(3)
    counts = np.random.default_rng(4).integers(0, 2, (B, V)).astype(np.int32)
    bias = (np.array([[5, 7, 0], [1, 1, 0], [0, 0, 0], [63, 2, 0]], np.int32),
            np.array([[4.0, -2.0, 0.0], [1.0, 2.0, 0.0], [0.0] * 3,
                      [9.0, 0.5, 0.0]], np.float32))
    kw = dict(temps=np.zeros(B, np.float32), seeds=np.arange(B, dtype=np.int32),
              steps=np.zeros(B, np.int32), counts=counts, bias=bias,
              max_logprobs=5)
    jt, jlp, jv, ji, jc = _advanced(jmr, jnp.asarray, logits, **kw)
    tt, tlp, tv, ti, tc = _advanced(tmr, torch.from_numpy, logits, **kw)
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert np.array_equal(tc.numpy(), np.asarray(jc))


def test_seeded_draws_depend_on_seed_and_step_only():
    """A row's draw is a function of (seed, step): moving it to another
    batch position beside other rows gives the same token; top-k holds
    the support."""
    logits = np.tile(_logits(5)[:1], (B, 1))
    temps = np.ones(B, np.float32)
    seeds = np.array([11, 12, 13, 11], np.int64)
    steps = np.array([3, 3, 4, 3], np.int64)
    t, *_ = _advanced(tmr, torch.from_numpy, logits, temps=temps, seeds=seeds,
                      steps=steps)
    assert t[0] == t[3]
    t2, *_ = _advanced(tmr, torch.from_numpy, logits, temps=temps,
                       seeds=seeds[::-1].copy(), steps=steps[::-1].copy())
    assert t2.tolist()[::-1] == t.tolist()
    top3 = set(np.argsort(-logits[1])[:3].tolist())
    assert int(t[1]) in top3  # row 1 has top_k=3
    u = tmr.counter_uniforms(torch.arange(64), torch.zeros(64), 512)
    assert 0 < u.min() and u.max() < 1 and abs(u.mean().item() - 0.5) < 0.01


def test_seeded_draws_follow_the_distribution():
    """Over many seeds, the draws' frequencies match softmax(logits)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    n = 20000
    toks = tmr.seeded_categorical(logits.expand(n, 4), torch.arange(n),
                                  torch.zeros(n))
    freq = torch.bincount(toks, minlength=4).double() / n
    want = torch.softmax(logits[0].double(), -1)
    assert (freq - want).abs().max() < 0.015


def test_reset_slot_sampling_matches_reference():
    counts = np.ones((B, V), np.int32)
    mask = np.zeros((B, V), bool)
    hist = np.random.default_rng(6).random(V) < 0.3
    jc, jm = jmr.reset_slot_sampling(jnp.asarray(counts), jnp.asarray(mask),
                                     jnp.int32(2), jnp.asarray(hist),
                                     jnp.int32(9))
    tc, tm = tmr.reset_slot_sampling(torch.from_numpy(counts),
                                     torch.from_numpy(mask), 2,
                                     torch.from_numpy(hist), 9)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


# -- the engines -------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    return engine_pair(max_num_seqs=4)


PROMPTS = ["hello there", "the quick brown fox", "abc", "sampling test"]


def test_engine_penalties_and_logit_bias_match_reference(engines):
    je, te = engines
    kw = dict(max_tokens=10, repetition_penalty=1.3, presence_penalty=0.4,
              frequency_penalty=0.3, logit_bias=((101, 2.0), (32, -1.0)))
    js, ts = sampling(**kw)
    jo, to = run(je, PROMPTS, js), run(te, PROMPTS, ts)
    assert_same(je, jo, to, PROMPTS, sp=ts)


def test_engine_logprobs_match_reference(engines):
    """A greedy batch beside a plain request: the chosen logprobs within
    1e-4 and the same top-3 ids; the first entry (host) and the rest
    (device) alike."""
    je, te = engines
    js, ts = sampling(max_tokens=6, logprobs=3)
    jp, tp = sampling(max_tokens=6)
    prompts = PROMPTS[:2]
    jo, to = run(je, prompts, [js, jp]), run(te, prompts, [ts, tp])
    assert_same(je, jo, to, prompts)
    assert to[1].logprobs is None
    for a, b in zip(jo[0].logprobs, to[0].logprobs):
        assert b["token_id"] == a["token_id"]
        assert abs(b["logprob"] - a["logprob"]) < 1e-4
        assert list(b["top"]) == list(a["top"])
    # Against log_softmax of the model's own logits.
    toks = te.tokenizer.encode(prompts[0])
    ref = forward_logits(je, toks + to[0].token_ids[:-1])[len(toks) - 1:]
    ref = ref - np.logaddexp.reduce(ref, axis=-1, keepdims=True)
    got = [e["logprob"] for e in to[0].logprobs]
    want = ref[np.arange(len(got)), to[0].token_ids]
    assert np.abs(np.asarray(got) - want).max() < 1e-4


def test_engine_stop_strings_min_tokens_match_reference(engines):
    je, te = engines
    probe = run(je, ["hello there"], sampling(max_tokens=10)[0])[0]
    stop_text = probe.text[3:5]
    cases = [dict(max_tokens=12, stop=(stop_text,)),
             dict(max_tokens=12, stop=(stop_text,), min_tokens=6),
             dict(max_tokens=8, min_tokens=8, stop_token_ids=(probe.token_ids[1],)),
             dict(max_tokens=8, ignore_eos=True)]
    for kw in cases:
        js, ts = sampling(**kw)
        jo, to = run(je, ["hello there"], js), run(te, ["hello there"], ts)
        assert_same(je, jo, to, ["hello there"])
    assert to[0].finish_reason == "length"


def test_engine_seeded_requests(engines):
    """A seeded request's first token equals the JAX engine's; alone and
    inside a full batch of other requests it gives the same tokens."""
    je, te = engines
    kw = dict(max_tokens=8, temperature=0.9, top_k=20, top_p=0.95, min_p=0.01,
              presence_penalty=0.2, frequency_penalty=0.1,
              repetition_penalty=1.1, logit_bias=((65, 1.0),), logprobs=2,
              seed=1234)
    js, ts = sampling(**kw)
    jo = run(je, ["seeded"], js)[0]
    alone = run(te, ["seeded"], ts)[0]
    assert alone.token_ids[0] == jo.token_ids[0]
    others = [sampling(max_tokens=8, temperature=1.0, seed=s)[1] for s in (1, 2)]
    batch = run(te, ["x", "seeded", "yz"], [others[0], ts, others[1]])
    assert batch[1].token_ids == alone.token_ids
    assert [e["token_id"] for e in alone.logprobs] == alone.token_ids
    assert all(0 <= t < te.model_config.vocab_size for t in alone.token_ids)


def test_engine_greedy_advanced_matches_plain(engines):
    """top_k / top_p at temperature 0 never move the argmax: the advanced
    program's greedy tokens equal the plain path's, and the JAX engine's."""
    je, te = engines
    jp, tp = sampling(max_tokens=8)
    ja, ta = sampling(max_tokens=8, top_k=5, top_p=0.5)
    plain = run(te, PROMPTS[:2], tp)
    adv = run(te, PROMPTS[:2], ta)
    assert [o.token_ids for o in adv] == [o.token_ids for o in plain]
    assert_same(je, run(je, PROMPTS[:2], ja), adv, PROMPTS[:2])
    for p, o in zip(PROMPTS[:2], adv):
        assert_decided(je, te.tokenizer.encode(p), o.token_ids)
