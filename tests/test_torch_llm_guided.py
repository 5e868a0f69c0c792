"""The port's guided JSON decoding (ray_tpu_torch.llm.guided, its own
copy of ray_tpu/llm/guided.py, and the engine's masked host-side pick)
against ray_tpu's, on the CPU: the automaton's masks equal state by
state, and greedy guided requests give the JAX engine's tokens after the
top-2 margin check over the allowed tokens."""

import json

import numpy as np
import pytest

from ray_tpu.llm import guided as jg
from ray_tpu_torch.llm import guided as tg
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from torch_llm_helpers import (LOGIT_TOL, engine_pair, forward_logits, run,
                               sampling, top2_margins)

TEXT = '{"a": [1, -2.5e3, true, null], "b\\u00e9": {"c": "x\\"y"}, "d": []}'


def _texts(vocab=512):
    tok = ByteTokenizer()
    return [tok.decode([i]) if i < 256 else "" for i in range(vocab)]


def test_masks_equal_state_by_state():
    """Along a document that visits every automaton mode, both packages'
    maskers allow the same tokens at every state, and give the same
    verdicts — but inside an incomplete number ("-2.5e"), where the port
    refuses the terminators ray_tpu's automaton lets through."""
    texts = _texts()
    jm, tm = jg.JsonTokenMasker(texts, 258), tg.JsonTokenMasker(texts, 258)
    jd, td = jg.GuidedJson(jm), tg.GuidedJson(tm)
    for ch in TEXT:
        jmask, tmask = jd.allowed_mask(), td.allowed_mask()
        st = td.state
        if st.mode == tg.IN_NUM and not tg._valid_number(st.num_text):
            refused = {texts[i] for i in np.flatnonzero(jmask & ~tmask)}
            assert refused and all(not t[0].isdigit() and t[0] not in ".eE+-"
                                   for t in refused)
            assert not (tmask & ~jmask).any()
        else:
            assert np.array_equal(tmask, jmask)
        assert st.state_class() == jd.state.state_class()
        jd.accept(ord(ch))
        td.accept(ord(ch))
    assert td.finished_ok() == jd.finished_ok() == (True, None)
    schema = {"type": "object", "required": ["z"]}
    for mod in (jg, tg):
        assert mod.validate_schema(json.loads(TEXT), schema) is not None
    assert tg.validate_schema({"z": 1}, schema) is None


@pytest.mark.parametrize("doc", ["[1e]", "[-]", '{"a": 1.}', "[0.5e+]"])
def test_incomplete_numbers_cannot_end(doc):
    """ray_tpu's automaton accepts a terminator after an incomplete
    number (and its engine can then emit text json.loads rejects); the
    port's refuses it."""
    assert jg.JsonState().feed_text(doc)
    assert not tg.JsonState().feed_text(doc)
    with pytest.raises(json.JSONDecodeError):
        json.loads(doc)


@pytest.fixture(scope="module")
def engines():
    return engine_pair(max_num_seqs=2, max_seq_len=128,
                       prefill_buckets=(16, 32))


def _guided_margins(je, prompt, tokens):
    """Top-2 margins of each step's logits over the tokens the automaton
    allowed there."""
    texts = _texts(je.model_config.vocab_size)
    g = tg.GuidedJson(tg.JsonTokenMasker(texts, 258))
    steps = forward_logits(je, list(prompt) + list(tokens[:-1]))[len(prompt) - 1:]
    out = []
    for row, tok in zip(steps, tokens):
        out.append(top2_margins(row, g.allowed_mask()))
        g.accept(tok)
    return np.asarray(out)


@pytest.mark.parametrize("fmt", [
    {"type": "json_object"},
    {"type": "json_schema", "json_schema": {"schema": {"type": "object"}}},
])
def test_engine_guided_matches_reference(engines, fmt):
    je, te = engines
    js, ts = sampling(max_tokens=40, response_format=fmt)
    prompts = ["give me json", "{"]
    jo, to = run(je, prompts, js), run(te, prompts, ts)
    for p, a, b in zip(prompts, jo, to):
        toks = te.tokenizer.encode(p)
        assert _guided_margins(je, toks, a.token_ids).min() > LOGIT_TOL
        assert b.token_ids == a.token_ids and b.error == a.error
        s = tg.JsonState()
        assert s.feed_text(b.text)  # every emitted prefix is JSON
        if b.error is None:
            assert isinstance(json.loads(b.text), dict)


def test_engine_guided_sampled_stays_in_grammar(engines):
    """Sampled guided requests beside a plain one: every prefix stays in
    the grammar, and a finished document parses and meets its schema."""
    _, te = engines
    schema = {"type": "object"}
    _, ts = sampling(max_tokens=60, temperature=1.0, seed=7, top_p=0.95,
                     response_format={"type": "json_schema",
                                      "json_schema": {"schema": schema}})
    _, plain = sampling(max_tokens=5)
    out, other = run(te, ["json please", "plain"], [ts, plain])
    assert tg.JsonState().feed_text(out.text)
    assert out.error is None or "complete" in out.error
    if out.error is None:
        assert tg.validate_schema(json.loads(out.text), schema) is None
    assert other.error is None and len(other.token_ids) >= 1
