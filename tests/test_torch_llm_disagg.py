"""Disaggregated prefill/decode in the port's LLM engine against
ray_tpu.llm on the CPU (the LLM helpers' tiny f32 GPT-2, params carried
by interop.params_from_jax): a prefill engine's ``prefill_detached``
record (first token equal; its K/V pages within 1e-5 of each tensor's
largest |value|, as tensors on the engine's device where ray_tpu returns
numpy), a decode engine's ``add_handoff_request`` of it (greedy tokens
equal to the monolithic engine's and to ray_tpu's, after the top-2
margin check), a ray_tpu record decoded by the port, the refusals, and
the engine's trace spans."""

import numpy as np
import pytest
import torch

from ray_tpu._private import traceplane as jtraceplane
from ray_tpu._private import worker_context as jwc
from ray_tpu_torch._private import traceplane
from ray_tpu_torch._private import worker_context as twc
from torch_llm_helpers import assert_same, engine_pair, run, sampling

PAGE = 8
# 4 to 40 tokens: one page to five.
PROMPTS = [[65 + i, 66, 67, 68 + 2 * i] for i in range(2)] + [
    list(range(70, 83)), list(range(30, 70))]
KV_TOL = 1e-5


@pytest.fixture(scope="module")
def engines():
    """(ray_tpu prefill, port prefill, ray_tpu decode, port decode,
    ray_tpu monolithic, port monolithic), all paged on the same params."""
    jp, tp = engine_pair(max_num_seqs=4, kv_page_size=PAGE)
    jd, td = engine_pair(max_num_seqs=4, kv_page_size=PAGE)
    jm, tm = engine_pair(max_num_seqs=4, kv_page_size=PAGE)
    return jp, tp, jd, td, jm, tm


def _decode(eng, records, sp):
    ids = [f"h{i}" for i in range(len(records))]
    for rid, rec in zip(ids, records):
        eng.add_handoff_request(rid, rec, sp)
    done = {}
    while eng.has_unfinished():
        for out in eng.step():
            done[out.request_id] = out
    return [done[rid] for rid in ids]


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_prefill_record_matches_reference(engines, i):
    jp, tp = engines[:2]
    jsp, tsp = sampling(max_tokens=8, ignore_eos=True)
    jrec, trec = jp.prefill_detached(PROMPTS[i], jsp), tp.prefill_detached(PROMPTS[i], tsp)
    assert trec["first_token"] == jrec["first_token"]
    assert {k: v for k, v in trec.items() if k not in ("k", "v", "sealed_at")} == {
        k: v for k, v in jrec.items() if k not in ("k", "v", "sealed_at")}
    for key in ("k", "v"):
        got, want = trec[key], np.asarray(jrec[key])
        assert isinstance(got, torch.Tensor) and got.device == tp.device
        assert tuple(got.shape) == want.shape == (
            tp.model_config.n_layers, -(-len(PROMPTS[i]) // PAGE), PAGE,
            tp.model_config.kv_heads, tp.model_config.head_dim)
        assert np.abs(got.numpy() - want).max() <= KV_TOL * np.abs(want).max()
    # the slot and its pages were freed
    assert all(s is None for s in tp.slots)
    assert tp.kv_alloc.num_free == jp.kv_alloc.num_free


def test_handoff_decode_matches_monolithic_and_reference(engines):
    jp, tp, jd, td, jm, tm = engines
    jsp, tsp = sampling(max_tokens=12, ignore_eos=True)
    jrecs = [jp.prefill_detached(p, jsp) for p in PROMPTS]
    trecs = [tp.prefill_detached(p, tsp) for p in PROMPTS]
    jout, tout = _decode(jd, jrecs, jsp), _decode(td, trecs, tsp)
    mono = run(tm, PROMPTS, tsp)
    assert_same(jd, jout, tout, PROMPTS)
    assert [o.token_ids for o in tout] == [o.token_ids for o in mono]
    assert [o.finish_reason for o in tout] == [o.finish_reason for o in mono]
    # ray_tpu's own records (numpy K/V) decode to the same tokens here
    assert [o.token_ids for o in _decode(td, jrecs, tsp)] == [o.token_ids for o in tout]
    assert td.kv_alloc.num_free == jd.kv_alloc.num_free


def test_handoff_refusals_match_reference(engines):
    jp, tp, jd, td = engines[:4]
    jsp, tsp = sampling(max_tokens=4)
    trec = tp.prefill_detached(PROMPTS[0], tsp)
    jrec = jp.prefill_detached(PROMPTS[0], jsp)
    bad = [
        lambda r: {k: v for k, v in r.items() if k != "k"},
        lambda r: dict(r, page_size=PAGE * 2),
        lambda r: dict(r, k=r["k"][:, :, :PAGE // 2]),
        lambda r: dict(r, lora="adapter"),
    ]
    for make in bad:
        errors = []
        for eng, rec, sp in ((jd, jrec, jsp), (td, trec, tsp)):
            with pytest.raises(ValueError) as e:
                eng.add_handoff_request("x", make(rec), sp)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    guided = {"response_format": {"type": "json_object"}}
    errors = []
    for eng, sp in ((jp, sampling(**guided)[0]), (tp, sampling(**guided)[1])):
        with pytest.raises(ValueError) as e:
            eng.prefill_detached(PROMPTS[0], sp)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    dense = engine_pair(max_num_seqs=2)
    errors = []
    for eng, sp in zip(dense, sampling()):
        with pytest.raises(ValueError) as e:
            eng.prefill_detached(PROMPTS[0], sp)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_spans_match_reference(engines, monkeypatch):
    """A traced request gets the engine's spans: llm.prefill with
    handoff on the prefill engine, llm.decode on the decode engine, and
    llm.prefill then llm.decode on a monolithic one; names and attributes
    as ray_tpu's. An untraced request gets none."""
    jp, tp, jd, td, jm, tm = engines
    got = {"ray_tpu": [], "port": []}
    monkeypatch.setattr(jtraceplane, "buffer_span", lambda s: got["ray_tpu"].append(s))
    monkeypatch.setattr(traceplane, "buffer_span", lambda s: got["port"].append(s))
    ctx = ("a" * 32, "b" * 16, 1)
    for key, wc, (p, d, m), sp in (("ray_tpu", jwc, (jp, jd, jm), sampling(max_tokens=3)[0]),
                                   ("port", twc, (tp, td, tm), sampling(max_tokens=3)[1])):
        token = wc._trace_context.set(ctx)
        try:
            rec = p.prefill_detached(PROMPTS[2], sp)
            _decode(d, [rec], sp)
            run(m, [PROMPTS[2]], sp)
        finally:
            wc._trace_context.reset(token)
        run(m, [PROMPTS[2]], sp)  # untraced: no span
    shape = {k: [(s["name"], s["kind"], s["trace_id"], s["parent_span_id"],
                  sorted(s["attributes"]), s["attributes"].get("handoff"),
                  s["attributes"].get("finish_reason")) for s in v]
             for k, v in got.items()}
    assert [s[0] for s in shape["port"]] == ["llm.prefill", "llm.decode", "llm.prefill",
                                             "llm.decode"]
    assert shape["port"] == shape["ray_tpu"]
    assert all(s["end"] >= s["start"] for s in got["port"])
