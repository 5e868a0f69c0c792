"""Tensor- and pipeline-parallel serving in the port (ray_tpu_torch.llm's
engine with tensor_parallel_size=2 or pipeline_parallel_size=2, one
engine on each of 2 gloo CPU ranks) against ray_tpu's tp=2 and pp=2
engines on the conftest's 8-device CPU mesh, from the same parameters
(tests/torch_llm_helpers.py: tiny, vocab 512, f32).

Greedy tokens are compared exactly after the top-2 margin check of every
step (over the penalized logits, or the merged-LoRA weights, where those
decide), and both ranks must produce the same outputs. The ranks' local
shards (kv heads of the cache, heads of wq, vocab rows of the embedding;
layers under pp) must be JAX's shard shapes, and every refusal must have
the JAX engine's exception type and message. The ranks are spawned once
for the file, in a thread while the JAX engines run.
"""

import concurrent.futures
import dataclasses
import types

import jax
import pytest

from ray_tpu.llm import LLMConfig as JConfig
from ray_tpu.llm import LLMEngine as JEngine
from ray_tpu.models import transformer as J
from ray_tpu_torch.parallel import _spawn
import torch_llm_parallel_cases as cases
from torch_llm_helpers import (GEOMETRY, JMODEL, assert_same, base_params, run,
                               sampling)
from test_torch_llm_lora import _adapter, _merged
from test_torch_llm_spec import _save_npz

RANKS = 2
PROMPTS = ["hello world", "abc", "the quick brown fox", "pack my box"]
# Two waves sharing a 24-token prefix (the second wave hits the cache).
SHARED = "a shared system prompt: "
PREFIX_WAVES = [[SHARED + "one"], [SHARED + "two", SHARED + "three!"]]
PENALIZED = dict(max_tokens=8, repetition_penalty=1.3, presence_penalty=0.5,
                 frequency_penalty=0.25, logit_bias=((65, 2.0),))
# Greedy with logprobs, and a seeded sampled request (its stream cannot be
# jax.random's; its first token, drawn on the host, is the JAX engine's).
LOGPROBS = dict(max_tokens=6, logprobs=3)
SEEDED = dict(max_tokens=8, temperature=0.9, top_k=20, top_p=0.95, seed=1234, logprobs=2)
DRAFT = J.tiny(vocab_size=512, max_seq_len=128, dtype="float32", n_layers=1,
               d_model=32, n_heads=2)
ADAPTER = dict(seed=1, scale=2.0)
LORA_SCALE = 16.0 / 4  # alpha / rank


def _waves(kind):
    """[(prompt, SamplingParams kwargs)] per wave for each case."""
    greedy = dict(max_tokens=8)
    if kind == "prefix":
        return [[(p, greedy) for p in w] for w in PREFIX_WAVES]
    if kind == "penalized":
        return [[(p, greedy) for p in PROMPTS], [(p, PENALIZED) for p in PROMPTS[:2]],
                [(PROMPTS[0], LOGPROBS), ("seeded", SEEDED)]]
    if kind == "lora":
        return [[(p, dict(greedy, extra=e)) for p, e in
                 zip(PROMPTS[:3], ({}, {"lora": "a1"}, {"lora": "a1"}))]]
    return [[(p, greedy) for p in PROMPTS]]


# name: (engine options, waves, adapters)
SERVE = {
    "tp": (dict(tensor_parallel_size=2), "penalized"),
    "tp_prefix": (dict(tensor_parallel_size=2, enable_prefix_caching=True,
                       prefix_block=8), "prefix"),
    "tp_chunk": (dict(tensor_parallel_size=2, prefill_chunk=8), "plain"),
    "tp_spec": (dict(tensor_parallel_size=2, speculative_model=DRAFT,
                     num_speculative_tokens=3), "plain"),
    "tp_lora": (dict(tensor_parallel_size=2, max_num_seqs=4,
                     lora={"max_adapters": 2, "max_rank": 8}), "lora"),
    "pp": (dict(pipeline_parallel_size=2), "penalized"),
}

# What both engines refuse (tests/test_llm.py:133-135, :306-315, and the
# engine's other checks): built with 2 ranks in the port, 8 devices in JAX.
REFUSE = {
    "tp_heads": dict(tensor_parallel_size=3),
    "pp_layers": dict(pipeline_parallel_size=5),
    "pp_tp": dict(pipeline_parallel_size=2, tensor_parallel_size=2),
    "pp_prefix": dict(pipeline_parallel_size=2, enable_prefix_caching=True),
    "pp_chunk": dict(pipeline_parallel_size=2, prefill_chunk=8),
    "pp_spec": dict(pipeline_parallel_size=2, speculative_model=DRAFT),
    "pp_paged": dict(pipeline_parallel_size=2, kv_page_size=8),
    "tp_paged": dict(tensor_parallel_size=2, kv_page_size=8),
    "pp_lora": dict(pipeline_parallel_size=2, lora={"max_adapters": 2}),
}


def _draft_npz(tmp):
    """DRAFT's params from PRNGKey(1), in the .npz both engines read."""
    return _save_npz(J.init_params(jax.random.PRNGKey(1), DRAFT), tmp / "draft.npz")


def _options(kw, draft_path, *, port: bool):
    """The engine options of a case for one side: the draft's checkpoint
    added, its config as a dict for the ranks."""
    kw = {**GEOMETRY, **kw}
    if "speculative_model" in kw:
        kw["speculative_checkpoint_path"] = draft_path
        if port:
            kw["speculative_model"] = dataclasses.asdict(kw["speculative_model"])
    return kw


def _adapters():
    return {"a1": (_adapter(ADAPTER["seed"], scale=ADAPTER["scale"]), 16.0)}


def _jax_serve(jp, kw, waves, adapters):
    eng = JEngine(JConfig(model=JMODEL, **kw), jp)
    for name, (factors, alpha) in (adapters or {}).items():
        eng.add_lora(name, factors, alpha=alpha)
    outs = [run(eng, [p for p, _ in w], [sampling(**s)[0] for _, s in w],
                ids=[f"w{i}r{j}" for j in range(len(w))])
            for i, w in enumerate(waves)]
    return eng, outs


def _jax_refuse(jp, kw):
    try:
        JEngine(JConfig(model=JMODEL, **kw), jp)
    except Exception as e:  # noqa: BLE001 - compared with the port's
        return [type(e).__name__, str(e)]
    return None


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX engines and outputs per case, the port's results per case
    on every rank)."""
    tmp = tmp_path_factory.mktemp("llm_parallel")
    draft = _draft_npz(tmp)
    jp, _ = base_params()
    host = jax.device_get(jp)
    config = dataclasses.asdict(JMODEL)
    port_cases = {}
    for name, (kw, kind) in SERVE.items():
        port_cases[name] = ("serve", dict(
            config=config, params=host, kw=_options(kw, draft, port=True),
            waves=_waves(kind), adapters=_adapters() if kind == "lora" else None))
    for name, kw in REFUSE.items():
        port_cases["refuse_" + name] = ("refuse", dict(
            config=config, params=host, kw=_options(kw, draft, port=True)))
    port_cases["refuse_ranks"] = ("refuse", dict(
        config=config, params=host, kw=_options(dict(tensor_parallel_size=4), draft,
                                                port=True)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(_spawn.run, cases.run, RANKS, port_cases, timeout=300)
    jax_out = {}
    for name, (kw, kind) in SERVE.items():
        jax_out[name] = _jax_serve(jp, _options(kw, draft, port=False), _waves(kind),
                                   _adapters() if kind == "lora" else None)
    refusals = {name: _jax_refuse(jp, _options(kw, draft, port=False))
                for name, kw in REFUSE.items()}
    per_rank = future.result()
    pool.shutdown()
    port = {name: [r[name] for r in per_rank] for name in per_rank[0]}
    yield types.SimpleNamespace(jax=jax_out, refusals=refusals, port=port, params=jp)


def _outputs(result):
    """A port rank's waves as RequestOutput-like objects."""
    return [[types.SimpleNamespace(token_ids=list(t), finish_reason=f, text=x, logprobs=lp)
             for t, f, x, lp in wave] for wave in result["waves"]]


def _check_case(both, name, *, ref=None):
    je, jouts = both.jax[name]
    kind = SERVE[name][1]
    ranks = both.port[name]
    assert ranks[0]["waves"] == ranks[1]["waves"]  # every rank decided alike
    for wave, jo, to in zip(_waves(kind), jouts, _outputs(ranks[0])):
        for (p, s), a, b in zip(wave, jo, to):
            if s.get("temperature", 0.0) > 0.0:
                assert b.token_ids[0] == a.token_ids[0]  # the host's draw
                assert [e["token_id"] for e in b.logprobs] == b.token_ids
                continue
            sp = sampling(**s)[0] if "repetition_penalty" in s else None
            assert_same(ref(s) if ref else je, [a], [b], [p], sp)
            for ea, eb in zip(a.logprobs or [], b.logprobs or []):
                assert abs(eb["logprob"] - ea["logprob"]) < 1e-4
                assert list(eb["top"]) == list(ea["top"])
            assert (a.logprobs is None) == (b.logprobs is None)
    return je, ranks


@pytest.mark.parametrize("name", ["tp", "tp_prefix", "tp_chunk", "pp"])
def test_engine_matches_jax(both, name):
    """The port's tp=2 / pp=2 engine gives the JAX tp=2 / pp=2 engine's
    tokens on every rank (greedy, and greedy under penalties and
    logit_bias through the extended sampling program, with logprobs
    within 1e-4 and the same top ids; a seeded request's first token)."""
    _check_case(both, name)


def test_prefix_cache_hits_under_tp(both):
    je, ranks = _check_case(both, "tp_prefix")
    assert ranks[0]["prefix_hits"] == je.prefix_cache_hits > 0


def test_speculative_decoding_under_tp(both):
    """A 1-layer draft from one .npz, the tp=2 target: the JAX engine's
    tokens and acceptance counts."""
    je, ranks = _check_case(both, "tp_spec")
    assert ranks[0]["spec"] == je.spec_stats
    assert je.spec_stats["spec_steps"] > 0


def test_lora_under_tp(both):
    """A base request and two adapter requests in one batch: the JAX tp=2
    engine's tokens, each adapter request margin-checked on the weights
    with the adapter merged in."""
    je, _ = both.jax["tp_lora"]
    merged = types.SimpleNamespace(
        params=_merged(je.params, _adapter(ADAPTER["seed"], scale=ADAPTER["scale"]),
                       LORA_SCALE),
        model_config=je.model_config, tokenizer=je.tokenizer, max_len=je.max_len)
    _, ranks = _check_case(both, "tp_lora",
                           ref=lambda s: merged if s.get("extra") else je)
    waves = _outputs(ranks[0])[0]
    assert waves[1].token_ids != waves[0].token_ids


@pytest.mark.parametrize("name", ["tp", "tp_prefix", "tp_chunk", "tp_spec", "tp_lora"])
def test_tp_shards_like_jax(both, name):
    """Each rank's cache holds kv_heads/2 heads, its wq heads/2 and its
    embedding vocab/2 rows: the JAX engine's shard shapes."""
    je, _ = both.jax[name]
    for r in both.port[name]:
        assert r["mesh"] == {"tensor": 2} == dict(je.mesh.shape)
        k = je.cache["k"]
        assert r["cache_k"] == list(k.sharding.shard_shape(k.shape))
        assert r["cache_k"][3] == JMODEL.kv_heads // 2
        for key, leaf in (("wq", je.params["layers"]["attn"]["wq"]),
                          ("embed", je.params["embed"]["tokens"])):
            assert r[key] == list(leaf.sharding.shard_shape(leaf.shape))


def test_pp_shards_like_jax(both):
    """Each stage holds n_layers/2 layers of the cache and of wq, and the
    whole embedding: the JAX engine's shard shapes."""
    je, _ = both.jax["pp"]
    wq, k = je.params["layers"]["attn"]["wq"], je.cache["k"]
    for r in both.port["pp"]:
        assert r["mesh"] is None and je.mesh is None
        assert r["cache_k"] == list(k.sharding.shard_shape(k.shape))
        assert r["cache_k"][0] == JMODEL.n_layers // 2
        assert r["wq"] == list(wq.sharding.shard_shape(wq.shape))
        assert r["embed"] == [JMODEL.vocab_size, JMODEL.d_model]


@pytest.mark.parametrize("name", sorted(REFUSE))
def test_refusals_match_jax(both, name):
    """The port refuses what the JAX engine refuses, with its exception
    type and message, on every rank."""
    want = both.refusals[name]
    assert want is not None
    for got in both.port["refuse_" + name]:
        assert got == want


def test_too_few_ranks_raises(both):
    """tensor_parallel_size=4 on a group of 2 ranks: ValueError, the
    counterpart of the JAX engine's "only N devices visible"."""
    for got in both.port["refuse_ranks"]:
        assert got == ["ValueError",
                       "tensor_parallel_size=4 but only 2 ranks in the process group"]
