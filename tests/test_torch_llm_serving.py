"""The port's OpenAI-style serving (ray_tpu_torch.llm.serving) against
ray_tpu's: both LLMServers on the same parameters (torch_llm_helpers'
tiny f32 model), over completions (a string, token ids, a list of
prompts), chat, streams, tokenize/detokenize, the model listing,
logprobs, n > 1 and LoRA payloads. Greedy tokens are compared exactly
after the top-2 margin check of each step, logprobs within 1e-4, and
the response fields must be equal apart from ids and timestamps. Then,
on a port cluster on the CPU, the disaggregated app's tokens must equal
the dense app's, and the replicas' ray_tpu_llm_* and the controller's
ray_tpu_serve_* gauges must be set (their error handlers would hide a
broken util.metrics otherwise). Every await and result is bounded."""

import asyncio
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.llm.serving import LLMServer as JServer
from ray_tpu_torch.llm import LLMConfig, SamplingParams
from ray_tpu_torch.llm.serving import LLMServer as TServer
from torch_llm_helpers import (GEOMETRY, JMODEL, TMODEL, JConfig, assert_decided,
                               base_params)

LP_TOL = 1e-4
T = 60  # seconds for every await, result and HTTP call
LORA = {"max_adapters": 4, "max_rank": 8}
HDH = JMODEL.n_heads * JMODEL.head_dim


def _adapter_npz(path):
    rng = np.random.default_rng(7)
    L, d = JMODEL.n_layers, JMODEL.d_model
    a = {"wq.A": rng.standard_normal((L, d, 4)).astype(np.float32),
         "wq.B": rng.standard_normal((L, 4, HDH)).astype(np.float32),
         "wv.A": rng.standard_normal((L, d, 4)).astype(np.float32),
         "wv.B": rng.standard_normal((L, 4, HDH)).astype(np.float32)}
    np.savez(path, **a)
    return str(path), a


def _merged(params, factors, scale):
    attn = dict(params["layers"]["attn"])
    for t in ("wq", "wv"):
        w = attn[t]
        delta = np.einsum("ldr,lro->ldo", factors[f"{t}.A"], factors[f"{t}.B"]) * scale
        attn[t] = w + jnp.asarray(delta.reshape(w.shape))
    return {**params, "layers": {**params["layers"], "attn": attn}}


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server) on the same parameters, with LoRA."""
    jp, tp = base_params()
    kw = dict(GEOMETRY, max_num_seqs=8, lora=LORA)
    js = JServer(JConfig(model=JMODEL, **kw), jp)
    ts = TServer(LLMConfig(model=TMODEL, **kw), tp, device="cpu")
    return js, ts


def _call(server, payload, path=None):
    coro = (server.route_request(path, payload) if path else server(payload))
    return asyncio.run(asyncio.wait_for(coro, T))


def _strip(resp):
    """A response without its id and timestamp."""
    if isinstance(resp, dict):
        return {k: _strip(v) for k, v in resp.items() if k not in ("id", "created")}
    if isinstance(resp, list):
        return [_strip(v) for v in resp]
    return resp


def _check_margins(js, payload, prompts, ref=None):
    """The JAX engine's greedy tokens for each prompt have a clear top-2
    margin at every step (against ``ref``'s weights when given)."""
    sp = js._sampling(payload)
    for p in prompts:
        toks = js.engine.tokenizer.encode(p) if isinstance(p, str) else list(p)
        out = js.engine.generate([p], sp)[0]
        assert_decided(ref or js.engine, toks, out.token_ids)


COMPLETIONS = {
    "string": {"prompt": "hello world", "max_tokens": 8},
    "token_ids": {"prompt": [72, 105, 33], "max_tokens": 6},
    "several": {"prompt": ["aa", "the quick brown fox", "lora!"], "max_tokens": 5},
    "ignore_eos": {"prompt": "serve me", "max_tokens": 10, "ignore_eos": True},
}


@pytest.mark.parametrize("name", sorted(COMPLETIONS))
def test_completion_matches_reference(servers, name):
    js, ts = servers
    payload = COMPLETIONS[name]
    prompt = payload["prompt"]
    prompts = (prompt if isinstance(prompt, list) and not isinstance(prompt[0], int)
               else [prompt])
    _check_margins(js, payload, prompts)
    jr, tr = _call(js, payload), _call(ts, payload)
    assert _strip(tr) == _strip(jr)
    assert tr["object"] == "text_completion" and len(tr["choices"]) == len(prompts)


def test_chat_and_stream_match_reference(servers):
    js, ts = servers
    payload = {"messages": [{"role": "system", "content": "be brief"},
                            {"role": "user", "content": "hi there"}], "max_tokens": 8}
    _check_margins(js, payload, [js._render_chat(payload["messages"])])
    jr, tr = _call(js, payload), _call(ts, payload)
    assert _strip(tr) == _strip(jr)
    assert tr["choices"][0]["message"]["role"] == "assistant"

    async def chunks(server):
        return [c async for c in server.stream_events({**payload, "stream": True})]

    jc = asyncio.run(asyncio.wait_for(chunks(js), T))
    tc = asyncio.run(asyncio.wait_for(chunks(ts), T))
    assert _strip(tc) == _strip(jc) and tc[-1] == "[DONE]"
    joined = "".join(c["choices"][0]["delta"].get("content", "") for c in tc[:-1])
    assert joined == tr["choices"][0]["message"]["content"]


def test_tokenize_detokenize_and_models(servers):
    js, ts = servers
    for path, payload in (("/v1/tokenize", {"prompt": "héllo"}),
                          ("/v1/tokenize", {"prompt": "x", "add_special_tokens": False}),
                          ("/v1/tokenize", {"messages": [{"role": "user", "content": "a"}]}),
                          ("/v1/detokenize", {"tokens": [104, 105, 33]}),
                          ("/v1/models", {})):
        assert _call(ts, payload, path) == _call(js, payload, path), (path, payload)
    assert _call(ts, {})["data"][0]["id"] == "tiny"


def test_logprobs_within_tolerance(servers):
    js, ts = servers
    payload = {"prompt": "logprobs please", "max_tokens": 6, "logprobs": 3}
    _check_margins(js, payload, [payload["prompt"]])
    jr, tr = _call(js, payload), _call(ts, payload)
    jl, tl = jr["choices"][0]["logprobs"], tr["choices"][0]["logprobs"]
    assert tl["tokens"] == jl["tokens"]
    np.testing.assert_allclose(tl["token_logprobs"], jl["token_logprobs"], atol=LP_TOL)
    for a, b in zip(tl["top_logprobs"], jl["top_logprobs"]):
        assert set(a) == set(b)
        np.testing.assert_allclose([a[k] for k in b], list(b.values()), atol=LP_TOL)
    strip = lambda r: {**_strip(r), "choices": [  # noqa: E731
        {k: v for k, v in c.items() if k != "logprobs"} for c in r["choices"]]}
    assert strip(tr) == strip(jr)


def test_tokens_as_token_ids(servers):
    """vLLM's return_tokens_as_token_ids (the port's addition): the
    logprobs block names each token "token_id:<id>", the JAX engine's
    greedy ids; the rest of the response is the reference's."""
    js, ts = servers
    payload = {"prompt": "ids please", "max_tokens": 6, "logprobs": 1}
    want = js.engine.generate([payload["prompt"]], js._sampling(payload))[0].token_ids
    _check_margins(js, payload, [payload["prompt"]])
    tr = _call(ts, {**payload, "return_tokens_as_token_ids": True})
    lp = tr["choices"][0]["logprobs"]
    assert lp["tokens"] == [f"token_id:{i}" for i in want]
    assert all(k.startswith("token_id:") for top in lp["top_logprobs"] for k in top)
    jr = _call(js, payload)
    assert [c["text"] for c in tr["choices"]] == [c["text"] for c in jr["choices"]]
    chat = _call(ts, {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                      "logprobs": 1, "return_tokens_as_token_ids": True})
    assert all(e["token"].startswith("token_id:")
               for e in chat["choices"][0]["logprobs"]["content"])


def test_n_and_best_of_fields_and_refusals(servers):
    """Sampled (n > 1 needs temperature > 0) draws differ between the
    frameworks' generators; the response's shape, usage of the prompt
    and the refusals must not."""
    js, ts = servers
    payload = {"prompt": ["a", "b"], "n": 2, "best_of": 3, "temperature": 0.9,
               "max_tokens": 4, "ignore_eos": True, "seed": 5}
    jr, tr = _call(js, payload), _call(ts, payload)
    assert [c["index"] for c in tr["choices"]] == [c["index"] for c in jr["choices"]] \
        == [0, 1, 2, 3]
    assert tr["usage"] == jr["usage"]  # ignore_eos: 2 prompts x 3 samples x 4 tokens
    assert {k for c in tr["choices"] for k in c} == {k for c in jr["choices"] for k in c}
    for bad in ({"prompt": "x", "n": 3, "best_of": 2}, {"prompt": "x", "n": 2},
                {"prompt": "x", "best_of": 0, "temperature": 0.9}):
        with pytest.raises(ValueError) as je:
            _call(js, bad)
        with pytest.raises(ValueError) as te:
            _call(ts, bad)
        assert str(te.value) == str(je.value)


def test_lora_payload_matches_reference(servers, tmp_path):
    js, ts = servers
    path, factors = _adapter_npz(tmp_path / "boost.npz")
    req = {"lora_name": "boost", "lora_path": path, "alpha": 8.0}
    assert _call(ts, req, "/v1/load_lora_adapter") == _call(js, req, "/v1/load_lora_adapter")
    payload = {"prompt": "hello world", "max_tokens": 8, "model": "tiny:boost"}
    merged = SimpleNamespace(params=_merged(js.engine.params, factors, 8.0 / 4),
                             model_config=JMODEL)
    _check_margins(js, payload, [payload["prompt"]], ref=merged)
    jr, tr = _call(js, payload), _call(ts, payload)
    assert _strip(tr) == _strip(jr)
    base = _call(ts, {**payload, "model": "tiny"})
    assert base["choices"][0]["text"] != tr["choices"][0]["text"]
    req = {"lora_name": "boost"}
    assert _call(ts, req, "/v1/unload_lora_adapter") == _call(
        js, req, "/v1/unload_lora_adapter")


def test_llm_gauges_are_set_in_process(servers):
    from ray_tpu_torch.llm import serving

    _, ts = servers
    snap = ts.serve_batch_stats()
    assert snap["owned"] == 0
    tags = (("pool", "mono"),)
    assert serving._LLM_GAUGES["queue_depth"]._values[tags] == float(snap["waiting"])
    assert tags in serving._LLM_GAUGES["hit_rate"]._values


# ----------------------------------------- a port cluster on the CPU


def _cluster_config(**kw):
    return LLMConfig(**{**dict(model=TMODEL, max_num_seqs=2, max_seq_len=48,
                               prefill_buckets=(8, 16, 32), kv_page_size=8,
                               sampling_defaults=SamplingParams(max_tokens=6)), **kw})


@pytest.fixture(scope="module")
def cluster_apps():
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_disaggregated_app, build_openai_app

    rt.init(num_cpus=8, object_store_memory=128 * 1024 * 1024,
            _system_config={"head_shards": 1})
    try:
        dense = serve.run(build_openai_app(_cluster_config(), name="dense", device="cpu"),
                          name="dense", route_prefix="/dense")
        dis = serve.run(build_disaggregated_app(_cluster_config(), name="dis",
                                                device="cpu"),
                        name="dis", route_prefix="/dis")
        yield rt, serve, dense, dis
    finally:
        serve.shutdown()
        rt.shutdown()


def test_builders_lease_a_gpu_for_cuda_replicas():
    from ray_tpu_torch.llm import build_disaggregated_app, build_openai_app

    app = build_openai_app(_cluster_config())
    assert app.deployment.config.ray_actor_options == {"num_gpus": 1}
    assert app.init_kwargs == {"device": "cuda"}
    app = build_disaggregated_app(_cluster_config(), ray_actor_options={"num_gpus": 0.5})
    pre, dec = app.children()
    assert pre.deployment.config.ray_actor_options == {"num_gpus": 0.5}
    assert dec.deployment.config.ray_actor_options == {"num_gpus": 0.5}
    assert app.deployment.config.ray_actor_options == {}  # the router holds no engine
    assert build_openai_app(_cluster_config(), device="cpu").deployment.config \
        .ray_actor_options == {}


IDS = {"logprobs": 1, "return_tokens_as_token_ids": True}


@pytest.mark.parametrize("payload", [
    {"prompt": "hello", "max_tokens": 4, **IDS},
    {"prompt": "the quick brown fox", "max_tokens": 6, "ignore_eos": True, **IDS},
    {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 5},
    {"prompt": ["aa", "bb", "cc"], "max_tokens": 3, **IDS},
])
def test_disaggregated_tokens_equal_dense(cluster_apps, payload):
    """The same tokens (by id where the payload asks for them) and text
    from the disaggregated app as from the dense one."""
    _, _, dense, dis = cluster_apps
    rd = dense.remote(payload).result(timeout_s=T)
    rs = dis.remote(payload).result(timeout_s=T)
    assert [c.get("text", c.get("message")) for c in rs["choices"]] \
        == [c.get("text", c.get("message")) for c in rd["choices"]]
    if "prompt" in payload:
        ids = [c["logprobs"]["tokens"] for c in rs["choices"]]
        assert ids == [c["logprobs"]["tokens"] for c in rd["choices"]]
        assert all(t.startswith("token_id:") for row in ids for t in row)
    assert rs["usage"] == rd["usage"]


def test_http_routes_reach_both_apps(cluster_apps):
    from tests.torch_serve_helpers import http

    _, serve, _, _ = cluster_apps
    port = serve.get_proxy_port()
    body = {"prompt": "over http", "max_tokens": 4}
    code_d, rd = http(port, "/dense/v1/completions", body, timeout=T)
    code_s, rs = http(port, "/dis/v1/completions", body, timeout=T)
    assert code_d == code_s == 200
    assert rs["choices"][0]["text"] == rd["choices"][0]["text"]
    assert http(port, "/dense/v1/models", timeout=T)[1]["data"][0]["id"] == "tiny"


def test_gauges_reach_the_head(cluster_apps):
    """The replicas' ray_tpu_llm_* gauges (one series per pool) and the
    controller's ray_tpu_serve_* gauges arrive in the head's table."""
    from ray_tpu_torch.util import metrics

    _, _, dense, dis = cluster_apps
    dense.remote({"prompt": "g", "max_tokens": 2}).result(timeout_s=T)
    dis.remote({"prompt": "g", "max_tokens": 2}).result(timeout_s=T)
    want = {"mono", "prefill", "decode"}
    deadline, pools = time.monotonic() + 30, set()
    while time.monotonic() < deadline:
        report = metrics.get_metrics_report()
        series = report.get("ray_tpu_llm_queue_depth", {}).get("series", {})
        pools = {dict(k).get("pool") for k in series}
        if want <= pools and "ray_tpu_serve_replicas" in report:
            break
        time.sleep(0.2)
    assert want <= pools, pools
    replicas = metrics.get_metrics_report()["ray_tpu_serve_replicas"]["series"]
    assert {dict(k)["deployment"]: v for k, v in replicas.items()
            if dict(k)["deployment"].startswith("dis")} == {
        "dis": 1.0, "dis-prefill": 1.0, "dis-decode": 1.0}


def test_handoff_stats_after_requests(cluster_apps):
    _, _, _, dis = cluster_apps
    dis.remote({"prompt": "count the handoff", "max_tokens": 3}).result(timeout_s=T)
    stats = dis.stats.remote().result(timeout_s=T)
    assert stats["handoff"]["count"] >= 1 and stats["handoff"]["bytes"] > 0
    assert stats["decode"]["owned"] == 0 and stats["prefill"]["owned"] == 0
