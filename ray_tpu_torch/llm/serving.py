"""OpenAI-compatible serving on top of ray_tpu_torch.serve.

Counterpart of the reference's ray.llm serving stack (reference:
python/ray/llm/_internal/serve/ — LLMServer deployment + router building
an OpenAI-compatible app over Serve; placement-group-backed engine
replicas, serve/deployments/llm/vllm/vllm_models.py:159). Here each
replica hosts the port's LLMEngine on ``device`` (the card unless the
caller asks for the CPU); requests hit the Serve HTTP proxy and are
dispatched by payload shape (the proxy forwards JSON bodies):

  {"messages": [...]}  → chat completion   (POST /v1/chat/completions)
  {"prompt": "..."}    → text completion   (POST /v1/completions)
  anything else        → model listing     (GET /v1/models)

A worker without a GPU lease sees no card (``CUDA_VISIBLE_DEVICES=""``),
so for a CUDA device ``build_openai_app`` and ``build_disaggregated_app``
give each replica ``{"num_gpus": 1}`` unless the caller passes its own
``ray_actor_options`` (fractions share one card). The reference builds
its replicas with no actor options. The disaggregated handoff record
crosses the object plane as the prefill engine's ``[L, n, page, KV,
Dh]`` tensors (host bytes, as the reference's numpy), not a device edge.
"""

from __future__ import annotations

import time
import uuid
from typing import Any

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine
from ray_tpu_torch.serve.deployment import deployment


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _encode_plain(tok, s: str) -> list[int]:
    """Encode without special tokens. Dispatch on type, NOT try/except:
    HF slow tokenizers silently swallow unknown kwargs like add_bos
    (they only log a warning), which would leave add_special_tokens=True
    and silently break single-token stop detection."""
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    if isinstance(tok, ByteTokenizer):
        return tok.encode(s, add_bos=False)
    return tok.encode(s, add_special_tokens=False)


# ray_tpu_llm_* gauges, shared by every pool flavor (mono / prefill /
# decode via the "pool" tag). Created lazily so importing this module
# never touches the metrics runtime; updated from serve_batch_stats(),
# which the replica's amortized get_metrics poll drives — the gauges
# ride frames that already exist, zero new per-call head traffic.
# Handoff BYTES intentionally have no gauge here: they ride the data
# plane's transfer counters (ray_tpu_object_bytes_transferred_total
# {path="handoff"}), which the prometheus exporter already emits.
_LLM_GAUGES: dict = {}


def _push_llm_gauges(pool: str, snap: dict) -> None:
    try:
        if not _LLM_GAUGES:
            from ray_tpu_torch.util.metrics import Gauge

            _LLM_GAUGES.update(
                hit_rate=Gauge(
                    "ray_tpu_llm_prefix_hit_rate",
                    "Prefix-cache hit rate (hits / lookups)",
                    tag_keys=("pool",)),
                pages_in_use=Gauge(
                    "ray_tpu_llm_kv_pages_in_use",
                    "KV pages currently allocated (paged engines)",
                    tag_keys=("pool",)),
                pages_free=Gauge(
                    "ray_tpu_llm_kv_pages_free",
                    "KV pages free in the pool (paged engines)",
                    tag_keys=("pool",)),
                queue_depth=Gauge(
                    "ray_tpu_llm_queue_depth",
                    "Requests waiting for a decode slot",
                    tag_keys=("pool",)),
            )
        g, tags = _LLM_GAUGES, {"pool": pool}
        kv = snap.get("kv") or {}
        queries = int(kv.get("prefix_queries") or 0)
        g["hit_rate"].set(
            (kv.get("prefix_hits", 0) / queries) if queries else 0.0, tags)
        g["queue_depth"].set(float(snap.get("waiting", 0)), tags)
        if kv.get("paged"):
            g["pages_in_use"].set(float(kv.get("pages_in_use", 0)), tags)
            g["pages_free"].set(float(kv.get("pages_free", 0)), tags)
    except Exception:  # noqa: BLE001 — telemetry must never fail serving
        pass


class LLMServer:
    """One engine per replica; scale via num_replicas in build_openai_app."""

    # Gauge tag: which pool this replica serves ("mono" = classic
    # colocated prefill+decode; subclasses override).
    POOL = "mono"

    def __init__(self, config: LLMConfig, params: Any = None, *,
                 device="cuda"):
        from ray_tpu_torch.llm.engine import AsyncLLMEngine

        self.config = config
        self.engine = LLMEngine(config, params, device=device)
        # Request-level continuous batching: concurrent HTTP requests on
        # this (async) replica join the engine's running batch instead
        # of serializing whole generate() calls.
        self.async_engine = AsyncLLMEngine(self.engine)

    @staticmethod
    def _deadline() -> "float | None":
        """The serving deadline for the current request (replica stamps
        it from the handle's timeout before user code runs). Carried
        into the decode loop so expired requests are EVICTED mid-decode
        instead of finishing tokens nobody will read."""
        from ray_tpu_torch.serve.scheduler import get_request_deadline

        return get_request_deadline()

    def serve_batch_stats(self) -> dict:
        """Replica telemetry hook (Replica.get_metrics → ``engine``
        block): the token-level continuous-batching view. Also refreshes
        the ray_tpu_llm_* gauges — piggybacked here so gauge updates
        amortize onto the controller's existing metrics poll."""
        snap = self.async_engine.snapshot()
        _push_llm_gauges(self.POOL, snap)
        return snap

    def kv_snapshot(self) -> dict:
        """RPC surface for router/bench aggregation (the telemetry hook
        above is pull-only via the controller)."""
        return self.async_engine.snapshot()

    # -- OpenAI schema helpers --------------------------------------------

    def _sampling(self, payload: dict) -> SamplingParams:
        d = self.config.sampling_defaults
        stop_ids = tuple(payload.get("stop_token_ids", d.stop_token_ids))
        # OpenAI "stop" strings: single-token stops detect on the id
        # (cheap, no detokenization); multi-token stops go through the
        # engine's stop-string matcher.
        stop_strings: tuple[str, ...] = tuple(d.stop)
        for s in _as_list(payload.get("stop")):
            toks = _encode_plain(self.engine.tokenizer, s)
            if len(toks) == 1:
                stop_ids += (toks[0],)
            else:
                stop_strings += (s,)
        # OpenAI: logprobs (bool) + top_logprobs (int); vLLM: logprobs=N.
        # Clamped to the engine cap (OpenAI itself caps top_logprobs at 20).
        from ray_tpu_torch.llm.engine import MAX_LOGPROBS

        lp = payload.get("logprobs", d.logprobs)
        if isinstance(lp, bool):
            lp = int(payload.get("top_logprobs", 1)) if lp else 0
        lp = min(int(lp or 0), MAX_LOGPROBS)
        seed = payload.get("seed", d.seed)
        return SamplingParams(
            max_tokens=int(payload.get("max_tokens", d.max_tokens)),
            temperature=float(payload.get("temperature", d.temperature)),
            top_k=int(payload.get("top_k", d.top_k)),
            top_p=float(payload.get("top_p", d.top_p)),
            min_p=float(payload.get("min_p", d.min_p)),
            presence_penalty=float(payload.get("presence_penalty",
                                               d.presence_penalty)),
            frequency_penalty=float(payload.get("frequency_penalty",
                                                d.frequency_penalty)),
            repetition_penalty=float(payload.get("repetition_penalty",
                                                 d.repetition_penalty)),
            seed=(int(seed) if seed is not None else None),
            logprobs=int(lp or 0),
            stop_token_ids=stop_ids,
            stop=stop_strings,
            min_tokens=int(payload.get("min_tokens", d.min_tokens)),
            ignore_eos=bool(payload.get("ignore_eos", d.ignore_eos)),
            # OpenAI logit_bias arrives as {"token_id": bias} with
            # string keys.
            logit_bias=tuple(
                (int(k), float(v))
                for k, v in (payload.get("logit_bias") or {}).items()
            ) or d.logit_bias,
            # OpenAI response_format (json mode / json-schema mode):
            # enforced by the engine's guided decoder.
            response_format=payload.get("response_format",
                                        d.response_format),
            # Multi-LoRA: model "<model_id>:<adapter>" selects a loaded
            # adapter for this request (vLLM-style per-request LoRA).
            extra=self._lora_extra(payload),
        )

    def _lora_extra(self, payload: dict) -> dict:
        """Merged SamplingParams.extra: configured defaults, plus the
        model-suffix adapter selector — only when this engine actually
        serves adapters (a ':' in a model id must not be hijacked on a
        lora-less deployment)."""
        d = self.config.sampling_defaults
        extra = dict(d.extra or {})
        model = payload.get("model") or ""
        if (isinstance(model, str) and ":" in model
                and getattr(self.engine, "lora_mgr", None) is not None):
            extra["lora"] = model.split(":", 1)[1]
        return extra

    def load_lora_adapter(self, payload: dict) -> dict:
        """Dynamic adapter load (reference: LoraConfig
        dynamic_lora_loading_path; vLLM /v1/load_lora_adapter)."""
        self.engine.add_lora(payload["lora_name"], payload["lora_path"],
                             alpha=float(payload.get("alpha", 16.0)))
        return {"loaded": self.engine.list_loras()}

    def unload_lora_adapter(self, payload: dict) -> dict:
        removed = self.engine.remove_lora(payload["lora_name"])
        return {"removed": removed, "loaded": self.engine.list_loras()}

    def _render_chat(self, messages: list[dict]) -> str:
        # Minimal chat template (byte tokenizer has no special chat tokens).
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        parts.append("assistant:")
        return "\n".join(parts)

    def _usage(self, outs: list) -> dict:
        p = sum(o.num_prompt_tokens for o in outs)
        c = sum(len(o.token_ids) for o in outs)
        return {"prompt_tokens": p, "completion_tokens": c,
                "total_tokens": p + c}

    # -- entrypoint (Serve routes JSON bodies here) -----------------------

    async def __call__(self, payload: Any = None) -> dict:
        payload = payload if isinstance(payload, dict) else {}
        if "messages" in payload:
            return await self.chat(payload)
        if "prompt" in payload:
            return await self.completions(payload)
        return self.models()

    async def route_request(self, path: str, payload: Any = None) -> dict:
        """Path-aware dispatch (the proxy passes the subpath below the
        route prefix — real OpenAI URL routing instead of payload-shape
        inference; reference: serve router URL dispatch +
        vLLM's /tokenize /detokenize API)."""
        payload = payload if isinstance(payload, dict) else {}
        p = path.rstrip("/")
        if p.endswith("/chat/completions"):
            return await self.chat(payload)
        if p.endswith("/completions"):
            return await self.completions(payload)
        if p.endswith("/models"):
            return self.models()
        if p.endswith("/tokenize"):
            return self.tokenize(payload)
        if p.endswith("/detokenize"):
            return self.detokenize(payload)
        if p.endswith("/load_lora_adapter"):
            return self.load_lora_adapter(payload)
        if p.endswith("/unload_lora_adapter"):
            return self.unload_lora_adapter(payload)
        # Unknown subpath: fall back to shape dispatch (old clients).
        return await self.__call__(payload)

    def tokenize(self, payload: dict) -> dict:
        """vLLM-compatible POST /tokenize: {"prompt"} -> token ids
        (chat form renders the messages through the chat template
        first)."""
        if "messages" in payload:
            text = self._render_chat(payload["messages"])
        else:
            text = payload.get("prompt", "")
        add_special = bool(payload.get("add_special_tokens", True))
        tok = self.engine.tokenizer
        ids = (list(tok.encode(text)) if add_special
               else _encode_plain(tok, text))
        return {"tokens": ids, "count": len(ids),
                "max_model_len": self.config.max_seq_len}

    def detokenize(self, payload: dict) -> dict:
        """vLLM-compatible POST /detokenize: {"tokens"} -> text."""
        ids = [int(t) for t in payload.get("tokens", [])]
        return {"prompt": self.engine.tokenizer.decode(ids)}

    async def stream_events(self, payload: Any = None):
        """OpenAI streaming protocol handler (``"stream": true``): an
        async generator of chunk objects, terminated by the literal
        "[DONE]" sentinel (the proxy emits it unquoted). Routed here by
        the HTTP proxy for SSE requests — __call__ stays the plain JSON
        path."""
        payload = payload if isinstance(payload, dict) else {}
        is_chat = "messages" in payload
        if not is_chat and "prompt" not in payload:
            yield self.models()
            return
        if int(payload.get("n", 1)) > 1 or payload.get("best_of"):
            raise ValueError("streaming supports n=1 without best_of")
        sp = self._sampling(payload)
        prompt = (self._render_chat(payload["messages"]) if is_chat
                  else payload["prompt"])
        if isinstance(prompt, list) and prompt and not all(
                isinstance(t, int) for t in prompt):
            raise ValueError("streaming supports a single prompt")
        rid = f"{'chatcmpl' if is_chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        base = {
            "id": rid,
            "object": ("chat.completion.chunk" if is_chat
                       else "text_completion"),
            "created": created,
            "model": self.config.model_id,
        }
        if is_chat:
            yield {**base, "choices": [{
                "index": 0, "delta": {"role": "assistant", "content": ""},
                "finish_reason": None}]}
        toks: list[int] = []
        emitted = 0  # chars of decoded text already sent
        aiter = await self.async_engine.generate(
            prompt, sp, stream=True, deadline=self._deadline())
        out = None
        async for item in aiter:
            if not isinstance(item, int):
                out = item  # terminal RequestOutput
                break
            toks.append(item)
            # Incremental detokenization: decode the full sequence and
            # emit the stable new suffix (BPE merges can rewrite the
            # tail, so never emit per-token decodes blindly).
            text = self.engine.tokenizer.decode(toks)
            piece, emitted = text[emitted:], len(text)
            if not piece:
                continue
            if is_chat:
                yield {**base, "choices": [{
                    "index": 0, "delta": {"content": piece},
                    "finish_reason": None}]}
            else:
                yield {**base, "choices": [{
                    "index": 0, "text": piece, "finish_reason": None}]}
        # Trailing text the finishing step produced (stop-string
        # trimming may also SHORTEN the final text — re-emit nothing in
        # that case, but always close with the finish_reason chunk).
        final_text = out.text if out is not None else ""
        piece = final_text[emitted:] if len(final_text) > emitted else ""
        finish = out.finish_reason if out is not None else "stop"
        if is_chat:
            yield {**base, "choices": [{
                "index": 0, "delta": ({"content": piece} if piece else {}),
                "finish_reason": finish}]}
        else:
            yield {**base, "choices": [{
                "index": 0, "text": piece, "finish_reason": finish}]}
        yield "[DONE]"

    def models(self) -> dict:
        return {
            "object": "list",
            "data": [{
                "id": self.config.model_id,
                "object": "model",
                "owned_by": "ray_tpu",
            }],
        }

    async def completions(self, payload: dict) -> dict:
        prompt = payload["prompt"]
        # OpenAI accepts: a string, a list of strings, a token array
        # (list of ints = ONE pre-tokenized prompt), or a list of token
        # arrays.
        if isinstance(prompt, list) and prompt and all(
            isinstance(t, int) for t in prompt
        ):
            prompts = [prompt]
        elif isinstance(prompt, list):
            prompts = prompt
        else:
            prompts = [prompt]
        import asyncio

        sp = self._sampling(payload)
        n = int(payload.get("n", 1))
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        raw_bo = payload.get("best_of")
        best_of = n if raw_bo is None else int(raw_bo)
        if best_of < 1 or best_of < n:
            raise ValueError(
                f"best_of ({best_of}) must be >= 1 and >= n ({n})")
        if best_of > 1 and sp.temperature <= 0.0:
            # n identical greedy streams at n-fold cost (vLLM rejects
            # best_of > 1 with greedy sampling for the same reason).
            raise ValueError(
                "n/best_of > 1 requires temperature > 0 (greedy sampling "
                "would return identical completions)")
        outs = await asyncio.gather(
            *[self.async_engine.generate(p, spi, deadline=self._deadline())
              for p in prompts
              for spi in self._fan_out(sp, best_of, rank=best_of > n)])
        # Group the best_of samples per prompt; rank by CUMULATIVE
        # logprob when pruning best_of -> n (vLLM best_of semantics).
        choices = []
        for pi in range(len(prompts)):
            group = outs[pi * best_of:(pi + 1) * best_of]
            if best_of > n:
                group = sorted(group, key=self._cumulative_logprob,
                               reverse=True)[:n]
            for o in group:
                choices.append(
                    {"index": len(choices), "text": o.text,
                     "finish_reason": o.finish_reason,
                     **({"guided_error": o.error} if o.error else {}),
                     **({"logprobs": self._openai_logprobs(o, payload)}
                        if o.logprobs is not None and sp.logprobs > 0
                        else {})})
        # OpenAI usage accounting: each prompt counted ONCE; completion
        # tokens include every best_of sample (pruned ones were still
        # generated and paid for).
        usage = {
            "prompt_tokens": sum(
                outs[pi * best_of].num_prompt_tokens
                for pi in range(len(prompts))),
            "completion_tokens": sum(len(o.token_ids) for o in outs),
        }
        usage["total_tokens"] = (usage["prompt_tokens"]
                                 + usage["completion_tokens"])
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.config.model_id,
            "choices": choices,
            "usage": usage,
        }

    def _fan_out(self, sp: SamplingParams, k: int,
                 rank: bool = False) -> "list[SamplingParams]":
        """k independent sampling streams for n/best_of: derived seeds
        (stable when the user pinned one); ``rank`` forces logprobs on
        so best_of pruning has a ranking signal."""
        import dataclasses

        if k == 1:
            return [sp]
        out = []
        for i in range(k):
            out.append(dataclasses.replace(
                sp,
                seed=(sp.seed + i if sp.seed is not None else None),
                logprobs=max(sp.logprobs, 1) if rank else sp.logprobs))
        return out

    @staticmethod
    def _cumulative_logprob(o) -> float:
        if not o.logprobs:
            return float("-inf")
        return sum(e["logprob"] for e in o.logprobs)

    def _token_namer(self, payload: dict):
        """How a logprobs block names a token: its decoded text, or
        "token_id:<id>" when the request sets vLLM's
        ``return_tokens_as_token_ids`` (a byte tokenizer's text drops
        the ids past its 256 bytes, so only the ids tell them apart).
        The reference has no such field."""
        if payload.get("return_tokens_as_token_ids"):
            return lambda i: f"token_id:{i}"
        tok = self.engine.tokenizer
        return lambda i: tok.decode([i])

    def _openai_logprobs(self, out, payload: dict) -> dict:
        """OpenAI text-completions logprobs block from the engine's
        per-token records."""
        name = self._token_namer(payload)
        return {
            "tokens": [name(e["token_id"]) for e in out.logprobs],
            "token_logprobs": [e["logprob"] for e in out.logprobs],
            "top_logprobs": [
                {name(i): v for i, v in e["top"].items()}
                for e in out.logprobs
            ],
        }

    async def chat(self, payload: dict) -> dict:
        prompt = self._render_chat(payload["messages"])
        out = await self.async_engine.generate(
            prompt, self._sampling(payload), deadline=self._deadline())
        name = self._token_namer(payload)
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.config.model_id,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out.text},
                "finish_reason": out.finish_reason,
                **({"guided_error": out.error} if out.error else {}),
                **({"logprobs": {"content": [
                    {"token": name(e["token_id"]),
                     "logprob": e["logprob"],
                     "top_logprobs": [
                         {"token": name(i),
                          "logprob": v} for i, v in e["top"].items()]}
                    for e in out.logprobs]}}
                   if out.logprobs is not None else {}),
            }],
            "usage": self._usage([out]),
        }


def _replica_options(device, ray_actor_options) -> dict:
    """A replica's actor options: the caller's, else one GPU lease for a
    CUDA device (a worker without one sees no card), else none."""
    if ray_actor_options is not None:
        return dict(ray_actor_options)
    import torch

    return {"num_gpus": 1} if torch.device(device).type == "cuda" else {}


def build_openai_app(config: LLMConfig, *, num_replicas: int = 1,
                     name: str | None = None, device="cuda",
                     ray_actor_options: "dict | None" = None):
    """Serve Application exposing the OpenAI API under /v1 (reference:
    ray.serve.llm build_openai_app). Run with serve.run(app,
    route_prefix=\"/v1\"). Each replica's engine runs on ``device``;
    ``ray_actor_options`` defaults to ``{"num_gpus": 1}`` for a CUDA
    device."""
    dep = deployment(LLMServer, name=name or f"llm:{config.model_id}",
                     num_replicas=num_replicas,
                     ray_actor_options=_replica_options(device, ray_actor_options))
    return dep.bind(config, device=device)


# ---------------------------------------------------------------------------
# Disaggregated serving: prefill pool → zero-copy KV handoff → decode pool
#
# Counterpart of vLLM's P/D disaggregation (KVConnector /
# disaggregated prefill) rebuilt on this repo's own planes: the prefill
# replica returns a paged-KV record whose tensor payload the serve
# result path seals METADATA-ONLY on the data plane; the router
# passes the un-awaited DeploymentResponse straight into the decode
# call (handle.remote unwraps it to the ObjectRef), and the decode
# replica's ray_tpu_torch.get() pulls the KV bytes arena/p2p — the head
# connection never carries a payload byte and the router never holds
# the KV in memory.


class PrefillServer(LLMServer):
    """Prefill pool replica: runs prompt prefill + first-token sampling,
    returns a self-contained handoff record, holds no decode state.
    Slots and pages are freed the moment the record is sealed, so a
    prefill replica's capacity is pure prompt throughput."""

    POOL = "prefill"

    def prefill(self, payload: dict) -> dict:
        """One prompt → one handoff record (sync on purpose: the replica
        runs sync methods in its user pool, keeping the event loop free
        while the prefill runs)."""
        payload = payload if isinstance(payload, dict) else {}
        if "messages" in payload:
            prompt: "str | list[int]" = self._render_chat(payload["messages"])
        else:
            prompt = payload.get("prompt", "")
            if isinstance(prompt, list) and not all(
                    isinstance(t, int) for t in prompt):
                raise ValueError(
                    "disaggregated serving takes one prompt per request")
        return self.engine.prefill_detached(prompt, self._sampling(payload))


class DecodeServer(LLMServer):
    """Decode pool replica: resumes handoff records under the continuous
    batcher. Per-request LoRA rides serve's model multiplexing — the
    router stamps multiplexed_model_id, rendezvous routing gives the
    adapter replica affinity, and the @serve.multiplexed loader below
    materializes the adapter into the engine's slot table (no
    recompilation: LoRA slots are a batched gather)."""

    POOL = "decode"

    def __init__(self, config: LLMConfig, params: Any = None, *,
                 device="cuda"):
        super().__init__(config, params, device=device)
        from collections import deque

        # Handoff telemetry: seal→resume latency (bounded) + totals for
        # the router's stats aggregation and the A/B bench.
        self._handoff_lat: "deque[float]" = deque(maxlen=1024)
        self._handoff_count = 0
        self._handoff_bytes = 0
        # Adapter registry for lazy multiplexed loads (filled by
        # load_lora_adapter; per-replica, like vLLM's dynamic LoRA).
        self._adapter_paths: dict[str, tuple[str, float]] = {}

    def load_lora_adapter(self, payload: dict) -> dict:
        self._adapter_paths[payload["lora_name"]] = (
            payload["lora_path"], float(payload.get("alpha", 16.0)))
        return super().load_lora_adapter(payload)

    from ray_tpu_torch.serve.multiplex import multiplexed as _multiplexed

    @_multiplexed(max_num_models_per_replica=8)
    async def get_adapter(self, model_id: str) -> str:
        """Multiplexed loader: model id "<model>:<adapter>" → adapter
        name, loading it into the engine on first use. The LRU cache in
        front of this makes repeat requests for a hot adapter free."""
        name = model_id.split(":", 1)[1] if ":" in model_id else model_id
        if name not in self.engine.list_loras():
            ent = self._adapter_paths.get(name)
            if ent is None:
                raise KeyError(
                    f"unknown LoRA adapter {name!r} on this replica: load "
                    "it via /v1/load_lora_adapter first")
            self.engine.add_lora(name, ent[0], alpha=ent[1])
        return name

    del _multiplexed

    def _account_handoff(self, handoff: dict, t_recv: float) -> None:
        k, v = handoff.get("k"), handoff.get("v")
        nbytes = (int(getattr(k, "nbytes", 0) or 0)
                  + int(getattr(v, "nbytes", 0) or 0))
        sealed = float(handoff.get("sealed_at") or t_recv)
        self._handoff_lat.append(max(0.0, t_recv - sealed))
        self._handoff_count += 1
        self._handoff_bytes += nbytes
        from ray_tpu_torch._private import dataplane

        # copies=0: the bytes moved via the data plane's local/p2p pull
        # (already copy-accounted there) — this sizes the handoff path.
        dataplane.record("handoff", nbytes, copies=0)
        self._emit_handoff_span(handoff, sealed, t_recv, nbytes)

    @staticmethod
    def _emit_handoff_span(handoff: dict, start: float, end: float,
                           nbytes: int) -> None:
        """llm.handoff span between the prefill's llm.prefill and the
        engine's llm.decode: covers seal→resume, i.e. the queue + pull
        latency of the disaggregation hop. Same buffered emission as the
        engine's spans — flushed on amortized rpc_report, no per-span
        frames."""
        from ray_tpu_torch._private.worker_context import get_trace_context

        tc = get_trace_context()
        if not (tc and int(tc[2] or 0)):
            return
        import os

        from ray_tpu_torch._private import traceplane

        k = handoff.get("k")
        traceplane.buffer_span({
            "event": "span",
            "name": "llm.handoff",
            "kind": "llm",
            "trace_id": tc[0],
            "span_id": traceplane.new_span_id(),
            "parent_span_id": tc[1],
            "pid": os.getpid(),
            "start": start,
            "end": end,
            "failed": False,
            "attributes": {
                "bytes": nbytes,
                "kv_pages": int(k.shape[1]) if hasattr(k, "shape") else 0,
                "prompt_tokens": len(handoff.get("prompt_tokens") or ()),
            },
        })

    def handoff_stats(self) -> dict:
        lat = sorted(self._handoff_lat)

        def pct(p: float) -> float:
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        return {
            "count": self._handoff_count,
            "bytes": self._handoff_bytes,
            "latency_p50_s": pct(0.50),
            "latency_p95_s": pct(0.95),
            "kv": self.engine.kv_stats(),
        }

    async def decode(self, handoff: dict, payload: Any = None) -> dict:
        """Resume a prefill_detached() record: account the handoff,
        resolve the request's LoRA adapter via multiplexing, then decode
        under the shared continuous batcher + deadline eviction."""
        payload = payload if isinstance(payload, dict) else {}
        self._account_handoff(handoff, time.time())
        from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id

        mid = get_multiplexed_model_id()
        if ":" in (mid or "") and self.engine.lora_mgr is not None:
            await self.get_adapter(mid)
        out = await self.async_engine.generate_from_handoff(
            handoff, self._sampling(payload), deadline=self._deadline())
        return self._finish_response(out, payload)

    def _finish_response(self, out, payload: dict) -> dict:
        sp_lp = int(payload.get("top_logprobs", payload.get("logprobs") or 0)
                    or 0)
        if "messages" in payload:
            return {
                "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": payload.get("model") or self.config.model_id,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": out.text},
                    "finish_reason": out.finish_reason,
                    **({"guided_error": out.error} if out.error else {}),
                }],
                "usage": self._usage([out]),
            }
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": payload.get("model") or self.config.model_id,
            "choices": [{
                "index": 0,
                "text": out.text,
                "finish_reason": out.finish_reason,
                **({"guided_error": out.error} if out.error else {}),
                **({"logprobs": self._openai_logprobs(out, payload)}
                   if out.logprobs is not None and sp_lp > 0 else {}),
            }],
            "usage": self._usage([out]),
        }


class LLMRouter:
    """Ingress for the disaggregated app: one OpenAI surface over the
    two pools. Per request it issues prefill WITHOUT awaiting it and
    hands the DeploymentResponse straight to the decode call — the two
    legs pipeline through the object plane, and the KV record's bytes
    flow prefill-replica → decode-replica directly."""

    def __init__(self, config: LLMConfig, prefill, decode):
        self.config = config
        self.prefill = prefill
        self.decode = decode

    def models(self) -> dict:
        return {
            "object": "list",
            "data": [{"id": self.config.model_id, "object": "model",
                      "owned_by": "ray_tpu"}],
        }

    async def __call__(self, payload: Any = None) -> dict:
        payload = payload if isinstance(payload, dict) else {}
        if "messages" in payload or "prompt" in payload:
            return await self._generate(payload)
        return self.models()

    async def route_request(self, path: str, payload: Any = None) -> dict:
        payload = payload if isinstance(payload, dict) else {}
        p = path.rstrip("/")
        if p.endswith("/chat/completions") or p.endswith("/completions"):
            return await self._generate(payload)
        if p.endswith("/models"):
            return self.models()
        if p.endswith("/tokenize"):
            return await self.prefill.tokenize.remote(payload)
        if p.endswith("/detokenize"):
            return await self.prefill.detokenize.remote(payload)
        if p.endswith("/load_lora_adapter"):
            return await self.load_lora_adapter(payload)
        if p.endswith("/unload_lora_adapter"):
            return await self.unload_lora_adapter(payload)
        return await self.__call__(payload)

    async def load_lora_adapter(self, payload: dict) -> dict:
        """Fan the registration out to BOTH pools (LoRA shapes prefill
        logits too). One call per pool: with multi-replica pools the
        decode side backfills lazily via its multiplexed loader; other
        prefill replicas need their own registration call."""
        import asyncio

        _, dec = await asyncio.gather(
            self.prefill.load_lora_adapter.remote(payload),
            self.decode.load_lora_adapter.remote(payload))
        return dec

    async def unload_lora_adapter(self, payload: dict) -> dict:
        import asyncio

        _, dec = await asyncio.gather(
            self.prefill.unload_lora_adapter.remote(payload),
            self.decode.unload_lora_adapter.remote(payload))
        return dec

    def _handles(self, payload: dict):
        """Per-request handle pair: decode affinity by multiplexed model
        id (rendezvous-stable → a hot adapter stays on one replica);
        handoff_timeout_s stamps the end-to-end deadline on both legs."""
        ph, dh = self.prefill, self.decode
        mid = payload.get("model") or ""
        if isinstance(mid, str) and ":" in mid:
            dh = dh.options(multiplexed_model_id=mid)
        t = float(self.config.handoff_timeout_s or 0.0)
        if t > 0.0:
            ph = ph.options(timeout_s=t)
            dh = dh.options(timeout_s=t)
        return ph, dh

    async def _one(self, payload: dict) -> dict:
        ph, dh = self._handles(payload)
        rec = ph.prefill.remote(payload)  # NOT awaited: pipelined handoff
        return await dh.decode.remote(rec, payload)

    async def _generate(self, payload: dict) -> dict:
        if int(payload.get("n", 1)) != 1 or payload.get("best_of"):
            raise ValueError(
                "disaggregated serving supports n=1 without best_of")
        prompt = payload.get("prompt")
        if not (isinstance(prompt, list) and prompt and not all(
                isinstance(t, int) for t in prompt)):
            return await self._one(payload)
        # Batch form (list of prompts): one prefill→decode pipeline per
        # prompt, merged back into a single OpenAI response.
        import asyncio

        outs = await asyncio.gather(
            *[self._one({**payload, "prompt": p}) for p in prompt])
        merged = dict(outs[0])
        merged["choices"] = [
            {**c, "index": i}
            for i, o in enumerate(outs) for c in o["choices"]]
        merged["usage"] = {
            k: sum(o["usage"][k] for o in outs) for k in outs[0]["usage"]}
        return merged

    async def stats(self) -> dict:
        """Aggregated pool view for benches/tests (handoff latency, KV
        pressure, prefix hit rate)."""
        import asyncio

        pre, dec, hand = await asyncio.gather(
            self.prefill.kv_snapshot.remote(),
            self.decode.kv_snapshot.remote(),
            self.decode.handoff_stats.remote())
        return {"prefill": pre, "decode": dec, "handoff": hand}


def build_disaggregated_app(config: LLMConfig, *, num_prefill: int = 1,
                            num_decode: int = 1, name: str | None = None,
                            device="cuda",
                            ray_actor_options: "dict | None" = None):
    """Serve Application with split prefill/decode pools behind one
    router (vLLM P/D disaggregation shape). Requires paged KV: a config
    with kv_page_size == 0 gets the default page size of 16. The pools'
    engines run on ``device``; ``ray_actor_options`` (each pool
    replica's) defaults to ``{"num_gpus": 1}`` for a CUDA device. The
    router holds no engine and takes no lease."""
    import dataclasses

    if config.kv_page_size <= 0:
        config = dataclasses.replace(config, kv_page_size=16)
    base = name or f"llm:{config.model_id}"
    opts = _replica_options(device, ray_actor_options)
    pre = deployment(PrefillServer, name=f"{base}-prefill",
                     num_replicas=num_prefill,
                     ray_actor_options=opts).bind(config, device=device)
    dec = deployment(DecodeServer, name=f"{base}-decode",
                     num_replicas=num_decode,
                     ray_actor_options=opts).bind(config, device=device)
    return deployment(LLMRouter, name=base).bind(config, pre, dec)
