"""LLMEngine: continuous-batching decode engine (port of the
single-device engine of ray_tpu/llm/engine.py).

A slot cache — dense (model_runner.py) or a page pool with per-slot
block tables (kv_pages.py) — and a host-side scheduler:

  admit:  while a slot is free and requests wait, prefill the waiting
          prompts into free slots — same-bucket prompts in one batched
          prefill, or one at a time with prefix-cache hits, chunked
          prefill or a draft model;
  step:   one decode advances every active slot by one token (or a
          speculative window verified in one target pass), followed by
          the extended sampling program when a slot needs it and the
          host-side JSON-constrained pick for guided slots;
  retire: slots finishing (EOS / stop strings / max_tokens / cache or
          pool full) free up, with their pages.

Every option of ray_tpu's engine on one device is here: paged KV with
prefix caching and overcommitted pools, chunked prefill, extended
sampling with logprobs and logit_bias, guided JSON, speculative
decoding, multi-LoRA and .npz checkpoints. The engine is synchronous;
``generate`` serializes callers on a lock.

Tensor and pipeline parallelism (``tensor_parallel_size``,
``pipeline_parallel_size``) run one engine per rank of the default
torch.distributed process group, every rank on the same requests
(ray_tpu runs one engine over all devices): the runner is then one
rank's part (model_runner.TensorParallel, pp_runner.PPRunner) and the
scheduler stays the same. They take and refuse what ray_tpu's take and
refuse, with its errors.

``AsyncLLMEngine`` drives an engine from a background thread: concurrent
callers' requests join one running batch, with streams and deadlines.
Callers hand their requests over through a queue that the thread drains
before each step, not through the engine lock, which the thread takes
step after step.

Disaggregated serving: a prefill engine's ``prefill_detached`` runs one
prompt's prefill and returns a self-contained record of its KV pages (as
tensors on that engine's device, ``[L, n, page, KV, Dh]``, so a device
edge of a compiled DAG keeps them on the card; ray_tpu returns numpy);
a decode engine's ``add_handoff_request`` installs them at admission
instead of prefilling. Requests traced by the caller get the engine's
spans (``llm.prefill``, ``llm.decode``) in their trace.

Not here: orbax checkpoint directories raise (the port reads .npz only;
ROADMAP.md §3).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from typing import Any, Iterable

import numpy as np
import torch

from ray_tpu_torch.exceptions import TaskTimeoutError
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.llm import kv_pages, model_runner
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.kv_pages import KVPageError
from ray_tpu_torch.llm.tokenizer import load_tokenizer
from ray_tpu_torch.models import transformer as tfm

# Top-k width of the device logprob output (vLLM max_logprobs).
MAX_LOGPROBS = 20
# Per-slot width of the logit_bias scatter in the device program.
MAX_LOGIT_BIAS = 16


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    params: SamplingParams
    generated: list[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None
    # Adapter pool index, resolved ONCE at admission (an unload between
    # intake validation and admission fails the request, not the loop).
    lora_ix: int = 0
    # Per generated token (only when params.logprobs > 0):
    # {"token_id", "logprob", "top": {token_id: logprob, ...}}
    logprobs: "list[dict] | None" = None
    # Constraint state (llm.guided.GuidedJson) when the request asked
    # for response_format json mode; None otherwise.
    guided: "object | None" = None
    t_add: float = 0.0       # enqueue wall time (queue-wait start)
    t_first: float = 0.0     # first-token wall time (decode start)
    # The caller's trace context (worker_context.get_trace_context());
    # the engine's spans join that trace.
    trace_ctx: Any = None
    # A prefill_detached() record: admission installs its pages.
    handoff: "dict | None" = None


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    token_ids: list[int]
    text: str
    finish_reason: str | None
    num_prompt_tokens: int
    # vLLM-style per-token logprobs (None unless requested).
    logprobs: "list[dict] | None" = None
    # Guided-decoding verdict: None, or an error string when the output
    # failed the constraint (truncated JSON / schema mismatch).
    error: "str | None" = None


class LLMEngine:
    def __init__(self, config: LLMConfig, params: Any = None, *,
                 device="cuda"):
        self.config = config
        self.model_config = config.resolve_model()
        self.tokenizer = load_tokenizer(config.tokenizer)
        c = self.model_config
        if c.n_experts > 0:
            raise NotImplementedError(
                "MoE decode is not wired into the slot engine yet; train with "
                "MoE (models.transformer) and serve dense.")
        tok_vocab = len(self.tokenizer)
        if tok_vocab > c.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tok_vocab}, incl. special tokens) exceeds "
                f"model vocab_size ({c.vocab_size}); special-token ids would "
                f"index past the embedding. Use a model with "
                f"vocab_size >= {tok_vocab}."
            )
        self.device = torch.device(device)
        # Engine cache capacity is capped by the model's position capacity.
        self.max_len = min(config.max_seq_len, c.max_seq_len)
        if params is None:
            if config.checkpoint_path:
                params = _load_checkpoint(config.checkpoint_path, device)
            else:
                gen = torch.Generator().manual_seed(config.seed)
                params = tfm.init_params(gen, c, device=device)
        B = config.max_num_seqs
        dc = config.resolve_speculative_model()
        # The runner: model_runner on one device, or one rank's part of a
        # tensor- or pipeline-parallel runner (TensorParallel, PPRunner),
        # each with model_runner's signatures, so the host-side scheduler
        # below is the same. Every rank of the process group runs this
        # engine on the same requests: its choices are the same on every
        # rank (the logits are; seeds and samplers draw from config.seed).
        self._mr = model_runner
        tp = int(config.tensor_parallel_size or 1)
        pp = int(config.pipeline_parallel_size or 1)
        if pp > 1:
            if tp > 1:
                raise NotImplementedError(
                    "pipeline_parallel_size and tensor_parallel_size "
                    "cannot be combined yet")
            if config.prefill_chunk:
                raise NotImplementedError(
                    "chunked prefill is not supported with "
                    "pipeline_parallel_size > 1")
            if config.enable_prefix_caching:
                raise NotImplementedError(
                    "prefix caching is not supported with "
                    "pipeline_parallel_size > 1")
            if dc is not None:
                raise NotImplementedError(
                    "speculative decoding is not supported with "
                    "pipeline_parallel_size > 1")
            from ray_tpu_torch.llm.pp_runner import PPRunner

            self._mr = PPRunner(c, pp, device=device)
        # Paged KV (llm/kv_pages.py): fixed-size pages + per-slot block
        # tables replace the dense per-slot [max_len] cache. Host-side
        # accounting lives in the allocator; scheduling stays the same
        # except where pages are allocated/freed.
        self.page_size = int(config.kv_page_size or 0)
        self.kv_alloc = None
        self._page_tables: list[list[int]] = []
        if self.page_size > 0:
            if pp > 1 or tp > 1:
                raise ValueError(
                    "kv_page_size (paged KV) is not supported together "
                    "with tensor/pipeline parallelism, speculative "
                    "decoding, or chunked prefill yet")
            if dc is not None:
                raise ValueError(
                    "kv_page_size (paged KV) is not supported together "
                    "with speculative decoding")
            if config.prefill_chunk and config.prefill_chunk % self.page_size:
                # Chunks start on page boundaries (paged_prefill_at).
                raise ValueError(
                    f"paged chunked prefill needs prefill_chunk "
                    f"({config.prefill_chunk}) to be a multiple of "
                    f"kv_page_size ({self.page_size})")
            self._max_blocks = -(-self.max_len // self.page_size)
            n_pages = int(config.kv_num_pages or 0)
            if n_pages <= 0:
                n_pages = B * self._max_blocks + 1
            self.kv_alloc = kv_pages.KVPageAllocator(n_pages, self.page_size)
            self._page_tables = [[] for _ in range(B)]
            self._block_tables = np.zeros((B, self._max_blocks), np.int64)
            self.cache = kv_pages.init_page_pool(c, n_pages, self.page_size,
                                                 device=device)
        # Tensor parallelism: a 1-D "tensor" mesh; this rank keeps its
        # shards of the weights (models.partition_specs) and its kv heads
        # of the slot cache (model_runner.TensorParallel).
        self.mesh = None
        if tp > 1:
            if c.n_heads % tp or c.kv_heads % tp:
                raise ValueError(
                    f"tensor_parallel_size={tp} must divide heads "
                    f"({c.n_heads}) and kv_heads ({c.kv_heads})")
            self._mr = model_runner.TensorParallel(model_runner.serving_mesh(
                "tensor", tp, self.device.type, "tensor_parallel_size"))
            self.mesh = self._mr.mesh
            params = self._mr.shard_params(params, c)
        elif pp > 1:
            params = self._mr.shard_params(params)
        if self.page_size == 0:
            self.cache = self._mr.init_slot_cache(c, B, self.max_len,
                                                  device=device)
        self.params = params
        # Host-side scheduling state, uploaded per decode call: keeping
        # positions on the host avoids a device→host sync per slot.
        self.positions = np.zeros((B,), np.int64)
        self.last_tokens = np.zeros((B,), np.int64)
        self.temps = np.zeros((B,), np.float32)
        # Extended sampling (vLLM SamplingParams parity): per-slot knobs
        # uploaded to the advanced_sample program only when some active
        # slot needs it (plain batches keep the in-decode fast path).
        self.top_ks = np.zeros((B,), np.int64)
        self.top_ps = np.ones((B,), np.float32)
        self.min_ps = np.zeros((B,), np.float32)
        self.bias_ids = np.zeros((B, MAX_LOGIT_BIAS), np.int64)
        self.bias_vals = np.zeros((B, MAX_LOGIT_BIAS), np.float32)
        self.pres_pens = np.zeros((B,), np.float32)
        self.freq_pens = np.zeros((B,), np.float32)
        self.rep_pens = np.ones((B,), np.float32)
        # Per-slot sampling seeds (uint32 values).
        self.seeds = np.zeros((B,), np.int64)
        # Device-resident penalty state (updated in place).
        self._counts = torch.zeros((B, c.vocab_size), dtype=torch.int32,
                                   device=device)
        self._prompt_mask = torch.zeros((B, c.vocab_size), dtype=torch.bool,
                                        device=device)
        self._plain = np.ones((B,), bool)  # slot uses the fast path
        # Slot is compatible with the speculative-decode path: sampling
        # reduces to raw-logits argmax and no logprobs are requested.
        self._spec_ok = np.ones((B,), bool)
        self.slots: list[Request | None] = [None] * B
        self.waiting: collections.deque[Request] = collections.deque()
        # Prefix cache: token-tuple -> (k, v) [L, plen, KV, Dh] copies
        # (dense) or pinned page ids (paged), LRU-ordered. Entries are
        # written at prefix_block (dense) or page granularity after a
        # prompt's prefill and installed into a slot on a later match.
        self._prefix_pool: "collections.OrderedDict[tuple, Any]" = (
            collections.OrderedDict())
        self.prefix_cache_hits = 0
        self.prefix_cache_queries = 0
        # Speculative decoding: a draft model shadows the batch (own
        # slot cache, prefilled alongside the target); each engine step
        # chains draft proposals and verifies the window with ONE target
        # pass (model_runner.verify), greedy acceptance host-side.
        # num_speculative_tokens = draft proposals per window (vLLM); the
        # window is one longer (the last emitted token leads it).
        self.draft = None
        self.spec_k = int(config.num_speculative_tokens) + 1
        if dc is not None:
            if config.num_speculative_tokens < 1:
                raise ValueError(
                    f"num_speculative_tokens must be >= 1, got "
                    f"{config.num_speculative_tokens}")
            if dc.n_experts > 0:
                raise NotImplementedError("MoE draft models not supported")
            if dc.vocab_size != c.vocab_size:
                raise ValueError(
                    f"draft vocab_size ({dc.vocab_size}) must equal target "
                    f"vocab_size ({c.vocab_size}): proposals are target ids")
            if dc.max_seq_len < self.max_len:
                raise ValueError(
                    f"draft max_seq_len ({dc.max_seq_len}) < engine cache "
                    f"length ({self.max_len})")
            if config.speculative_checkpoint_path:
                dparams = _load_checkpoint(config.speculative_checkpoint_path,
                                           device)
            else:
                gen = torch.Generator().manual_seed(config.speculative_seed)
                dparams = tfm.init_params(gen, dc, device=device)
            self.draft = {
                "config": dc,
                "params": dparams,
                "cache": model_runner.init_slot_cache(dc, B, self.max_len,
                                                      device=device),
            }
        self.spec_stats = {"proposed": 0, "accepted": 0, "spec_steps": 0,
                           "fallback_steps": 0}
        self._host_rng = np.random.default_rng(config.seed + 1)
        self._rng = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        self._step_count = 0
        # generate()/step() mutate slot state and the cache in place;
        # concurrent callers are serialized.
        self._lock = threading.Lock()
        # Where generate() hands the outputs of requests it did not add
        # (an AsyncLLMEngine's, sharing the batch); None drops nothing
        # because then there are no such requests.
        self._foreign_output_listener = None
        # Lazy per-tokenizer JSON token masker (guided decoding).
        self._json_masker = None
        # Multi-LoRA pool: per-slot adapter index 0 = null adapter.
        self.lora_mgr = None
        self.lora_ix = np.zeros((B,), np.int64)
        if config.lora:
            if (config.prefill_chunk or config.enable_prefix_caching
                    or dc is not None or pp > 1):
                raise ValueError(
                    "lora is not supported together with chunked "
                    "prefill, prefix caching, speculative decoding, or "
                    "pipeline parallelism")
            from ray_tpu_torch.llm.lora import LoRAManager

            hdh = c.n_heads * c.head_dim
            kvdh = c.kv_heads * c.head_dim
            self.lora_mgr = LoRAManager(
                c.n_layers,
                {"wq": (c.d_model, hdh), "wk": (c.d_model, kvdh),
                 "wv": (c.d_model, kvdh), "wo": (hdh, c.d_model)},
                max_adapters=int(config.lora.get("max_adapters", 8)),
                max_rank=int(config.lora.get("max_rank", 16)),
                device=device)

    def _dev(self, a) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- multi-LoRA ---------------------------------------------------------

    def add_lora(self, name: str, tensors, alpha: float = 16.0) -> None:
        """Load (or hot-overwrite) an adapter. ``tensors`` is a
        {"wq": (A, B), ...} dict, an .npz path, or a LoRAAdapter."""
        if self.lora_mgr is None:
            raise ValueError("engine was not configured with lora=")
        from ray_tpu_torch.llm.lora import LoRAAdapter

        if isinstance(tensors, LoRAAdapter):
            ad = tensors
        elif isinstance(tensors, str):
            ad = LoRAAdapter.load(name, tensors, alpha=alpha)
        else:
            ad = LoRAAdapter(name, tensors, alpha=alpha)
        with self._lock:
            self.lora_mgr.add(ad)

    def remove_lora(self, name: str) -> bool:
        if self.lora_mgr is None:
            return False
        with self._lock:
            # Quiesce hook: indices still referenced by an in-flight
            # sequence are retired, not recycled — step() reclaims them
            # once the last referencing slot finishes (see LoRAManager).
            return self.lora_mgr.remove(name,
                                        active=self._active_lora_ixs())

    def list_loras(self) -> "list[str]":
        return [] if self.lora_mgr is None else self.lora_mgr.loaded()

    def _req_lora_ix(self, req: Request) -> int:
        name = (req.params.extra or {}).get("lora")
        if not name:
            return 0
        return self.lora_mgr.index_of(name)

    def _active_lora_ixs(self) -> set[int]:
        """Adapter indices referenced by slots still decoding."""
        return {int(self.lora_ix[i])
                for i, s in enumerate(self.slots) if s is not None}

    def _lora_kw(self, aix) -> dict:
        if self.lora_mgr is None:
            return {}
        tree = self.lora_mgr.lora_tree()
        if isinstance(self._mr, model_runner.TensorParallel):
            tree = self._mr.lora(tree)
        return {"lora": tree, "lora_ix": self._dev(np.asarray(aix, np.int64))}

    # -- request intake ----------------------------------------------------

    def add_request(self, request_id: str, prompt: str | list[int],
                    sampling_params: SamplingParams | None = None, *,
                    model: "str | None" = None) -> None:
        """Queue one request. ``model="<model_id>:<adapter>"`` selects a
        LoRA adapter (the OpenAI surface's model suffix) on an engine
        that serves adapters, as ``sampling_params.extra["lora"]`` does."""
        self.waiting.append(self._new_request(request_id, prompt, sampling_params,
                                              model=model))

    def _new_request(self, request_id: str, prompt: str | list[int],
                     sampling_params: SamplingParams | None = None, *,
                     model: "str | None" = None) -> Request:
        """add_request's checks and Request, not queued. It touches no
        state that step() changes, so it may run without the lock."""
        sp = sampling_params or self.config.sampling_defaults
        if (isinstance(model, str) and ":" in model
                and self.lora_mgr is not None):
            sp = dataclasses.replace(
                sp, extra={**(sp.extra or {}),
                           "lora": model.split(":", 1)[1]})
        if sp.logprobs > MAX_LOGPROBS:
            raise ValueError(
                f"logprobs={sp.logprobs} exceeds the engine cap "
                f"{MAX_LOGPROBS}")
        if len(sp.logit_bias) > MAX_LOGIT_BIAS:
            raise ValueError(
                f"logit_bias with {len(sp.logit_bias)} entries exceeds "
                f"the engine cap {MAX_LOGIT_BIAS}")
        for tid, _b in sp.logit_bias:
            if not 0 <= int(tid) < self.model_config.vocab_size:
                raise ValueError(
                    f"logit_bias token id {tid} outside vocab "
                    f"[0, {self.model_config.vocab_size})")
        toks = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
                else list(prompt))
        toks = toks[: self.max_len - 1]
        if not toks:
            raise ValueError(
                f"request {request_id!r} has an empty prompt (prefill "
                f"needs at least one token to produce next-token logits)"
            )
        lname = (sp.extra or {}).get("lora")
        if lname:
            if self.lora_mgr is None:
                raise ValueError(
                    f"request selects LoRA adapter {lname!r} but the "
                    "engine has no lora= config")
            try:
                self.lora_mgr.index_of(lname)
            except KeyError as e:
                raise ValueError(str(e)) from None
        req = Request(request_id, toks, sp)
        if sp.response_format is not None:
            req.guided = self._make_guided(sp.response_format)
        req.trace_ctx = _trace_context()
        req.t_add = time.time()
        return req

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    # -- disaggregated prefill/decode (KV handoff) ------------------------

    def prefill_detached(self, prompt: "str | list[int]",
                         sampling_params: "SamplingParams | None" = None,
                         ) -> dict:
        """Prefill side of disaggregated serving: run ONE prompt's
        prefill, sample its first token, and return a self-contained
        record of its KV pages, then free the slot and the pages. The
        record's ``k``/``v`` are tensors on this engine's device,
        ``[L, n, page, KV, Dh]`` (ray_tpu returns numpy): a compiled
        DAG's device edge hands them to the decode engine device to
        device."""
        if self.kv_alloc is None:
            raise ValueError(
                "prefill_detached requires paged KV (kv_page_size > 0)")
        sp = sampling_params or self.config.sampling_defaults
        if sp.response_format is not None:
            raise ValueError(
                "guided decoding cannot cross a prefill/decode handoff "
                "(the JSON automaton state is host-local)")
        if sp.logprobs > MAX_LOGPROBS:
            raise ValueError(
                f"logprobs={sp.logprobs} exceeds the engine cap "
                f"{MAX_LOGPROBS}")
        toks = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
                else list(prompt))
        toks = toks[: self.max_len - 1]
        if not toks:
            raise ValueError("empty prompt")
        with self._lock:
            slot = next((i for i, s in enumerate(self.slots) if s is None),
                        None)
            if slot is None:
                from ray_tpu_torch.exceptions import PendingCallsLimitError

                raise PendingCallsLimitError(
                    f"no free prefill slot (all {len(self.slots)} busy)")
            import uuid as _uuid

            req = Request(f"pfd-{_uuid.uuid4().hex[:12]}", toks, sp)
            if self.lora_mgr is not None:
                req.lora_ix = self._req_lora_ix(req)
            req.trace_ctx = _trace_context()
            req.t_add = time.time()
            try:
                try:
                    last_logits = self._prefill_into(slot, toks,
                                                     lora_ix=req.lora_ix)
                except KVPageError as e:
                    # Retryable backpressure, as a full admission queue.
                    from ray_tpu_torch.exceptions import PendingCallsLimitError

                    raise PendingCallsLimitError(str(e)) from None
                self.slots[slot] = req
                if sp.seed is not None:
                    self.seeds[slot] = sp.seed & 0xFFFFFFFF
                else:
                    self.seeds[slot] = int(self._host_rng.integers(0, 2**32))
                if sp.logprobs > 0:
                    req.logprobs = []
                tok = self._sample_host(last_logits.cpu().numpy(), slot, req)
                req.t_first = time.time()
                self._emit_span(req, "llm.prefill", req.t_add, req.t_first,
                                {"prompt_tokens": len(toks), "handoff": True})
                pages = torch.tensor(self._page_tables[slot], dtype=torch.int64,
                                     device=self.device)
                k_pages, v_pages = kv_pages.read_pages(self.cache, pages)
                return {
                    "fmt": 1,
                    "model_id": self.config.model_id,
                    "page_size": self.page_size,
                    "prompt_tokens": list(toks),
                    "first_token": int(tok),
                    "seed": sp.seed,
                    "lora": (sp.extra or {}).get("lora") or "",
                    "logprobs0": (req.logprobs[0] if req.logprobs
                                  else None),
                    "sealed_at": time.time(),
                    "k": k_pages,
                    "v": v_pages,
                }
            finally:
                self._release_slot(slot)

    def add_handoff_request(self, request_id: str, handoff: dict,
                            sampling_params: "SamplingParams | None" = None,
                            ) -> None:
        """Decode side: queue a request whose prompt K/V arrives as a
        prefill_detached() record (its k/v tensors on any device, or
        numpy). Admission installs the pages (_resume_into) instead of
        prefilling."""
        self.waiting.append(
            self._new_handoff_request(request_id, handoff, sampling_params))

    def _new_handoff_request(self, request_id: str, handoff: dict,
                             sampling_params: "SamplingParams | None" = None,
                             ) -> Request:
        """add_handoff_request's checks and Request, not queued."""
        if self.kv_alloc is None:
            raise ValueError(
                "handoff decode requires paged KV (kv_page_size > 0)")
        for key in ("k", "v", "prompt_tokens", "first_token", "page_size"):
            if key not in handoff:
                raise ValueError(f"malformed handoff record: missing {key!r}")
        if int(handoff["page_size"]) != self.page_size:
            raise ValueError(
                f"handoff page_size {handoff['page_size']} != engine "
                f"page_size {self.page_size}")
        c = self.model_config
        shape = tuple(handoff["k"].shape)
        want = (c.n_layers, shape[1] if len(shape) > 1 else 0, self.page_size,
                c.kv_heads, c.head_dim)
        if len(shape) != 5 or shape != want:
            raise ValueError(
                f"handoff KV shape {shape} does not match engine "
                f"geometry {want}")
        if shape[1] > self._max_blocks:
            raise ValueError(
                f"handoff carries {shape[1]} pages > engine max "
                f"{self._max_blocks}")
        sp = sampling_params or self.config.sampling_defaults
        if handoff.get("lora") and not (sp.extra or {}).get("lora"):
            sp = dataclasses.replace(
                sp, extra={**(sp.extra or {}), "lora": handoff["lora"]})
        if (sp.extra or {}).get("lora") and self.lora_mgr is None:
            raise ValueError(
                f"handoff selects LoRA adapter "
                f"{(sp.extra or {}).get('lora')!r} but the engine has "
                "no lora= config")
        req = Request(request_id, list(handoff["prompt_tokens"]), sp)
        req.handoff = handoff
        req.trace_ctx = _trace_context()
        req.t_add = time.time()
        return req

    def _resume_into(self, slot: int, req: Request) -> int:
        """Install a handoff record's KV pages into ``slot`` and return
        the prefill side's first token. Raises KVPageError (the caller
        requeues) when the pool cannot cover the record."""
        h = req.handoff
        n = int(h["k"].shape[1])
        pages = self._alloc_pages(n)
        self._set_table(slot, pages)
        kv_pages.write_pages(
            self.cache, torch.tensor(pages, dtype=torch.int64, device=self.device),
            h["k"], h["v"])
        return int(h["first_token"])

    # -- guided decoding (ray_tpu_torch.llm.guided) --------------------------

    def _make_guided(self, rf) -> "object":
        from ray_tpu_torch.llm import guided as gd

        if not isinstance(rf, dict) or rf.get("type") not in (
                "json_object", "json_schema", "text"):
            raise ValueError(
                f"response_format must be {{'type': 'json_object'|"
                f"'json_schema'|'text'}}, got {rf!r}")
        if rf.get("type") == "text":
            return None
        schema = None
        if rf.get("type") == "json_schema":
            js = rf.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            if schema is not None and not isinstance(schema, dict):
                raise ValueError("json_schema.schema must be an object")
        if self._json_masker is None:
            tok = self.tokenizer
            v_tok = len(tok)
            texts = [tok.decode([i], skip_special_tokens=False)
                     if i != getattr(tok, "eos_token_id", -1) else ""
                     for i in range(v_tok)]
            # Pad to the model's (padded) vocab: ids past the tokenizer
            # range must never be sampled under a constraint.
            texts += [""] * (self.model_config.vocab_size - v_tok)
            self._json_masker = gd.JsonTokenMasker(
                texts, eos_id=int(getattr(tok, "eos_token_id", 0) or 0))
        return gd.GuidedJson(self._json_masker,
                             mode=rf["type"], schema=schema)

    def _guided_sample(self, req: Request, slot: int,
                       logits_row: np.ndarray) -> int:
        """Host-side constrained pick: mask the step's logits to the
        tokens the JSON automaton allows, then run the request's
        temperature pipeline over what remains."""
        sp = req.params
        mask = req.guided.allowed_mask()
        lg = logits_row.astype(np.float64)
        for tid, b in sp.logit_bias:
            lg[int(tid)] += float(b)
        if sp.repetition_penalty != 1.0:
            seen = np.unique(np.asarray(
                list(req.prompt_tokens) + list(req.generated), np.int64))
            vals = lg[seen]
            lg[seen] = np.where(vals > 0, vals / sp.repetition_penalty,
                                vals * sp.repetition_penalty)
        if (sp.presence_penalty or sp.frequency_penalty) and req.generated:
            cnt = np.bincount(np.asarray(req.generated, np.int64),
                              minlength=lg.shape[0])[: lg.shape[0]]
            lg -= (sp.frequency_penalty * cnt
                   + sp.presence_penalty * (cnt > 0))
        lg[~mask] = -np.inf
        if not np.isfinite(lg).any():
            # Automaton cornered (shouldn't happen: eos is allowed once
            # complete) — force eos so the request terminates.
            return int(self._json_masker.eos_id)
        if sp.temperature <= 0.0:
            tok = int(lg.argmax())
            dist = lg
        else:
            dist = self._host_filter(lg / max(sp.temperature, 1e-6), sp)
            dist[~mask] = -np.inf
            p = np.exp(dist - dist[np.isfinite(dist)].max())
            p[~np.isfinite(p)] = 0.0
            s = p.sum()
            if s <= 0:
                tok = int(lg.argmax())
            else:
                rng = np.random.default_rng(
                    int(self.seeds[slot]) + len(req.generated) + 1)
                tok = int(rng.choice(len(p), p=p / s))
        if req.logprobs is not None:
            req.logprobs.append(self._host_logprob_entry(dist, sp, tok))
        req.guided.accept(tok)
        return tok

    # -- scheduling --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if b >= n and b <= self.max_len:
                return b
        return self.max_len

    def _admit(self, outputs: list[RequestOutput]) -> None:
        # Batched admission (vLLM batches prefills): same-bucket prompts
        # prefill in ONE [N, S] pass. Prefix caching, chunked prefill
        # and speculative drafts need per-prompt handling (different
        # pos0 / a draft mirror), so those engines admit one at a time,
        # as does the pipeline runner, which has no batched prefill.
        cfg = self.config
        batchable = (cfg.prefill_chunk == 0
                     and not cfg.enable_prefix_caching
                     and self.draft is None
                     and hasattr(self._mr, "prefill_batch"))
        admits: list[tuple[int, Request]] = []
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None:
                continue
            while self.waiting:
                req = self.waiting.popleft()
                if self.lora_mgr is not None:
                    # Resolve the adapter index HERE: an unload racing
                    # the queue fails this one request with a clean
                    # output instead of throwing inside the step loop.
                    try:
                        req.lora_ix = self._req_lora_ix(req)
                    except KeyError as e:
                        req.finished = True
                        req.finish_reason = "error"
                        outputs.append(RequestOutput(
                            request_id=req.request_id, token_ids=[],
                            text="", finish_reason="error",
                            num_prompt_tokens=len(req.prompt_tokens),
                            error=str(e)))
                        continue
                admits.append((slot, req))
                break
        if not admits:
            return
        if (not batchable or len(admits) == 1
                or any(r.handoff is not None for _, r in admits)):
            for i, (slot, req) in enumerate(admits):
                try:
                    if req.handoff is not None:
                        tok0 = self._resume_into(slot, req)
                    else:
                        last_logits = self._prefill_into(
                            slot, req.prompt_tokens, lora_ix=req.lora_ix)
                except KVPageError:
                    # Page pool exhausted even after prefix eviction:
                    # requeue this and the rest at the queue head —
                    # finishing sequences will free pages.
                    self.waiting.extendleft(
                        r for _, r in reversed(admits[i:]))
                    return
                if req.handoff is not None:
                    self._finish_admit(slot, req, None, outputs, first_tok=tok0)
                else:
                    self._finish_admit(slot, req, last_logits.cpu().numpy(),
                                       outputs)
            return
        if self.kv_alloc is not None:
            # Pre-allocate every admit's pages (the batched prefill needs
            # complete block tables); exhaustion requeues the remainder.
            kept: list[tuple[int, Request]] = []
            for i, (slot, req) in enumerate(admits):
                try:
                    pages = self._alloc_pages(
                        -(-len(req.prompt_tokens) // self.page_size))
                except KVPageError:
                    self.waiting.extendleft(
                        r for _, r in reversed(admits[i:]))
                    break
                self._set_table(slot, pages)
                kept.append((slot, req))
            admits = kept
            if not admits:
                return
        groups: dict[int, list] = {}
        for slot, req in admits:
            S = self._bucket(len(req.prompt_tokens))
            groups.setdefault(S, []).append((slot, req))
        B = len(self.slots)
        for S, group in sorted(groups.items()):
            if len(group) == 1:
                slot, req = group[0]
                last_logits = self._prefill_into(
                    slot, req.prompt_tokens, lora_ix=req.lora_ix)
                self._finish_admit(slot, req, last_logits.cpu().numpy(),
                                   outputs)
                continue
            # Pad the group to the next power of two (bounded set of
            # shapes); pad rows use slot index B (or page id P) — out of
            # range, so their writes are dropped.
            N = 1 << (len(group) - 1).bit_length()
            toks = np.zeros((N, S), np.int64)
            lens = np.ones((N,), np.int64)
            slots_arr = np.full((N,), B, np.int64)
            aix = np.zeros((N,), np.int64)
            for j, (slot, req) in enumerate(group):
                L = len(req.prompt_tokens)
                toks[j, :L] = req.prompt_tokens
                lens[j] = L
                slots_arr[j] = slot
                aix[j] = req.lora_ix
            lkw = self._lora_kw(aix)
            if self.kv_alloc is not None:
                bts = np.full((N, self._max_blocks),
                              self.kv_alloc.num_pages, np.int64)
                for j, (slot, _req) in enumerate(group):
                    bts[j] = self._block_tables[slot]
                logits, self.cache = kv_pages.paged_prefill_batch(
                    self.params, self._dev(toks), lens, self._dev(bts),
                    self.cache, config=self.model_config, **lkw)
            else:
                logits, self.cache = self._mr.prefill_batch(
                    self.params, self._dev(toks), lens, slots_arr,
                    self.cache, config=self.model_config, **lkw)
            logits_np = logits.cpu().numpy()
            for j, (slot, req) in enumerate(group):
                self._finish_admit(slot, req, logits_np[j], outputs)

    def _finish_admit(self, slot: int, req: Request,
                      last_logits: "np.ndarray | None",
                      outputs: list[RequestOutput],
                      first_tok: "int | None" = None) -> None:
        """Per-request state wiring after its prompt K/V is in ``slot``
        and its last-token logits are on the host. ``first_tok``: a
        handoff's resume, whose first token the prefill engine sampled
        (and whose llm.prefill span it emitted)."""
        sp = req.params
        self.positions[slot] = len(req.prompt_tokens)
        self.slots[slot] = req
        self.temps[slot] = sp.temperature
        self.top_ks[slot] = max(0, sp.top_k)
        self.top_ps[slot] = sp.top_p
        self.min_ps[slot] = sp.min_p
        self.bias_ids[slot] = 0
        self.bias_vals[slot] = 0.0
        for j, (tid, b) in enumerate(sp.logit_bias[:MAX_LOGIT_BIAS]):
            self.bias_ids[slot, j] = int(tid)
            self.bias_vals[slot, j] = float(b)
        if self.lora_mgr is not None:
            self.lora_ix[slot] = req.lora_ix
        self.pres_pens[slot] = sp.presence_penalty
        self.freq_pens[slot] = sp.frequency_penalty
        self.rep_pens[slot] = sp.repetition_penalty
        self._plain[slot] = not sp.needs_advanced()
        # Guided slots pick host-side (masked); speculation's greedy
        # contract doesn't hold for them.
        self._spec_ok[slot] = (sp.greedy_equivalent() and sp.logprobs == 0
                               and req.guided is None)
        if sp.seed is not None:
            self.seeds[slot] = sp.seed & 0xFFFFFFFF
        else:
            self.seeds[slot] = int(self._host_rng.integers(0, 2**32))
        if sp.logprobs > 0:
            req.logprobs = []
        if first_tok is not None:
            tok = int(first_tok)
            if (req.logprobs is not None and req.handoff is not None
                    and req.handoff.get("logprobs0") is not None):
                req.logprobs.append(req.handoff["logprobs0"])
        elif req.guided is not None:
            tok = self._guided_sample(req, slot, last_logits)
        else:
            tok = self._sample_host(last_logits, slot, req)
        if not self._plain[slot]:
            # Seed the device-side penalty state: prompt token set + the
            # first sampled token.
            hist = np.zeros((self.model_config.vocab_size,), bool)
            hist[np.asarray(req.prompt_tokens, np.int64)] = True
            model_runner.reset_slot_sampling(
                self._counts, self._prompt_mask, slot, self._dev(hist), tok)
        self.last_tokens[slot] = tok
        req.generated.append(tok)
        # Queue wait and prefill up to the first token, into the caller's
        # trace; a handoff's resume skips it (the prefill engine emitted
        # its own).
        req.t_first = time.time()
        if first_tok is None:
            self._emit_span(req, "llm.prefill", req.t_add, req.t_first,
                            {"prompt_tokens": len(req.prompt_tokens)})
        self._maybe_finish(slot, outputs)

    def _prefill_into(self, slot: int, toks: list[int], lora_ix: int = 0):
        """Write a prompt's K/V into ``slot`` (prefix-cache install +
        chunked or whole-prompt prefill) and return the last-token
        logits [V]."""
        if self.kv_alloc is not None:
            return self._prefill_into_paged(slot, toks, lora_ix=lora_ix)
        cfg = self.config
        L = len(toks)
        pos0 = 0
        if cfg.enable_prefix_caching:
            pos0 = self._install_cached_prefix(slot, toks)
        chunk = cfg.prefill_chunk if cfg.prefill_chunk > 0 else L - pos0
        last_logits = None
        off = pos0
        while off < L:
            take = min(chunk, L - off)
            # Padded width comes from the bucket set so chunk shapes
            # stay bounded; near the cache cap pad exactly to the cap.
            S = min(self._bucket(take), self.max_len - off)
            take = min(take, S)
            part = toks[off:off + take]
            padded = np.zeros((1, S), np.int64)
            padded[0, :len(part)] = part
            if off == 0 and len(part) == L:
                # Whole prompt in one go: within-chunk attention ([S,S]
                # scores, no history pass) is the cheapest path.
                last_logits, self.cache = self._mr.prefill(
                    self.params, self._dev(padded), len(part), slot,
                    self.cache, config=self.model_config,
                    **self._lora_kw([lora_ix]))
            else:
                last_logits, self.cache = self._mr.prefill_at(
                    self.params, self._dev(padded), len(part), off, slot,
                    self.cache, config=self.model_config)
            off += len(part)
        if cfg.enable_prefix_caching:
            self._store_prefix(slot, toks)
        if self.draft is not None:
            self._draft_prefill(slot, toks)
        return last_logits

    # -- paged KV (llm/kv_pages.py) ---------------------------------------

    def _set_table(self, slot: int, pages: list[int]) -> None:
        self._page_tables[slot] = pages
        self._block_tables[slot, :] = 0
        self._block_tables[slot, :len(pages)] = pages

    def _alloc_pages(self, n: int) -> list[int]:
        """Allocate ``n`` pages, LRU-evicting prefix-cache entries under
        pressure (their pages are only reclaimed once no slot shares
        them — refcounts — so eviction never corrupts a live sequence)."""
        while True:
            try:
                return self.kv_alloc.alloc(n)
            except KVPageError:
                if not self._evict_one_prefix():
                    raise

    def _evict_one_prefix(self) -> bool:
        if self.kv_alloc is None or not self._prefix_pool:
            return False
        _, pages = self._prefix_pool.popitem(last=False)
        self.kv_alloc.free(pages)
        return True

    def _release_slot(self, slot: int) -> None:
        """Retire a slot: decref its KV pages (paged mode) and clear it.
        Every path that vacates a slot must come through here or pages
        leak."""
        if self.kv_alloc is not None and self._page_tables[slot]:
            self.kv_alloc.free(self._page_tables[slot])
            self._set_table(slot, [])
        self.slots[slot] = None

    def _prefill_into_paged(self, slot: int, toks: list[int],
                            lora_ix: int = 0):
        """Paged-mode prompt prefill: pin any shared prefix pages, then
        allocate + fill the tail, in chunks of prefill_chunk when set.
        Exception-safe: on pool exhaustion all refs taken here are
        released before the KVPageError propagates (the caller requeues
        the request)."""
        cfg = self.config
        L = len(toks)
        page = self.page_size
        pos0 = 0
        table: list[int] = list(self._page_tables[slot])
        if not table:
            if cfg.enable_prefix_caching:
                pos0, table = self._install_cached_prefix_paged(toks)
            n_tail = -(-L // page) - len(table)
            try:
                tail = self._alloc_pages(n_tail) if n_tail > 0 else []
            except KVPageError:
                self.kv_alloc.free(table)  # undo the prefix pins
                raise
            self._set_table(slot, table + tail)
        bt = self._dev(self._block_tables[slot])
        T = self._max_blocks * page
        chunk = cfg.prefill_chunk if cfg.prefill_chunk > 0 else L - pos0
        off = pos0
        while off < L:
            take = min(chunk, L - off)
            S = min(self._bucket(take), T - off)
            padded = np.zeros((1, S), np.int64)
            padded[0, :take] = toks[off:off + take]
            if off == 0 and take == L:
                last_logits, self.cache = kv_pages.paged_prefill(
                    self.params, self._dev(padded), L, bt, self.cache,
                    config=self.model_config, **self._lora_kw([lora_ix]))
            else:
                # Past a pinned prefix or an earlier chunk: off is
                # page-aligned (installs hand out whole pages, chunks are
                # page multiples), so the chunk lands in this slot's own
                # pages and shared ones stay read-only — copy-on-write by
                # construction.
                last_logits, self.cache = kv_pages.paged_prefill_at(
                    self.params, self._dev(padded), take, off, bt,
                    self.cache, config=self.model_config)
            off += take
        if cfg.enable_prefix_caching:
            self._store_prefix_paged(slot, toks)
        return last_logits

    def _install_cached_prefix_paged(self, toks: list[int]):
        """Paged prefix hit = page *pinning*, not a row copy: find the
        longest page-aligned common prefix in the pool and incref its
        pages. Returns (covered_tokens, pinned_pages)."""
        self.prefix_cache_queries += 1
        page = self.page_size
        best_key, best_d = self._best_prefix(toks, page)
        if best_key is None:
            return 0, []
        self._prefix_pool.move_to_end(best_key)
        pages = list(self._prefix_pool[best_key][: best_d // page])
        self.kv_alloc.incref(pages)
        self.prefix_cache_hits += 1
        return best_d, pages

    def _store_prefix_paged(self, slot: int, toks: list[int]) -> None:
        """Pin this prompt's leading pages as a prefix-cache entry (no
        bytes copied, the entry just holds a reference)."""
        page = self.page_size
        key = self._prefix_key(toks, page)
        if key is None:
            return
        pages = list(self._page_tables[slot][: len(key) // page])
        self.kv_alloc.incref(pages)
        self._prefix_pool[key] = pages
        while len(self._prefix_pool) > self.config.prefix_cache_entries:
            _, old = self._prefix_pool.popitem(last=False)
            self.kv_alloc.free(old)

    def kv_stats(self) -> dict:
        """Paged-KV + prefix-cache accounting for telemetry/gauges."""
        out = {
            "paged": self.kv_alloc is not None,
            "prefix_hits": self.prefix_cache_hits,
            "prefix_queries": self.prefix_cache_queries,
        }
        if self.kv_alloc is not None:
            out.update(self.kv_alloc.stats())
        return out

    def _draft_prefill(self, slot: int, toks: list[int]) -> None:
        """Mirror the prompt into the draft model's slot cache so its
        proposals start from real context. Prompts are capped at
        max_len - 1 and _bucket never exceeds max_len, so one bucketed
        whole-prompt prefill suffices."""
        d = self.draft
        L = len(toks)
        padded = np.zeros((1, self._bucket(L)), np.int64)
        padded[0, :L] = toks
        _, d["cache"] = model_runner.prefill(
            d["params"], self._dev(padded), L, slot, d["cache"],
            config=d["config"])

    # -- prefix cache ------------------------------------------------------

    @staticmethod
    def _common_prefix(a: tuple, b: list[int]) -> int:
        n = min(len(a), len(b))
        for i in range(n):
            if a[i] != b[i]:
                return i
        return n

    def _best_prefix(self, toks: list[int], block: int):
        """The pool entry sharing the longest block-rounded common prefix
        with the prompt (<= len(toks) - 1: at least one token must
        prefill to yield the next-token logits), and that length."""
        limit = len(toks) - 1
        best_key, best_d = None, 0
        for key in self._prefix_pool:
            d = min(self._common_prefix(key, toks), limit)
            d = (d // block) * block
            if d > best_d:
                best_key, best_d = key, d
        return best_key, best_d

    def _prefix_key(self, toks: list[int], block: int):
        """The key this prompt is stored under (block-rounded, capped to
        L-1 so the entry serves an identical future prompt), or None when
        it is too short or an existing entry already covers it. Entries
        the new key supersedes are dropped (pages unpinned)."""
        plen = ((len(toks) - 1) // block) * block
        if plen < block:
            return None
        key = tuple(toks[:plen])
        for existing in list(self._prefix_pool):
            if len(existing) >= plen:
                if existing[:plen] == key:
                    self._prefix_pool.move_to_end(existing)
                    return None  # covered by a (longer) entry's prefix
            elif key[:len(existing)] == existing:
                old = self._prefix_pool.pop(existing)  # we supersede it
                if self.kv_alloc is not None:
                    self.kv_alloc.free(old)
        return key

    def _install_cached_prefix(self, slot: int, toks: list[int]) -> int:
        """Copy the K/V rows of the entry sharing the longest common
        prefix (block-rounded — an entry's sub-prefix is just a row
        slice, so divergence mid-entry still hits) into the slot.
        Returns the number of prompt tokens covered."""
        self.prefix_cache_queries += 1
        best_key, best_d = self._best_prefix(
            toks, max(1, self.config.prefix_block))
        if best_key is None:
            return 0
        self._prefix_pool.move_to_end(best_key)
        kp, vp = self._prefix_pool[best_key]
        model_runner.install_prefix(self.cache, slot, kp[:, :best_d],
                                    vp[:, :best_d])
        self.prefix_cache_hits += 1
        return best_d

    def _store_prefix(self, slot: int, toks: list[int]) -> None:
        """Save a copy of this prompt's K/V rows unless an existing
        entry already covers them; LRU-evict beyond capacity."""
        key = self._prefix_key(toks, max(1, self.config.prefix_block))
        if key is None:
            return
        self._prefix_pool[key] = model_runner.read_prefix(
            self.cache, slot, len(key))
        while len(self._prefix_pool) > self.config.prefix_cache_entries:
            self._prefix_pool.popitem(last=False)

    # -- host-side sampling --------------------------------------------------

    @staticmethod
    def _host_filter(x: np.ndarray, sp: SamplingParams) -> np.ndarray:
        """Numpy mirror of filter_top_k_top_p with the same clamps as
        the device program: top_k clamped into [1, V], top_p <= 0 keeps
        (at least) the crossing token, so no user value can crash."""
        V = len(x)
        if sp.top_k and sp.top_k > 0:
            k = min(max(int(sp.top_k), 1), V)
            kth = np.partition(x, V - k)[V - k]
            x = np.where(x >= kth, x, -np.inf)
        if sp.top_p < 1.0:
            order = np.argsort(-x)
            px = np.exp(x[order] - x[order[0]])
            px = px / px.sum()
            cum = np.cumsum(px)
            keep_sorted = (cum - px) < sp.top_p
            keep_sorted[0] = True  # the crossing token is always kept
            cutoff = x[order[np.nonzero(keep_sorted)[0][-1]]]
            x = np.where(x >= cutoff, x, -np.inf)
        if sp.min_p > 0.0:
            # Same rule as the device program: drop tokens whose
            # probability is below min_p * max_prob (argmax survives).
            mp = min(max(sp.min_p, 0.0), 1.0)
            x = np.where(x >= x.max() + np.log(max(mp, 1e-10)), x, -np.inf)
        return x

    def _sample_host(self, logits: np.ndarray, slot: int, req: Request) -> int:
        """First-token sampling (host side, numpy): same pipeline as the
        device program — penalties -> temperature -> top_k/top_p ->
        sample — seeded from the slot's seed, exactly as ray_tpu's
        engine draws it. Later tokens come from the decode step or the
        advanced_sample program."""
        sp = req.params
        logits = logits.astype(np.float64)
        for tid, b in sp.logit_bias:
            logits[int(tid)] += float(b)
        if sp.repetition_penalty != 1.0:
            seen = np.unique(np.asarray(req.prompt_tokens, np.int64))
            vals = logits[seen]
            logits[seen] = np.where(vals > 0,
                                    vals / sp.repetition_penalty,
                                    vals * sp.repetition_penalty)
        # presence/frequency apply to GENERATED tokens only — none yet.
        if sp.temperature <= 0.0:
            tok = int(logits.argmax())
            dist = logits
        else:
            dist = self._host_filter(logits / max(sp.temperature, 1e-6), sp)
            p = np.exp(dist - dist.max())
            p = p / p.sum()
            rng = np.random.default_rng(int(self.seeds[slot]))
            tok = int(rng.choice(len(p), p=p))
        if req.logprobs is not None:
            # Same distribution the device program reports: the final
            # processed one (penalized for greedy rows, penalized +
            # temperature + filtered for sampled rows).
            req.logprobs.append(self._host_logprob_entry(dist, sp, tok))
        return tok

    @staticmethod
    def _host_logprob_entry(dist: np.ndarray, sp: SamplingParams,
                            tok: int) -> dict:
        """Logprob record over the final processed distribution."""
        logp = dist - np.logaddexp.reduce(dist[np.isfinite(dist)])
        n = min(sp.logprobs, len(logp))
        top_idx = np.argpartition(-logp, n - 1)[:n] if n > 0 else []
        return {"token_id": tok, "logprob": float(logp[tok]),
                "top": {int(i): float(logp[i])
                        for i in sorted(top_idx, key=lambda i: -logp[i])}}

    def _stop_ids(self, sp: SamplingParams) -> set[int]:
        stop = set(sp.stop_token_ids)
        if sp.ignore_eos:
            # vLLM ignore_eos: generate through the tokenizer's eos;
            # EXPLICIT stop_token_ids still apply.
            return stop
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            stop.add(int(eos))
        return stop

    # -- retiring ------------------------------------------------------------

    def _maybe_finish(self, slot: int, outputs: list[RequestOutput]) -> None:
        req = self.slots[slot]
        pos = int(self.positions[slot])
        reason = None
        text = None
        # vLLM min_tokens: every stop condition is suppressed until the
        # request has generated at least this many tokens.
        stops_armed = len(req.generated) >= req.params.min_tokens
        if (stops_armed and req.generated
                and req.generated[-1] in self._stop_ids(req.params)):
            req.generated.pop()  # don't surface the stop token
            if req.logprobs:
                req.logprobs = req.logprobs[: len(req.generated)]
            reason = "stop"
        elif stops_armed and req.params.stop:
            # Stop STRINGS (vLLM `stop`): end at the first occurrence,
            # trimming the match (and anything after) from the text.
            # Decode only a tail window per token (stop strings are
            # short; earlier occurrences were checked on earlier
            # tokens); on a hit, decode once in full to find the cut.
            max_chars = max(len(s) for s in req.params.stop)
            window = min(len(req.generated), 16 + 2 * max_chars)
            tail = self.tokenizer.decode(req.generated[-window:])
            if any(s in tail for s in req.params.stop):
                decoded = self.tokenizer.decode(req.generated)
                # min_tokens suppressed earlier matches; on arming, only
                # matches extending past the suppressed prefix count.
                start = 0
                if req.params.min_tokens > 0:
                    prefix = self.tokenizer.decode(
                        req.generated[:req.params.min_tokens])
                    start = max(0, len(prefix) - max_chars + 1)
                cut = min((i for i in
                           (decoded.find(s, start)
                            for s in req.params.stop)
                           if i >= 0), default=-1)
                if cut >= 0:
                    text = decoded[:cut]
                    # Keep token_ids/logprobs consistent with the trimmed
                    # text: retain the shortest token prefix whose decode
                    # covers the kept text.
                    n = len(req.generated)
                    while n > 0 and len(
                            self.tokenizer.decode(req.generated[:n - 1])
                    ) >= cut:
                        n -= 1
                    req.generated = req.generated[:n]
                    if req.logprobs:
                        req.logprobs = req.logprobs[:n]
                    reason = "stop"
        if reason is None:
            if len(req.generated) >= req.params.max_tokens:
                reason = "length"
            elif pos >= self.max_len - 1:
                reason = "length"  # KV cache exhausted
        if reason is not None:
            self._finish(slot, reason, outputs, text)

    def _finish(self, slot: int, reason: str, outputs: list[RequestOutput],
                text: "str | None" = None) -> None:
        """Surface a slot's request with ``reason`` and free the slot."""
        req = self.slots[slot]
        req.finished = True
        req.finish_reason = reason
        guided_err = None
        if req.guided is not None:
            _ok, guided_err = req.guided.finished_ok()
        outputs.append(RequestOutput(
            request_id=req.request_id,
            token_ids=list(req.generated),
            text=(text if text is not None
                  else self.tokenizer.decode(req.generated)),
            finish_reason=reason,
            num_prompt_tokens=len(req.prompt_tokens),
            logprobs=req.logprobs,
            error=guided_err,
        ))
        self._emit_span(
            req, "llm.decode", req.t_first or req.t_add, time.time(),
            {"tokens": len(req.generated), "finish_reason": reason})
        self._release_slot(slot)

    @staticmethod
    def _emit_span(req: Request, name: str, start: float, end: float,
                   attributes: "dict | None" = None) -> None:
        """Buffer one engine span into the request's trace (the port's
        traceplane flushes it with the owner's next report). No-op for
        untraced or unsampled requests, so a batch generate() emits no
        span."""
        tc = req.trace_ctx
        if not (tc and int(tc[2] or 0)):
            return
        from ray_tpu_torch._private import traceplane

        traceplane.buffer_span({
            "event": "span",
            "name": name,
            "kind": "llm",
            "trace_id": tc[0],
            "span_id": traceplane.new_span_id(),
            "parent_span_id": tc[1],
            "pid": os.getpid(),
            "start": start,
            "end": end,
            "failed": False,
            "attributes": {"request_id": req.request_id,
                           **(attributes or {})},
        })

    def _ensure_page_capacity(self, active: list[int],
                              outputs: list[RequestOutput]) -> list[int]:
        """Paged mode: this step's KV write for slot b lands at logical
        position pos[b] — if that crosses into an unallocated page, grow
        the slot's block table now (on-demand allocation is what lets
        the pool overcommit). A slot that cannot get a page even after
        prefix eviction finishes with "length" — bounded, never wedged."""
        page = self.page_size
        still: list[int] = []
        for slot in active:
            blk = int(self.positions[slot]) // page
            table = self._page_tables[slot]
            if blk < len(table):
                still.append(slot)
                continue
            try:
                new = self._alloc_pages(1)
            except KVPageError:
                self._finish(slot, "length", outputs)
                continue
            table.append(new[0])
            self._block_tables[slot, len(table) - 1] = new[0]
            still.append(slot)
        return still

    # -- the engine iteration ---------------------------------------------

    def step(self) -> list[RequestOutput]:
        """One engine iteration: admit waiting requests, then advance all
        active slots one token (or a speculative window). Returns
        outputs finished this step."""
        outputs: list[RequestOutput] = []
        self._admit(outputs)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if self.kv_alloc is not None and active:
            active = self._ensure_page_capacity(active, outputs)
        if not active:
            return outputs
        if self.draft is not None and all(self._spec_ok[s] for s in active):
            return self._spec_step(active, outputs)
        temps = self._dev(self.temps)
        if self.draft is not None:
            self.spec_stats["fallback_steps"] += 1
            # Keep the draft cache in lockstep through fallback steps:
            # write draft K/V rows for the tokens this step consumes
            # (output discarded), or the next _spec_step's chain would
            # attend holes. Only greedy slots can re-enter _spec_step, so
            # an all-sampled batch skips the draft pass.
            if any(self._spec_ok[s] for s in active):
                _, _, self.draft["cache"] = model_runner.decode(
                    self.draft["params"], self._dev(self.last_tokens),
                    self._dev(self.positions), self.draft["cache"], temps,
                    self._rng, config=self.draft["config"])
        lkw = self._lora_kw(self.lora_ix)
        if self.kv_alloc is not None:
            toks, logits, self.cache = kv_pages.paged_decode(
                self.params, self._dev(self.last_tokens),
                self._dev(self.positions), self._dev(self._block_tables),
                self.cache, temps, self._rng, config=self.model_config,
                **lkw)
        else:
            toks, logits, self.cache = self._mr.decode(
                self.params, self._dev(self.last_tokens),
                self._dev(self.positions), self.cache, temps, self._rng,
                config=self.model_config, **lkw)
        lp_info = None
        if not all(self._plain[s] for s in active):
            # Extended sampling program over this step's logits: replaces
            # the in-decode choice for the whole batch (plain slots get
            # identical semantics — penalties off, filters open).
            want_lp = any(self.slots[s].params.logprobs > 0 for s in active)
            steps = np.asarray([len(s.generated) if s is not None else 0
                                for s in self.slots], np.int64)
            toks, chosen_lp, top_vals, top_ids, self._counts = (
                model_runner.advanced_sample(
                    logits, temps, self._dev(self.top_ks),
                    self._dev(self.top_ps), self._dev(self.min_ps),
                    self._dev(self.pres_pens), self._dev(self.freq_pens),
                    self._dev(self.rep_pens), self._counts,
                    self._prompt_mask, self._dev(self.seeds),
                    self._dev(steps), self._dev(self.bias_ids),
                    self._dev(self.bias_vals),
                    max_logprobs=MAX_LOGPROBS if want_lp else 0))
            if want_lp:
                lp_info = (chosen_lp.cpu().numpy(), top_vals.cpu().numpy(),
                           top_ids.cpu().numpy())
        toks = toks.cpu().numpy()
        # Guided slots re-pick host-side under the JSON vocab mask (the
        # device program chose unconstrained; logits are this step's).
        guided_overrides: dict[int, int] = {}
        if any(self.slots[s].guided is not None for s in active):
            logits_np = logits.cpu().numpy()
            for slot in active:
                req = self.slots[slot]
                if req.guided is not None:
                    guided_overrides[slot] = self._guided_sample(
                        req, slot, logits_np[slot])
        # Only active slots advance; inactive slots' writes land at their
        # stale position and are reclaimed by the next prefill's mask.
        self.positions[active] += 1
        self._step_count += 1
        for slot in active:
            req = self.slots[slot]
            tok = guided_overrides.get(slot, int(toks[slot]))
            self.last_tokens[slot] = tok
            req.generated.append(tok)
            if (req.logprobs is not None and lp_info is not None
                    and slot not in guided_overrides):
                chosen_lp, top_vals, top_ids = lp_info
                n = req.params.logprobs
                req.logprobs.append({
                    "token_id": tok, "logprob": float(chosen_lp[slot]),
                    "top": {int(i): float(v)
                            for i, v in zip(top_ids[slot][:n],
                                            top_vals[slot][:n])},
                })
            self._maybe_finish(slot, outputs)
        if self.lora_mgr is not None and self.lora_mgr.has_retired():
            # Quiesce-complete check: recycle adapter slots whose last
            # referencing sequence finished this step.
            self.lora_mgr.reclaim(self._active_lora_ixs())
        return outputs

    def _spec_step(self, active: list[int],
                   outputs: list[RequestOutput]) -> list[RequestOutput]:
        """One speculative iteration (all active slots greedy).

        Chain draft-model decodes to propose a window, verify the whole
        window with one target pass, then accept the longest prefix where
        each proposal equals the target's greedy choice — plus the
        target's own next token as a bonus. Emitted tokens are the
        target's greedy tokens (acceptance only keeps proposals the
        target would have produced from the same window).
        """
        d = self.draft
        k = self.spec_k
        cur = self.last_tokens.copy()
        pos = self.positions.copy()
        window = [cur.copy()]
        zero_t = torch.zeros((len(self.slots),), dtype=torch.float32,
                             device=self.device)
        for _ in range(k - 1):
            toks_j, _, d["cache"] = model_runner.decode(
                d["params"], self._dev(cur), self._dev(pos), d["cache"],
                zero_t, self._rng, config=d["config"])
            cur = toks_j.cpu().numpy()
            pos = pos + 1
            window.append(cur.copy())
        # One extra draft decode consuming the LAST proposal (output
        # discarded): if the full window is accepted, that proposal's
        # draft K/V row must exist — otherwise the draft cache carries a
        # permanently stale row and every later proposal degrades.
        _, _, d["cache"] = model_runner.decode(
            d["params"], self._dev(cur), self._dev(pos), d["cache"], zero_t,
            self._rng, config=d["config"])
        tokens_window = np.stack(window, axis=1)  # [B, k]
        logits, self.cache = self._mr.verify(
            self.params, self._dev(tokens_window), self._dev(self.positions),
            self.cache, config=self.model_config)
        greedy = logits.argmax(-1).cpu().numpy()  # [B, k]

        self._step_count += 1
        self.spec_stats["spec_steps"] += 1
        for slot in active:
            prop = tokens_window[slot]
            g = greedy[slot]
            n = 0
            while n < k - 1 and prop[n + 1] == g[n]:
                n += 1
            self.spec_stats["proposed"] += k - 1
            self.spec_stats["accepted"] += n
            # prop[1..n] are the accepted drafts (== g[0..n-1]); g[n] is
            # the target's next token after them (the bonus).
            emitted = [int(t) for t in prop[1:n + 1]] + [int(g[n])]
            req = self.slots[slot]
            for tok in emitted:
                self.positions[slot] += 1
                self.last_tokens[slot] = tok
                req.generated.append(tok)
                self._maybe_finish(slot, outputs)
                if self.slots[slot] is None:
                    break
        return outputs

    # -- convenience batch API --------------------------------------------

    def generate(self, prompts: Iterable[str | list[int]],
                 sampling_params: "SamplingParams | list[SamplingParams] | None" = None,
                 ) -> list[RequestOutput]:
        """Run a batch of prompts to completion. ``sampling_params`` may
        be one SamplingParams for the whole batch or a list (one per
        prompt). Thread-safe: concurrent callers are serialized on the
        engine lock, and request ids are unique per call so interleaved
        batches can never swap outputs."""
        import uuid

        with self._lock:
            tag = uuid.uuid4().hex[:8]
            # Tokenize/validate every prompt BEFORE enqueuing any: a
            # mid-batch validation error must not leave earlier requests
            # orphaned in the waiting queue.
            toks_list = [
                (self.tokenizer.encode(p) if isinstance(p, str) else list(p))
                for p in prompts
            ]
            for i, toks in enumerate(toks_list):
                if not toks:
                    raise ValueError(f"prompt {i} of this batch is empty")
            if isinstance(sampling_params, (list, tuple)):
                if len(sampling_params) != len(toks_list):
                    raise ValueError(
                        f"sampling_params list ({len(sampling_params)}) must "
                        f"match prompts ({len(toks_list)})")
                sp_list = list(sampling_params)
            else:
                sp_list = [sampling_params] * len(toks_list)
            order = [f"req-{tag}-{i}" for i in range(len(toks_list))]
            for rid, toks, sp in zip(order, toks_list, sp_list):
                self.add_request(rid, toks, sp)
            mine = set(order)
            done: dict[str, RequestOutput] = {}
            # Step until THIS call's requests finish. Other requests (an
            # AsyncLLMEngine's) may share the batch; their outputs go to
            # the registered listener, never dropped.
            while len(done) < len(mine) and self.has_unfinished():
                for out in self.step():
                    if out.request_id in mine:
                        done[out.request_id] = out
                    elif self._foreign_output_listener is not None:
                        self._foreign_output_listener(out)
            return [done[rid] for rid in order]


_NOTHING_YET = object()
_STREAM_POLL_S = 0.25


def _next_item(q: queue.SimpleQueue):
    """A stream's next item, or _NOTHING_YET after _STREAM_POLL_S: the
    executor thread that waits here is never parked for long, so a
    cancelled stream leaves no thread for ``asyncio.run`` to wait on."""
    try:
        return q.get(timeout=_STREAM_POLL_S)
    except queue.Empty:
        return _NOTHING_YET


class AsyncLLMEngine:
    """Async request-level driver over LLMEngine (port of ray_tpu's). One
    background thread drives ``engine.step()``; callers submit requests
    and await per-request futures, so requests from concurrent callers
    join the same running batch instead of serializing whole batches
    behind the engine lock as the sync ``generate()`` does.

    ``generate(..., stream=True)`` returns an async iterator of token ids
    as the slot advances, then the final RequestOutput.
    ``generate(..., deadline=...)`` (wall-clock seconds) makes each step
    evict the request once its deadline passed, waiting or mid-decode,
    with a ``TaskTimeoutError``; its slot and KV pages are freed.
    ``snapshot()`` reports the token-level batch view.

    The stepping thread runs under ``torch.no_grad()`` and on the
    engine's CUDA device: both are per thread in torch. (no_grad, not
    inference_mode: tensors the engine keeps are updated in place by a
    sync ``generate()`` outside either.)

    Admission differs from ray_tpu's, which queues each request under the
    engine lock from the caller: a lock is not handed to the thread that
    waits longest, and the stepping thread, taking it again step after
    step, kept callers out for dozens of steps. Here a caller checks its
    request (``LLMEngine._new_request``) and puts it in ``_inbox``; the
    stepping thread queues the inbox at the top of every step.
    """

    def __init__(self, engine: LLMEngine):
        self.engine = engine
        # The engine's own lock: sync generate() and this driver never
        # interleave engine state mutations.
        self._lock = engine._lock
        self._waiters: dict[str, Any] = {}          # rid -> concurrent Future
        self._streams: dict[str, queue.SimpleQueue] = {}
        self._seen: dict[str, int] = {}             # rid -> tokens streamed
        self._deadlines: dict[str, float] = {}      # rid -> wall-clock s
        # (Request, Future or stream queue, deadline) from the callers
        self._inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._evicted_deadline = 0
        self._wake = threading.Event()
        # A sync engine.generate() called while we have requests in flight
        # delivers our outputs here.
        engine._foreign_output_listener = self._deliver
        # The card the engine's tensors are on ("cuda" alone means the
        # creating thread's current card), for the stepping thread.
        self._cuda_index = None
        if engine.device.type == "cuda":
            self._cuda_index = (engine.device.index if engine.device.index is not None
                                else torch.cuda.current_device())
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="llm-engine-loop")
        self._thread.start()

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        with torch.no_grad():
            while True:
                self._wake.wait()
                while True:
                    with self._lock:
                        self._admit_inbox()
                        # Drive only while async-owned requests are
                        # pending: foreign (sync generate()) requests are
                        # stepped by their own caller, and spinning on
                        # them would busy-loop if step() kept raising.
                        if (not (self._waiters or self._streams)
                                or not self.engine.has_unfinished()):
                            # Clear, then look again: a request put in
                            # since _admit_inbox set the event before it.
                            self._wake.clear()
                            if self._inbox.empty():
                                break
                            continue
                        try:
                            self._evict_expired()
                            outs = self.engine.step()
                            self._push_stream_tokens()
                        except Exception as e:  # noqa: BLE001
                            # A dead driver thread would hang every pending
                            # and future request: fail them and go on.
                            self._fail_all(e)
                            continue
                    for out in outs:
                        self._deliver(out)

    def _submit(self, req: Request, sink, deadline: "float | None") -> None:
        """Hand ``req`` to the stepping thread; ``sink`` is its Future or
        its stream's queue."""
        self._inbox.put((req, sink, deadline))
        self._wake.set()

    def _admit_inbox(self) -> None:
        """lock held. Register and queue every request the callers have
        handed over."""
        while True:
            try:
                req, sink, deadline = self._inbox.get_nowait()
            except queue.Empty:
                return
            rid = req.request_id
            if isinstance(sink, queue.SimpleQueue):
                self._streams[rid] = sink
                self._seen[rid] = 0
            else:
                self._waiters[rid] = sink
            if deadline is not None:
                self._deadlines[rid] = deadline
            self.engine.waiting.append(req)

    def _deliver(self, out: RequestOutput) -> None:
        """Resolve the waiter or stream of one finished request (from the
        driver loop, and from a sync generate() sharing the batch)."""
        q = self._streams.pop(out.request_id, None)
        if q is not None:
            # The finishing step's tokens never reach _push_stream_tokens
            # (step() clears the slot): emit the unseen tail first.
            n = self._seen.get(out.request_id, 0)
            for tok in out.token_ids[n:]:
                q.put(int(tok))
            q.put(out)  # terminal: the RequestOutput itself
        self._seen.pop(out.request_id, None)
        self._deadlines.pop(out.request_id, None)
        fut = self._waiters.pop(out.request_id, None)
        if fut is not None and not fut.done():
            fut.set_result(out)

    def _drop(self, rids: set) -> None:
        """lock held. Remove ``rids`` from the engine's queue and slots,
        each slot through _release_slot so that its KV pages are freed."""
        self.engine.waiting = collections.deque(
            r for r in self.engine.waiting if r.request_id not in rids)
        for i, r in enumerate(self.engine.slots):
            if r is not None and r.request_id in rids:
                self.engine._release_slot(i)

    def _evict_expired(self) -> None:
        """lock held. Fail owned requests whose deadline passed with a
        TaskTimeoutError and remove them from the engine."""
        if not self._deadlines:
            return
        now = time.time()
        expired = [rid for rid, dl in self._deadlines.items() if now > dl]
        if not expired:
            return
        for rid in expired:
            self._deadlines.pop(rid, None)
            exc = TaskTimeoutError(
                "TaskTimeoutError: request exceeded its deadline during "
                "LLM decode (evicted from the running batch)",
                where="llm_decode")
            fut = self._waiters.pop(rid, None)
            if fut is not None and not fut.done():
                fut.set_exception(exc)
            q = self._streams.pop(rid, None)
            if q is not None:
                q.put(exc)
            self._seen.pop(rid, None)
            self._evicted_deadline += 1
        self._drop(set(expired))

    def snapshot(self) -> dict:
        """Token-level batch view for replica telemetry."""
        with self._lock:
            self._admit_inbox()
            return {
                "waiting": len(self.engine.waiting),
                "active": sum(1 for s in self.engine.slots if s is not None),
                "slots": len(self.engine.slots),
                "owned": len(self._waiters) + len(self._streams),
                "evicted_deadline": self._evicted_deadline,
                "kv": self.engine.kv_stats(),
            }

    def _fail_all(self, exc: Exception) -> None:
        """lock held. Resolve every async-owned pending request with the
        failure and remove only those from the engine: requests of a
        concurrent sync generate() stay, or its loop would end early and
        miss its own request ids."""
        owned = set(self._waiters) | set(self._streams)
        for fut in self._waiters.values():
            if not fut.done():
                fut.set_exception(exc)
        self._waiters.clear()
        for q in self._streams.values():
            q.put(exc)  # the stream's iterator raises it
        self._streams.clear()
        self._seen.clear()
        for rid in owned:
            self._deadlines.pop(rid, None)
        self._drop(owned)

    def _push_stream_tokens(self) -> None:
        """lock held. Emit the tokens generated since the last step to the
        stream queues."""
        if not self._streams:
            return
        for slot_req in self.engine.slots:
            if slot_req is None:
                continue
            q = self._streams.get(slot_req.request_id)
            if q is None:
                continue
            n = self._seen.get(slot_req.request_id, 0)
            for tok in slot_req.generated[n:]:
                q.put(int(tok))
            self._seen[slot_req.request_id] = len(slot_req.generated)

    async def generate(self, prompt: "str | list[int]",
                       sampling_params: SamplingParams | None = None,
                       stream: bool = False,
                       deadline: "float | None" = None):
        """Awaitable single-request generation; with stream=True an async
        iterator yielding token ids, then the final RequestOutput.
        ``deadline`` (wall-clock seconds) makes the decode loop evict this
        request once expired."""
        import asyncio
        import concurrent.futures
        import uuid

        loop = asyncio.get_running_loop()
        rid = f"areq-{uuid.uuid4().hex[:12]}"
        # Tokenize off the event loop (the only slow work before admission).
        if isinstance(prompt, str):
            toks = await loop.run_in_executor(None, self.engine.tokenizer.encode, prompt)
        else:
            toks = list(prompt)
        # Checked here, so that a bad request raises in its caller.
        req = self.engine._new_request(rid, toks, sampling_params)
        if stream:
            q: queue.SimpleQueue = queue.SimpleQueue()
            self._submit(req, q, deadline)

            async def aiter():
                while True:
                    item = await loop.run_in_executor(None, _next_item, q)
                    if item is _NOTHING_YET:
                        continue
                    if isinstance(item, Exception):
                        raise item
                    yield item
                    if isinstance(item, RequestOutput):
                        return

            return aiter()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._submit(req, fut, deadline)
        return await asyncio.wrap_future(fut)

    async def generate_from_handoff(self, handoff: dict,
                                    sampling_params: SamplingParams | None = None,
                                    deadline: "float | None" = None):
        """Awaitable continuation of a prefill_detached() record: its KV
        pages are installed at admission and it decodes under the same
        continuous batcher and deadline eviction as generate()."""
        import asyncio
        import concurrent.futures
        import uuid

        rid = f"hreq-{uuid.uuid4().hex[:12]}"
        # Checked here, so that a bad record raises in its caller.
        req = self.engine._new_handoff_request(rid, handoff, sampling_params)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._submit(req, fut, deadline)
        return await asyncio.wrap_future(fut)


def _trace_context():
    """The calling task's trace context, or None outside a traced task."""
    from ray_tpu_torch._private import worker_context

    return worker_context.get_trace_context()


def _load_checkpoint(path: str, device):
    """Params from a flat .npz of dotted keys (``layers.attn.wq``), the
    format ray_tpu's engine reads, as tensors on ``device``."""
    if not (os.path.isfile(path) and path.endswith(".npz")):
        raise NotImplementedError(
            f"checkpoint {path!r}: the port reads .npz files only; orbax "
            f"checkpoint directories are not read (ROADMAP.md §3)")
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split(".")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params_from_jax(tree, device)
