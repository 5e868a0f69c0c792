"""LLMEngine: continuous-batching decode engine (port of the dense,
single-device path of ray_tpu/llm/engine.py).

A static slot cache (model_runner.py) and a host-side scheduler:

  admit:  while a slot is free and requests wait, prefill the waiting
          prompts into free slots — same-bucket prompts in one batched
          prefill (bucket-padded → few distinct shapes);
  step:   one decode advances every active slot by one token;
  retire: slots finishing (EOS / max_tokens / cache full) free up.

The engine is synchronous; ``generate`` serializes callers on a lock.
Options of ray_tpu's engine that the port does not have yet (paged KV,
tensor/pipeline parallelism, speculative decoding, LoRA, prefix caching,
chunked prefill, extended sampling and guided decoding) raise
NotImplementedError. The port has no tracing plane (it lives in
ray_tpu's runtime core), so the engine emits no spans.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Iterable

import numpy as np
import torch

from ray_tpu_torch.llm import model_runner
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.tokenizer import load_tokenizer
from ray_tpu_torch.models import transformer as tfm

_LATER = "not ported yet (ROADMAP.md §1 item 5: the rest of the LLM plane)"


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_tokens: list[int]
    params: SamplingParams
    generated: list[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None
    t_add: float = 0.0       # enqueue wall time (queue-wait start)
    t_first: float = 0.0     # first-token wall time (decode start)


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    token_ids: list[int]
    text: str
    finish_reason: str | None
    num_prompt_tokens: int


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
        unsupported = {
            "paged KV (kv_page_size)": config.kv_page_size,
            "tensor parallelism": int(config.tensor_parallel_size or 1) > 1,
            "pipeline parallelism": int(config.pipeline_parallel_size or 1) > 1,
            "speculative decoding": config.speculative_model is not None,
            "LoRA": config.lora,
            "prefix caching": config.enable_prefix_caching,
            "chunked prefill": config.prefill_chunk,
            "checkpoint loading": config.checkpoint_path,
        }
        for what, on in unsupported.items():
            if on:
                raise NotImplementedError(f"{what}: {_LATER}")
        tok_vocab = len(self.tokenizer)
        if tok_vocab > c.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tok_vocab}, incl. special tokens) exceeds "
                f"model vocab_size ({c.vocab_size}); special-token ids would "
                f"index past the embedding. Use a model with "
                f"vocab_size >= {tok_vocab}."
            )
        # Engine cache capacity is capped by the model's position capacity.
        self.max_len = min(config.max_seq_len, c.max_seq_len)
        if params is None:
            gen = torch.Generator().manual_seed(config.seed)
            params = tfm.init_params(gen, c, device=device)
        B = config.max_num_seqs
        self.device = torch.device(device)
        self.params = params
        self.cache = model_runner.init_slot_cache(c, B, self.max_len,
                                                  device=device)
        # Host-side scheduling state, uploaded per decode call: keeping
        # positions on the host avoids a device→host sync per slot.
        self.positions = np.zeros((B,), np.int64)
        self.last_tokens = np.zeros((B,), np.int64)
        self.temps = np.zeros((B,), np.float32)
        self.seeds = np.zeros((B,), np.uint32)
        self.slots: list[Request | None] = [None] * B
        self.waiting: collections.deque[Request] = collections.deque()
        self._host_rng = np.random.default_rng(config.seed + 1)
        self._rng = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)
        # generate()/step() mutate slot state and the cache in place;
        # concurrent callers are serialized.
        self._lock = threading.Lock()

    # -- request intake ----------------------------------------------------

    def add_request(self, request_id: str, prompt: str | list[int],
                    sampling_params: SamplingParams | None = None) -> None:
        sp = sampling_params or self.config.sampling_defaults
        if sp.needs_advanced() or sp.response_format is not None:
            raise NotImplementedError(
                "extended sampling (top-k/top-p/min-p, penalties, seeds, "
                f"logprobs, logit_bias) and guided decoding: {_LATER}")
        if (sp.extra or {}).get("lora"):
            raise NotImplementedError(f"LoRA: {_LATER}")
        toks = (self.tokenizer.encode(prompt) if isinstance(prompt, str)
                else list(prompt))
        toks = toks[: self.max_len - 1]
        if not toks:
            raise ValueError(
                f"request {request_id!r} has an empty prompt (prefill "
                f"needs at least one token to produce next-token logits)"
            )
        req = Request(request_id, toks, sp)
        req.t_add = time.time()
        self.waiting.append(req)

    def has_unfinished(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    # -- scheduling --------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.config.prefill_buckets:
            if b >= n and b <= self.max_len:
                return b
        return self.max_len

    def _admit(self, outputs: list[RequestOutput]) -> None:
        # Batched admission (vLLM batches prefills): same-bucket prompts
        # prefill in ONE [N, S] pass.
        admits: list[tuple[int, Request]] = []
        for slot in range(len(self.slots)):
            if self.slots[slot] is None and self.waiting:
                admits.append((slot, self.waiting.popleft()))
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
                last_logits = self._prefill_into(slot, req.prompt_tokens)
                self._finish_admit(slot, req, last_logits.cpu().numpy(),
                                   outputs)
                continue
            # Pad the group to the next power of two (bounded set of
            # shapes); pad rows use slot index B — out of range, so
            # model_runner.prefill_batch drops their writes.
            N = 1 << (len(group) - 1).bit_length()
            toks = np.zeros((N, S), np.int64)
            lens = np.ones((N,), np.int64)
            slots_arr = np.full((N,), B, np.int64)
            for j, (slot, req) in enumerate(group):
                L = len(req.prompt_tokens)
                toks[j, :L] = req.prompt_tokens
                lens[j] = L
                slots_arr[j] = slot
            logits, self.cache = model_runner.prefill_batch(
                self.params, torch.from_numpy(toks).to(self.device), lens,
                slots_arr, self.cache, config=self.model_config)
            logits_np = logits.cpu().numpy()
            for j, (slot, req) in enumerate(group):
                self._finish_admit(slot, req, logits_np[j], outputs)

    def _finish_admit(self, slot: int, req: Request,
                      last_logits: np.ndarray,
                      outputs: list[RequestOutput]) -> None:
        """Per-request state wiring after its prompt K/V is in ``slot``
        and its last-token logits are on the host."""
        sp = req.params
        self.positions[slot] = len(req.prompt_tokens)
        self.slots[slot] = req
        self.temps[slot] = sp.temperature
        self.seeds[slot] = self._host_rng.integers(0, 2**32, dtype=np.uint32)
        tok = self._sample_host(last_logits, slot, req)
        self.last_tokens[slot] = tok
        req.generated.append(tok)
        req.t_first = time.time()
        self._maybe_finish(slot, outputs)

    def _prefill_into(self, slot: int, toks: list[int]):
        """Write a prompt's K/V into ``slot`` (whole-prompt prefill) and
        return the last-token logits [V]."""
        L = len(toks)
        # Padded width comes from the bucket set (capped at the cache
        # length) so prompt shapes stay bounded.
        S = self._bucket(L)
        padded = np.zeros((1, S), np.int64)
        padded[0, :L] = toks
        last_logits, self.cache = model_runner.prefill(
            self.params, torch.from_numpy(padded).to(self.device), L, slot,
            self.cache, config=self.model_config)
        return last_logits

    def _release_slot(self, slot: int) -> None:
        """Retire a slot. Every path that vacates a slot comes through
        here."""
        self.slots[slot] = None

    def _sample_host(self, logits: np.ndarray, slot: int, req: Request) -> int:
        """First-token sampling (host side, numpy): greedy, or
        temperature sampling seeded from the slot's seed. Later tokens
        come from the decode step's on-device sampling."""
        sp = req.params
        logits = logits.astype(np.float64)
        if sp.temperature <= 0.0:
            return int(logits.argmax())
        x = logits / max(sp.temperature, 1e-6)
        p = np.exp(x - x.max())
        p = p / p.sum()
        rng = np.random.default_rng(int(self.seeds[slot]))
        return int(rng.choice(len(p), p=p))

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
                    # Keep token_ids consistent with the trimmed text:
                    # retain the shortest token prefix whose decode
                    # covers the kept text.
                    n = len(req.generated)
                    while n > 0 and len(
                            self.tokenizer.decode(req.generated[:n - 1])
                    ) >= cut:
                        n -= 1
                    req.generated = req.generated[:n]
                    reason = "stop"
        if reason is None:
            if len(req.generated) >= req.params.max_tokens:
                reason = "length"
            elif pos >= self.max_len - 1:
                reason = "length"  # KV cache exhausted
        if reason is not None:
            req.finished = True
            req.finish_reason = reason
            outputs.append(RequestOutput(
                request_id=req.request_id,
                token_ids=list(req.generated),
                text=(text if text is not None
                      else self.tokenizer.decode(req.generated)),
                finish_reason=reason,
                num_prompt_tokens=len(req.prompt_tokens),
            ))
            self._release_slot(slot)

    # -- the engine iteration ---------------------------------------------

    def step(self) -> list[RequestOutput]:
        """One engine iteration: admit waiting requests, then advance all
        active slots one token. Returns outputs finished this step."""
        outputs: list[RequestOutput] = []
        self._admit(outputs)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return outputs
        dev = self.device
        toks, _logits, self.cache = model_runner.decode(
            self.params,
            torch.from_numpy(self.last_tokens).to(dev),
            torch.from_numpy(self.positions).to(dev),
            self.cache,
            torch.from_numpy(self.temps).to(dev),
            self._rng,
            config=self.model_config,
        )
        toks = toks.cpu().numpy()
        # Only active slots advance; inactive slots' writes land at their
        # stale position and are reclaimed by the next prefill's mask.
        self.positions[active] += 1
        for slot in active:
            req = self.slots[slot]
            tok = int(toks[slot])
            self.last_tokens[slot] = tok
            req.generated.append(tok)
            self._maybe_finish(slot, outputs)
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
            while len(done) < len(mine) and self.has_unfinished():
                for out in self.step():
                    if out.request_id in mine:
                        done[out.request_id] = out
            return [done[rid] for rid in order]
