"""LLM engine/serving configuration (port of ray_tpu/llm/config.py).

The same two dataclasses with the same fields and methods, so a ray_tpu
config reads the same here. The port's engine (ray_tpu_torch.llm.engine)
takes every option on one device, and with ``tensor_parallel_size`` or
``pipeline_parallel_size`` above 1 it runs one rank's part of the model
over the default process group (``model_runner.TensorParallel``,
``pp_runner.PPRunner``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.models import transformer as tfm


@dataclass
class SamplingParams:
    """Per-request sampling knobs (vLLM SamplingParams)."""

    max_tokens: int = 64
    temperature: float = 0.0
    # Nucleus/top-k filtering (vLLM semantics: top_k <= 0 disables,
    # top_p = 1.0 disables). Applied after penalties and temperature.
    top_k: int = 0
    top_p: float = 1.0
    # vLLM min_p: drop tokens whose post-temperature probability is
    # below min_p * max_prob (0.0 disables).
    min_p: float = 0.0
    # OpenAI-style penalties on generated tokens and the HF-style
    # repetition penalty.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    # Per-request determinism: same seed -> same sample sequence.
    seed: "int | None" = None
    # Return the chosen token's logprob and the top-N alternatives.
    logprobs: int = 0
    stop_token_ids: tuple[int, ...] = ()
    # Stop STRINGS (detokenized match, vLLM `stop`): generation ends at
    # the first occurrence; the match is trimmed from the output text.
    stop: tuple[str, ...] = ()
    # vLLM min_tokens: suppress EVERY stop condition (eos, stop ids,
    # stop strings) until this many tokens have been generated.
    min_tokens: int = 0
    # vLLM ignore_eos: keep generating through the tokenizer's eos
    # (explicit stop_token_ids still apply).
    ignore_eos: bool = False
    # OpenAI logit_bias: ((token_id, bias), ...).
    logit_bias: tuple = ()
    # OpenAI response_format (JSON-guided decoding).
    response_format: "Any | None" = None
    extra: dict[str, Any] = field(default_factory=dict)

    def needs_advanced(self) -> bool:
        """True when this request needs the extended sampling program."""
        return bool(
            self.top_k > 0 or self.top_p < 1.0 or self.min_p > 0.0
            or self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
            or self.repetition_penalty != 1.0 or self.seed is not None
            or self.logprobs > 0 or self.logit_bias
        )

    def greedy_equivalent(self) -> bool:
        """True when sampling reduces to plain argmax over the RAW
        logits (speculative decoding's verify contract): temperature 0
        and nothing that reshapes the distribution's argmax. top_k/top_p
        never change the argmax; penalties do."""
        return (self.temperature <= 0.0
                and self.presence_penalty == 0.0
                and self.frequency_penalty == 0.0
                and self.repetition_penalty == 1.0)


@dataclass
class LLMConfig:
    """Describes one servable model + its engine geometry."""

    model_id: str = "tiny"
    # TransformerConfig instance, or the name of a factory in
    # ray_tpu_torch.models.transformer (e.g. "gpt2_small", "tiny").
    model: Any = None
    max_num_seqs: int = 8  # decode slots (continuous-batching width)
    max_seq_len: int = 512  # KV-cache capacity per slot
    prefill_buckets: tuple[int, ...] = (32, 64, 128, 256)
    # Chunked prefill: prompts longer than this prefill in chunks via
    # prefill_at (0 = whole-prompt, bucketed prefill).
    prefill_chunk: int = 0
    enable_prefix_caching: bool = False
    prefix_block: int = 32
    prefix_cache_entries: int = 16
    # Paged KV (llm/kv_pages.py): tokens per page (0 = dense cache) and
    # the pool's pages (0 = the dense equivalent, max_num_seqs *
    # ceil(max_len / page) + 1; fewer overcommit).
    kv_page_size: int = 0
    kv_num_pages: int = 0
    handoff_timeout_s: float = 0.0
    # Speculative decoding: a draft model (TransformerConfig or factory
    # name) proposes num_speculative_tokens tokens a step, verified in
    # one target pass; greedy slots only.
    speculative_model: Any = None
    num_speculative_tokens: int = 4
    # Multi-LoRA: {"max_adapters": N, "max_rank": R} (llm/lora.py).
    lora: "dict | None" = None
    speculative_checkpoint_path: str | None = None
    speculative_seed: int = 7
    # "byte" (offline-safe, vocab 256+specials) or a HF tokenizer path.
    tokenizer: str = "byte"
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    sampling_defaults: SamplingParams = field(default_factory=SamplingParams)
    # A flat .npz of the params (dotted keys, as ray_tpu writes them).
    checkpoint_path: str | None = None
    seed: int = 0

    def _resolve_named(self, name: str, checkpoint_path: "str | None",
                       what: str) -> tfm.TransformerConfig:
        factory = getattr(tfm, name, None)
        if factory is None:
            raise ValueError(
                f"unknown {what} {name!r}: not a TransformerConfig and not "
                f"a factory in ray_tpu_torch.models.transformer"
            )
        cfg = factory()
        if (self.tokenizer == "byte" and cfg.vocab_size < 512
                and not checkpoint_path):
            # Factory-named models with no checkpoint are randomly
            # initialized, so the vocab can be grown to fit the byte
            # tokenizer's specials (259 ids; 512 keeps the head aligned).
            cfg = dataclasses.replace(cfg, vocab_size=512)
        return cfg

    def resolve_model(self) -> tfm.TransformerConfig:
        if isinstance(self.model, tfm.TransformerConfig):
            return self.model
        if isinstance(self.model, str) or self.model is None:
            return self._resolve_named(self.model or self.model_id,
                                       self.checkpoint_path, "model")
        raise TypeError(
            f"model must be TransformerConfig or str, got {type(self.model)}")

    def resolve_speculative_model(self) -> "tfm.TransformerConfig | None":
        """Draft-model config for speculative decoding (None = off).
        Same resolution rules as resolve_model."""
        sm = self.speculative_model
        if sm is None:
            return None
        if isinstance(sm, tfm.TransformerConfig):
            return sm
        if isinstance(sm, str):
            return self._resolve_named(sm, self.speculative_checkpoint_path,
                                       "speculative model")
        raise TypeError(
            f"speculative_model must be TransformerConfig or str, "
            f"got {type(sm)}")
