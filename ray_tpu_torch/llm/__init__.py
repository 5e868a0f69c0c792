"""ray_tpu_torch.llm: the LLM engine (port of the engine of ray_tpu.llm):
dense or paged KV (kv_pages), prefix caching, chunked prefill, extended
sampling, guided JSON (guided), speculative decoding, multi-LoRA (lora)
and .npz checkpoints; tensor- and pipeline-parallel serving;
AsyncLLMEngine, a background thread stepping the engine for concurrent
callers; OpenAI-compatible Serve deployments (serving: LLMServer,
the disaggregated PrefillServer/DecodeServer/LLMRouter, and the app
builders); and batch inference over Data (batch: LLMPredictor,
build_llm_processor)."""

from ray_tpu_torch.llm.batch import LLMPredictor, build_llm_processor
from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import AsyncLLMEngine, LLMEngine, RequestOutput
from ray_tpu_torch.llm.serving import (DecodeServer, LLMRouter, LLMServer,
                                       PrefillServer, build_disaggregated_app,
                                       build_openai_app)

__all__ = [
    "LLMConfig",
    "SamplingParams",
    "LLMEngine",
    "AsyncLLMEngine",
    "RequestOutput",
    "LLMServer",
    "PrefillServer",
    "DecodeServer",
    "LLMRouter",
    "build_openai_app",
    "build_disaggregated_app",
    "LLMPredictor",
    "build_llm_processor",
]
