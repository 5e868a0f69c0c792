"""ray_tpu_torch.llm: the single-device LLM engine (port of the engine
of ray_tpu.llm): dense or paged KV (kv_pages), prefix caching, chunked
prefill, extended sampling, guided JSON (guided), speculative decoding,
multi-LoRA (lora) and .npz checkpoints; tensor- and pipeline-parallel
serving; AsyncLLMEngine, a background thread stepping the engine for
concurrent callers. Serving deployments and batch stages come with later
slices."""

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import AsyncLLMEngine, LLMEngine, RequestOutput

__all__ = [
    "LLMConfig",
    "SamplingParams",
    "LLMEngine",
    "AsyncLLMEngine",
    "RequestOutput",
]
