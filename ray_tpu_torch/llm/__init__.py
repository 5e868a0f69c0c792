"""ray_tpu_torch.llm: the dense single-device LLM engine (port of the
engine core of ray_tpu.llm). Serving deployments and batch stages come
with later slices."""

from ray_tpu_torch.llm.config import LLMConfig, SamplingParams
from ray_tpu_torch.llm.engine import LLMEngine, RequestOutput

__all__ = [
    "LLMConfig",
    "SamplingParams",
    "LLMEngine",
    "RequestOutput",
]
