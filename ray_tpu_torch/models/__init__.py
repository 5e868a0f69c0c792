"""Model library (port of ray_tpu.models): the decoder-only transformer
family's inference path. See ray_tpu_torch.models.transformer."""

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    forward,
    generate,
    gpt2_medium,
    gpt2_small,
    gpt2_xl,
    init_kv_cache,
    init_params,
    llama2_7b,
    llama3_8b,
    mistral_7b,
    mixtral_8x7b,
    moe_small,
    qwen2_7b,
    tiny,
    tiny_moe,
)

__all__ = [
    "TransformerConfig",
    "moe_small",
    "tiny_moe",
    "decode_step",
    "forward",
    "generate",
    "gpt2_small",
    "gpt2_medium",
    "gpt2_xl",
    "init_kv_cache",
    "init_params",
    "llama2_7b",
    "llama3_8b",
    "mistral_7b",
    "mixtral_8x7b",
    "qwen2_7b",
    "tiny",
]
