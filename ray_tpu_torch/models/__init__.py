"""Model library (port of ray_tpu.models): the decoder-only transformer
family's inference and training paths, on one device or sharded over a
mesh (``partition_specs``, ``mesh=``). See
ray_tpu_torch.models.transformer."""

from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    cross_entropy_loss,
    decode_step,
    forward,
    generate,
    gpt2_medium,
    gpt2_small,
    gpt2_xl,
    init_kv_cache,
    init_params,
    init_train_state,
    llama2_7b,
    llama3_8b,
    lm_loss,
    make_train_step,
    mistral_7b,
    mixtral_8x7b,
    moe_small,
    partition_specs,
    qwen2_7b,
    tiny,
    tiny_moe,
)

__all__ = [
    "TransformerConfig",
    "moe_small",
    "tiny_moe",
    "cross_entropy_loss",
    "decode_step",
    "forward",
    "generate",
    "gpt2_small",
    "gpt2_medium",
    "gpt2_xl",
    "init_kv_cache",
    "init_params",
    "init_train_state",
    "llama2_7b",
    "llama3_8b",
    "lm_loss",
    "make_train_step",
    "mistral_7b",
    "mixtral_8x7b",
    "partition_specs",
    "qwen2_7b",
    "tiny",
]
