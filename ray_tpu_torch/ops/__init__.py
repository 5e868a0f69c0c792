"""ray_tpu_torch.ops: attention (with the hand-written Hopper flash
kernels, forward and backward) and the norm/rope/mlp building blocks;
MoE routing and the MoE FFN live in ray_tpu_torch.ops.moe, the
optimizers (fused clip+AdamW and the optax-style transforms) in
ray_tpu_torch.ops.optim; ring attention (sequence parallelism over a
ring of ranks) in ray_tpu_torch.ops.ring_attention.

Port of ray_tpu.ops.
"""

from ray_tpu_torch.ops.attention import (
    attention,
    blockwise_attention,
    dot_product_attention,
    flash_attention,
)
from ray_tpu_torch.ops.layers import (
    apply_rope,
    gelu_mlp,
    layer_norm,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from ray_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded

__all__ = [
    "attention",
    "blockwise_attention",
    "dot_product_attention",
    "flash_attention",
    "apply_rope",
    "gelu_mlp",
    "layer_norm",
    "rms_norm",
    "rope_frequencies",
    "swiglu",
    "ring_attention",
    "ring_attention_sharded",
]
