"""ray_tpu_torch.ops: attention (with the hand-written Hopper flash
kernels, forward and backward) and the norm/rope/mlp building blocks;
MoE routing and the MoE FFN live in ray_tpu_torch.ops.moe, the
optimizers (fused clip+AdamW and the optax-style transforms) in
ray_tpu_torch.ops.optim.

Port of ray_tpu.ops; ring attention arrives with the parallel slice.
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
]
