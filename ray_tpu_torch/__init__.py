"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: the ops (attention with
hand-written Hopper flash-attention kernels, forward and backward; MoE
routing; the optimizers), the transformer model family on one device
(dense and MoE; inference and training), and the dense single-device
LLM engine. ``interop.params_from_jax`` carries a JAX parameter tree
across.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

from ray_tpu_torch import interop, llm, models, ops

__version__ = "0.1.0"

__all__ = ["interop", "llm", "models", "ops", "__version__"]
