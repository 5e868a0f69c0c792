"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: the ops (attention with
hand-written Hopper flash-attention kernels, forward and backward; MoE
routing; the optimizers; ring attention), the transformer model family
(dense and MoE; inference and training, on one device or sharded over a
DeviceMesh: data, fsdp, tensor, expert), the parallel layer (meshes,
sharding rules, the SPMD pipeline, multi-slice meshes; over
torch.distributed and DTensor), the LLM engine (on one device, or
tensor- or pipeline-parallel over a process group), and the Train
backend (process-group setup, gradient and parameter sync, checkpoints).
``interop.params_from_jax`` carries a JAX parameter tree across.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""

from ray_tpu_torch import interop, llm, models, ops, parallel, train

__version__ = "0.1.0"

__all__ = ["interop", "llm", "models", "ops", "parallel", "train", "__version__"]
