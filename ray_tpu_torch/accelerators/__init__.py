"""Accelerator managers (reference: python/ray/_private/accelerators/)."""

from ray_tpu_torch.accelerators.accelerator import (
    AcceleratorManager,
    AMDGPUAcceleratorManager,
    HPUAcceleratorManager,
    IntelGPUAcceleratorManager,
    NPUAcceleratorManager,
    NeuronAcceleratorManager,
    NvidiaGPUAcceleratorManager,
    detect_node_accelerators,
    get_accelerator_manager,
    get_all_accelerator_managers,
    register_accelerator_manager,
)
from ray_tpu_torch.accelerators.cuda import CUDAAcceleratorManager

__all__ = [
    "AcceleratorManager",
    "AMDGPUAcceleratorManager",
    "CUDAAcceleratorManager",
    "HPUAcceleratorManager",
    "IntelGPUAcceleratorManager",
    "NPUAcceleratorManager",
    "NeuronAcceleratorManager",
    "NvidiaGPUAcceleratorManager",
    "detect_node_accelerators",
    "get_accelerator_manager",
    "get_all_accelerator_managers",
    "register_accelerator_manager",
]
