"""CUDA accelerator manager: device discovery and visibility pinning.

The port's counterpart of ray_tpu/accelerators/tpu.py. The chip resource
is ``"GPU"`` and visibility is ``CUDA_VISIBLE_DEVICES`` (reference:
python/ray/_private/accelerators/nvidia_gpu.py — resource name "GPU",
``CUDA_VISIBLE_DEVICES`` pinning, NVML discovery). Discovery asks NVML
(the driver's management library, as nvidia-smi does), never CUDA
itself: the head and every worker detect or pin devices without
importing torch or creating a CUDA context, and a process that called
into CUDA has fixed its visible set for good (CUDA reads the variable
once, when it initialises). Device files are the fallback where NVML
is missing; they can over-count (a container may hold the node of a
card it cannot use).

The TPU manager's pod helpers (``pod_head_resource``,
``get_current_pod_name``, ``get_current_pod_worker_count``,
``tpu_pod_mesh``) have no CUDA meaning on one host; ROADMAP item 6g
names their counterparts.
"""

from __future__ import annotations

import ctypes
import glob
import os
import re

from ray_tpu_torch.accelerators.accelerator import NvidiaGPUAcceleratorManager


class CUDAAcceleratorManager(NvidiaGPUAcceleratorManager):
    """NVIDIA GPUs through CUDA: ``"GPU"``, ``CUDA_VISIBLE_DEVICES``."""

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        """Devices this process may use. Order: an explicit
        CUDA_VISIBLE_DEVICES (``""`` hides every device); NVML's device
        count; /proc/driver/nvidia/gpus (one entry per device); the
        /dev/nvidia<N> device files."""
        if os.environ.get("CUDA_VISIBLE_DEVICES") is not None:
            return NvidiaGPUAcceleratorManager.get_current_node_num_accelerators()
        n = _nvml_device_count()
        if n is not None:
            return n
        n = NvidiaGPUAcceleratorManager.get_current_node_num_accelerators()
        if n:
            return n
        return len([p for p in glob.glob("/dev/nvidia*")
                    if re.fullmatch(r"nvidia\d+", os.path.basename(p))])

    @staticmethod
    def node_device_ids(n: int) -> list:
        """The ``n`` device ids a node's leases hand out: this process's
        own CUDA_VISIBLE_DEVICES entries when it names at least ``n``
        (a node started inside a pinned process leases only what it
        sees), else 0..n-1."""
        visible = NvidiaGPUAcceleratorManager.\
            get_current_process_visible_accelerator_ids()
        if visible and len(visible) >= n:
            return [int(v) if v.isdigit() else v for v in visible[:n]]
        return list(range(n))


def _nvml_device_count() -> "int | None":
    """NVML's count of the devices this machine gives the process, or
    None where the library is missing or fails to initialise (no
    driver). Opens no CUDA context."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    count = ctypes.c_uint(0)
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return None
        return int(count.value)
    finally:
        nvml.nvmlShutdown()
