"""AcceleratorManager plugin ABC + vendor managers.

Counterpart of the reference's accelerator plugin layer
(reference: python/ray/_private/accelerators/accelerator.py:5
AcceleratorManager ABC; nvidia_gpu.py, amd_gpu.py, intel_gpu.py, hpu.py,
npu.py, neuron.py, tpu.py registered in __init__.py). The CUDA manager
(ray_tpu_torch.accelerators.cuda) is the first-class path of the port;
it holds the ``"GPU"`` name. The others make heterogeneous clusters
schedulable, and any future vendor registers via
``register_accelerator_manager``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional


class AcceleratorManager:
    """Static-method contract (reference: accelerator.py:5). All methods
    are classmethod/static so managers never need instantiation."""

    @staticmethod
    def get_resource_name() -> str:
        raise NotImplementedError

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        raise NotImplementedError

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        raise NotImplementedError

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        return None

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[list[str]]:
        return None

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        pass

    @staticmethod
    def get_current_node_additional_resources() -> dict:
        return {}


class NvidiaGPUAcceleratorManager(AcceleratorManager):
    """Reference: _private/accelerators/nvidia_gpu.py — resource "GPU",
    CUDA_VISIBLE_DEVICES pinning, /proc|nvml discovery."""

    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "CUDA_VISIBLE_DEVICES"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            return 0 if visible in ("", "NoDevFiles") else len(visible.split(","))
        # /proc/driver/nvidia/gpus has one subdir per device (the
        # reference uses pynvml; device files avoid the dependency).
        try:
            return len(os.listdir("/proc/driver/nvidia/gpus"))
        except OSError:
            return 0

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[list[str]]:
        v = os.environ.get("CUDA_VISIBLE_DEVICES")
        if v is None:
            return None
        return [] if v in ("", "NoDevFiles") else v.split(",")

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in ids)


class NeuronAcceleratorManager(AcceleratorManager):
    """Reference: _private/accelerators/neuron.py — AWS Inferentia/
    Trainium, resource "neuron_cores", NEURON_RT_VISIBLE_CORES."""

    @staticmethod
    def get_resource_name() -> str:
        return "neuron_cores"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "NEURON_RT_VISIBLE_CORES"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        visible = os.environ.get("NEURON_RT_VISIBLE_CORES")
        if visible:
            return len(visible.split(","))
        return len(glob.glob("/dev/neuron*"))

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        os.environ["NEURON_RT_VISIBLE_CORES"] = ",".join(str(i) for i in ids)


class AMDGPUAcceleratorManager(AcceleratorManager):
    """Reference: _private/accelerators/amd_gpu.py — resource "GPU"
    (shared with NVIDIA; a node has one vendor), HIP_VISIBLE_DEVICES
    pinning (ROCR_VISIBLE_DEVICES honored for discovery), /dev/kfd +
    /sys/class/kfd topology discovery."""

    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "HIP_VISIBLE_DEVICES"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        for var in ("HIP_VISIBLE_DEVICES", "ROCR_VISIBLE_DEVICES"):
            v = os.environ.get(var)
            if v is not None:
                return 0 if v == "" else len(v.split(","))
        if not os.path.exists("/dev/kfd"):
            return 0
        return len(glob.glob("/sys/class/kfd/kfd/topology/nodes/*/gpu_id"))

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[list[str]]:
        v = os.environ.get("HIP_VISIBLE_DEVICES")
        if v is None:
            return None
        return [] if v == "" else v.split(",")

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        os.environ["HIP_VISIBLE_DEVICES"] = ",".join(str(i) for i in ids)


class IntelGPUAcceleratorManager(AcceleratorManager):
    """Reference: _private/accelerators/intel_gpu.py — resource "GPU",
    ONEAPI_DEVICE_SELECTOR pinning, /dev/dri render-node discovery."""

    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "ONEAPI_DEVICE_SELECTOR"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        sel = os.environ.get("ONEAPI_DEVICE_SELECTOR")
        if sel is not None:
            # "level_zero:0,1" style — count the device list.
            ids = sel.split(":", 1)[-1]
            return 0 if not ids else len(ids.split(","))
        return len(glob.glob("/dev/dri/renderD*")) if os.path.isdir(
            "/dev/dri") else 0

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        os.environ["ONEAPI_DEVICE_SELECTOR"] = "level_zero:" + ",".join(
            str(i) for i in ids)


class HPUAcceleratorManager(AcceleratorManager):
    """Reference: _private/accelerators/hpu.py — Habana Gaudi, resource
    "HPU", HABANA_VISIBLE_MODULES pinning, /dev/accel discovery."""

    @staticmethod
    def get_resource_name() -> str:
        return "HPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "HABANA_VISIBLE_MODULES"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        v = os.environ.get("HABANA_VISIBLE_MODULES")
        if v is not None:
            return 0 if v == "" else len(v.split(","))
        return len(glob.glob("/dev/accel/accel[0-9]*"))

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        os.environ["HABANA_VISIBLE_MODULES"] = ",".join(str(i) for i in ids)


class NPUAcceleratorManager(AcceleratorManager):
    """Reference: _private/accelerators/npu.py — Ascend, resource "NPU",
    ASCEND_RT_VISIBLE_DEVICES pinning, /dev/davinci? discovery."""

    @staticmethod
    def get_resource_name() -> str:
        return "NPU"

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return "ASCEND_RT_VISIBLE_DEVICES"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        v = os.environ.get("ASCEND_RT_VISIBLE_DEVICES")
        if v is not None:
            return 0 if v == "" else len(v.split(","))
        return len(glob.glob("/dev/davinci[0-9]*"))

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: list[str]) -> None:
        os.environ["ASCEND_RT_VISIBLE_DEVICES"] = ",".join(
            str(i) for i in ids)


_MANAGERS: dict[str, type[AcceleratorManager]] = {}


def register_accelerator_manager(mgr: type[AcceleratorManager]) -> None:
    """Plugin hook (reference: accelerators/__init__.py registry dict)."""
    _MANAGERS[mgr.get_resource_name()] = mgr


def get_accelerator_manager(resource_name: str) -> Optional[type[AcceleratorManager]]:
    return _MANAGERS.get(resource_name)


def get_all_accelerator_managers() -> list[type[AcceleratorManager]]:
    return list(_MANAGERS.values())


def detect_node_accelerators() -> dict[str, float]:
    """Resources contributed by every registered manager on this node
    (reference: resource_spec.py resolving managers at node start).

    Several vendors share the "GPU" resource name (NVIDIA/AMD/Intel — a
    node has one vendor); the registry holds the default (NVIDIA) and
    the others probe here as fallbacks, first nonzero count wins."""
    out: dict[str, float] = {}
    for mgr in _MANAGERS.values():
        n = mgr.get_current_node_num_accelerators()
        if n > 0:
            out[mgr.get_resource_name()] = float(n)
            out.update(mgr.get_current_node_additional_resources())
    if "GPU" not in out:
        for mgr in (AMDGPUAcceleratorManager, IntelGPUAcceleratorManager):
            n = mgr.get_current_node_num_accelerators()
            if n > 0:
                out["GPU"] = float(n)
                break
    return out


def merge_detected_resources(res: dict) -> dict:
    """setdefault every detected accelerator into ``res`` (user-supplied
    counts win); never raises — detection failures leave res unchanged.
    Shared by the head and the node agent's resource bootstrap."""
    try:
        for name, n in detect_node_accelerators().items():
            res.setdefault(name, n)
    except Exception:
        pass
    return res


def _register_builtins() -> None:
    from ray_tpu_torch.accelerators.cuda import CUDAAcceleratorManager

    for mgr in (CUDAAcceleratorManager, NeuronAcceleratorManager,
                HPUAcceleratorManager, NPUAcceleratorManager):
        register_accelerator_manager(mgr)


_register_builtins()
