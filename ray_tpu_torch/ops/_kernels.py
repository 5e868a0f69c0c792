"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``ray_tpu_torch/csrc`` is compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``. Libraries land in ``build/ray_tpu_torch/`` at the
repository root, named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused. Nothing here runs at
import: the CPU tests import this module on machines with no CUDA.

A launch wrapper checks device, dtype, shape and layout and raises on
anything its kernel does not take; it allocates the outputs, launches on
PyTorch's current stream, raises if the C function reports a CUDA error,
and counts its launches in a plain int attribute (``flash_fwd.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
SOURCES = ("flash_fwd.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((_CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns {source: library path}."""
    with _BUILD_LOCK:
        libs = {src: _lib_path(src) for src in SOURCES}
        todo = {src: p for src, p in libs.items() if not p.exists()}
        if not todo:
            return libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for src, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[src])  # atomic: readers never see half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return libs


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()["flash_fwd.cu"]))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ray_tpu_torch_flash_fwd.argtypes = (
        [p] * 5 + [i64] * 12 + [i32] * 7 + [ctypes.c_float, p])
    lib.ray_tpu_torch_flash_fwd.restype = i32
    lib.ray_tpu_torch_cuda_error_string.argtypes = [i32]
    lib.ray_tpu_torch_cuda_error_string.restype = ctypes.c_char_p
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128)


def flash_fwd(q, k, v, *, causal: bool, return_lse: bool):
    """Flash-attention forward on the card (csrc/flash_fwd.cu).

    q [B, Tq, H, D], k/v [B, Tk, H, D] CUDA tensors of one dtype (fp32,
    fp16 or bf16), D in {64, 128}, any strides with a contiguous last
    axis. Returns (O [B, Tq, H, D] in q's dtype, LSE [B*H, Tq, 1] f32 or
    None).
    """
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd launches a CUDA kernel: q, k, v must be CUDA tensors")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd takes one dtype of fp32/fp16/bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd supports head_dim {HEAD_DIMS}, got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_fwd needs a contiguous head_dim axis")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if tk == 0:
        raise ValueError("flash_fwd needs at least one key")
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, tq, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0:
        return o, lse
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ray_tpu_torch_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            b, h, tq, tk, d, _DTYPE_CODES[q.dtype], int(causal),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.ray_tpu_torch_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cudaError {rc})")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0
