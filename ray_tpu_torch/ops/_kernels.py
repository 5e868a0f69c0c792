"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``ray_tpu_torch/csrc`` is compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``. Libraries land in ``build/ray_tpu_torch/`` at the
repository root, named by a hash of the source, the shared headers and
the flags, so a changed source rebuilds and an unchanged one is reused.
Nothing here runs at import: the CPU tests import this module on machines
with no CUDA.

A launch wrapper checks device, dtype, shape and layout and raises on
anything its kernel does not take; it allocates the outputs, launches on
PyTorch's current stream, raises if the C function reports a CUDA error
(there is no fallback to another kernel or to the plain version), and
counts its launches in a plain int attribute (``flash_fwd.launches``,
``flash_bwd_dq.launches``, ``flash_bwd_dkv.launches``). bf16/fp16 run on
wgmma kernels (``flash_fwd.cu``, ``flash_bwd_dq.cu``,
``flash_bwd_dkv.cu``); fp32 runs on kernels of its own, every product on
the tensor cores in 3xTF32 (the forward in ``flash_fwd.cu``, both backward
passes in ``flash_bwd.cu``, sharing ``tf32x3.cuh``), whose launches each
wrapper also counts apart (``launches_fp32``). Every kernel reads q, k, v
(and dO) by TMA, which needs a 16-byte aligned base and strides that are
multiples of 16 bytes (``tma_aligned``); an input that breaks the rule is
copied first, and the copies are counted too (``flash_fwd.copies``,
``flash_bwd_dq.copies``, ``flash_bwd_dkv.copies``).
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

from ray_tpu_torch._private import native_build

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
# build/ray_tpu_torch/ beside the checkout's package, or the per-user
# cache where an install cannot write there.
BUILD_DIR = Path(native_build.build_dir())
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkv.cu")
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
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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


_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ERROR_STRING = {"ray_tpu_torch_cuda_error_string": (ctypes.c_char_p, [_I32])}
# Each source's C entry points as (restype, argtypes): pointers and the
# stream as c_void_p, strides as long long, sizes and flags as int.
_ENTRY_POINTS = {
    "flash_fwd.cu": {
        "ray_tpu_torch_flash_fwd": (_I32, [_P] * 5 + [_I64] * 12 + [_I32] * 7 + [_F32, _P]),
        **_ERROR_STRING,
    },
    "flash_bwd.cu": {
        "ray_tpu_torch_flash_bwd_dq_fp32":
            (_I32, [_P] * 7 + [_I64] * 15 + [_I32] * 6 + [_F32, _P]),
        "ray_tpu_torch_flash_bwd_dkv_fp32":
            (_I32, [_P] * 8 + [_I64] * 18 + [_I32] * 6 + [_F32, _P]),
        **_ERROR_STRING,
    },
    "flash_bwd_dq.cu": {
        "ray_tpu_torch_flash_bwd_dq": (_I32, [_P] * 7 + [_I64] * 15 + [_I32] * 7 + [_F32, _P]),
        **_ERROR_STRING,
    },
    "flash_bwd_dkv.cu": {
        "ray_tpu_torch_flash_bwd_dkv":
            (_I32, [_P] * 8 + [_I64] * 18 + [_I32] * 7 + [_F32, _P]),
        **_ERROR_STRING,
    },
}


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[source]))
    for name, (restype, argtypes) in _ENTRY_POINTS[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _launch(source: str, name: str, tensor, *args) -> None:
    """Call C entry point ``name`` of ``source`` on ``tensor``'s device
    and current stream (appended as the last argument); raise on a CUDA
    error."""
    lib = _lib(source)
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.ray_tpu_torch_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
HEAD_DIMS = (64, 128)


def _check_attention_inputs(name: str, q, k, v, *q_like):
    """Checks shared by the attention kernels: q (and every ``q_like``,
    e.g. dO) [B, Tq, H, D], k/v [B, Tk, H, D] CUDA tensors of one dtype
    on one device, D in HEAD_DIMS, a contiguous head_dim axis, Tk > 0.
    Returns (B, Tq, H, D, Tk)."""
    tensors = (q, k, v, *q_like)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} launches a CUDA kernel: its inputs must be CUDA tensors")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name} takes one dtype of fp32/fp16/bf16, got "
                         f"{[t.dtype for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if any(t.shape != q.shape for t in q_like):
        raise ValueError(f"{name}: {[tuple(t.shape) for t in q_like]} must match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} supports head_dim {HEAD_DIMS}, got {d}")
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError(f"{name} needs a contiguous head_dim axis")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: inputs must be on one device")
    if tk == 0:
        raise ValueError(f"{name} needs at least one key")
    return b, tq, h, d, tk


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether a TMA copy can read the [B, T, H, D] tensor ``t`` as it
    lies: its base address and its batch, position and head strides are
    multiples of 16 bytes (head_dim is contiguous)."""
    esize = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * esize % 16 == 0 for s in t.stride()[:3])


def _tma_inputs(wrapper, *tensors):
    """``tensors`` as the TMA kernels read them: each that
    ``tma_aligned`` refuses is replaced by a contiguous copy, counted in
    ``wrapper.copies``."""
    out = []
    for t in tensors:
        if not tma_aligned(t):
            t = t.clone(memory_format=torch.contiguous_format)
            wrapper.copies += 1
        out.append(t)
    return out


def flash_fwd(q, k, v, *, causal: bool, return_lse: bool):
    """Flash-attention forward on the card (csrc/flash_fwd.cu).

    q [B, Tq, H, D], k/v [B, Tk, H, D] CUDA tensors of one dtype (fp32,
    fp16 or bf16), D in {64, 128}, any strides with a contiguous last
    axis. Returns (O [B, Tq, H, D] in q's dtype, LSE [B*H, Tq, 1] f32 or
    None).
    """
    b, tq, h, d, tk = _check_attention_inputs("flash_fwd", q, k, v)
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * h, tq, 1), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() == 0:
        return o, lse
    q, k, v = _tma_inputs(flash_fwd, q, k, v)
    _launch("flash_fwd.cu", "ray_tpu_torch_flash_fwd", q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            b, h, tq, tk, d, _DTYPE_CODES[q.dtype], int(causal),
            1.0 / math.sqrt(d))
    flash_fwd.launches += 1
    flash_fwd.launches_fp32 += q.dtype == torch.float32
    return o, lse


flash_fwd.launches = 0
flash_fwd.launches_fp32 = 0
flash_fwd.copies = 0


def _check_row_stats(name: str, b: int, h: int, tq: int, **stats):
    """LSE and delta: contiguous f32 CUDA tensors of B*H*Tq values, laid
    out [B*H, Tq] (a trailing axis of 1 is allowed)."""
    for key, t in stats.items():
        if (not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous()
                or t.numel() != b * h * tq or t.shape[:2] != (b * h, tq)):
            raise ValueError(f"{name}: {key} must be a contiguous f32 CUDA tensor "
                             f"[B*H, Tq(, 1)] = [{b * h}, {tq}], got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _backward_route(pass_name: str, dtype) -> tuple[str, str, tuple]:
    """Where a backward pass (``"dq"`` or ``"dkv"``) runs for ``dtype``:
    (source, C entry point, the dtype code it takes, if any). fp32 goes to
    the 3xTF32 tensor-core kernels of flash_bwd.cu, bf16/fp16 to the wgmma
    kernel of flash_bwd_<pass>.cu. Both read q, k, v and dO by TMA."""
    if dtype == torch.float32:
        return "flash_bwd.cu", f"ray_tpu_torch_flash_bwd_{pass_name}_fp32", ()
    return (f"flash_bwd_{pass_name}.cu", f"ray_tpu_torch_flash_bwd_{pass_name}",
            (_DTYPE_CODES[dtype],))


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool):
    """Flash-attention backward, dQ pass, on the card (csrc/flash_bwd_dq.cu
    for bf16/fp16, csrc/flash_bwd.cu for fp32).

    q/dO [B, Tq, H, D], k/v [B, Tk, H, D] as ``flash_fwd`` takes them;
    ``lse`` the forward's [B*H, Tq, 1] f32 and ``delta`` = rowsum(dO * O)
    [B*H, Tq(, 1)] f32, both contiguous. Returns dQ [B, Tq, H, D] in q's
    dtype.
    """
    b, tq, h, d, tk = _check_attention_inputs("flash_bwd_dq", q, k, v, do)
    _check_row_stats("flash_bwd_dq", b, h, tq, lse=lse, delta=delta)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    source, name, dtype_code = _backward_route("dq", q.dtype)
    q, k, v, do = _tma_inputs(flash_bwd_dq, q, k, v, do)
    _launch(source, name, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *dq.stride()[:3],
            b, h, tq, tk, d, *dtype_code, int(causal),
            1.0 / math.sqrt(d))
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_fp32 += q.dtype == torch.float32
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_fp32 = 0
flash_bwd_dq.copies = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """Flash-attention backward, dK/dV pass, on the card
    (csrc/flash_bwd_dkv.cu for bf16/fp16, csrc/flash_bwd.cu for fp32).
    Inputs as ``flash_bwd_dq``. Returns (dK, dV) [B, Tk, H, D] in k's and
    v's dtype; with no query (Tq = 0) both are zero and nothing
    launches."""
    b, tq, h, d, tk = _check_attention_inputs("flash_bwd_dkv", q, k, v, do)
    _check_row_stats("flash_bwd_dkv", b, h, tq, lse=lse, delta=delta)
    dk = torch.empty((b, tk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, h, d), dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    if tq == 0:
        return dk.zero_(), dv.zero_()
    source, name, dtype_code = _backward_route("dkv", q.dtype)
    q, k, v, do = _tma_inputs(flash_bwd_dkv, q, k, v, do)
    _launch(source, name, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3],
            b, h, tq, tk, d, *dtype_code, int(causal),
            1.0 / math.sqrt(d))
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.launches_fp32 += q.dtype == torch.float32
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_fp32 = 0
flash_bwd_dkv.copies = 0
