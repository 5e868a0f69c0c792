"""The port's kernel bindings, on the CPU: every C entry point of
ray_tpu_torch/csrc against the ctypes signature the wrappers declare, and
the rule that decides which inputs the TMA kernels read in place."""

import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from ray_tpu_torch import kernel_report
from ray_tpu_torch.ops import _kernels

_CSRC = Path(_kernels.__file__).resolve().parent.parent / "csrc"
_EXTERN_C = re.compile(r'extern\s+"C"\s+[^;{()]*?\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _c_functions(source: str) -> dict[str, int]:
    """{name: number of parameters} of every extern "C" function defined
    in ``source``."""
    text = re.sub(r"//[^\n]*", "", (_CSRC / source).read_text())
    return {name: len([p for p in params.split(",") if p.strip()])
            for name, params in _EXTERN_C.findall(text)}


def test_every_source_is_built():
    assert sorted(_kernels.SOURCES) == sorted(p.name for p in _CSRC.glob("*.cu"))


@pytest.mark.parametrize("source", sorted(p.name for p in _CSRC.glob("*.cu")))
def test_ctypes_signatures_match_the_c_entry_points(source):
    """A ctypes signature that drifts from its C function would pass
    wrong arguments on the card, where nothing checks them."""
    functions = _c_functions(source)
    assert functions, f"no extern \"C\" function found in {source}"
    declared = _kernels._ENTRY_POINTS[source]
    assert set(declared) == set(functions)
    for name, (restype, argtypes) in declared.items():
        assert len(argtypes) == functions[name], name
        assert restype is (ctypes.c_char_p if name.endswith("error_string") else ctypes.c_int)


def _fused_qkv(d, dtype):
    qkv = torch.zeros((2, 100, 12, 3 * d), dtype=dtype)
    return qkv.split(d, dim=-1)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_tma_reads_the_models_fused_qkv_views_in_place(d, dtype):
    """q, k, v as the model makes them: views of one [B, T, H, 3D]
    projection at offsets 0, D, 2D with strides 3D, H*3D, T*H*3D."""
    for t in _fused_qkv(d, dtype):
        assert _kernels.tma_aligned(t)


@pytest.mark.parametrize("case", ["offset", "head_stride", "position_stride", "batch_stride"])
def test_tma_refuses_what_is_not_16_byte_aligned(case):
    x = torch.zeros((2, 8, 4, 64 + 8), dtype=torch.bfloat16)
    if case == "offset":
        t = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 8, 4, 64)
    elif case == "head_stride":
        t = torch.zeros((2, 8, 4, 65), dtype=torch.bfloat16)[..., :64]
    elif case == "position_stride":
        t = torch.zeros((2, 8, 4 * 64 + 1), dtype=torch.bfloat16)[..., :256].view(2, 8, 4, 64)
    else:
        t = torch.zeros(2 * (8 * 4 * 64 + 1), dtype=torch.bfloat16).as_strided(
            (2, 8, 4, 64), (8 * 4 * 64 + 1, 256, 64, 1))
    assert _kernels.tma_aligned(x[..., :64])
    assert not _kernels.tma_aligned(t)


def test_unaligned_inputs_are_copied_and_counted():
    counter = types.SimpleNamespace(copies=0)
    for n, dtype in enumerate((torch.bfloat16, torch.float32), start=1):
        good = _fused_qkv(64, dtype)[1]
        bad = torch.zeros((2, 8, 4, 65), dtype=dtype)[..., :64]
        out_good, out_bad = _kernels._tma_inputs(counter, good, bad)
        assert out_good is good
        assert counter.copies == n
        assert _kernels.tma_aligned(out_bad) and torch.equal(out_bad, bad)


@pytest.mark.parametrize("pass_name", ["dq", "dkv"])
@pytest.mark.parametrize("dtype,source,name", [
    (torch.float32, "flash_bwd.cu", "ray_tpu_torch_flash_bwd_{}_fp32"),
    (torch.float16, "flash_bwd_{}.cu", "ray_tpu_torch_flash_bwd_{}"),
    (torch.bfloat16, "flash_bwd_{}.cu", "ray_tpu_torch_flash_bwd_{}"),
])
def test_backward_passes_route_each_dtype_to_its_kernel(pass_name, dtype, source, name):
    """fp32 to the 3xTF32 kernels of flash_bwd.cu, bf16/fp16 to the wgmma
    kernel of the pass's own source, which also takes the dtype code."""
    got_source, got_name, dtype_code = _kernels._backward_route(pass_name, dtype)
    assert (got_source, got_name) == (source.format(pass_name), name.format(pass_name))
    assert dtype_code == (() if dtype == torch.float32 else (_kernels._DTYPE_CODES[dtype],))
    assert got_source in _kernels.SOURCES
    _, argtypes = _kernels._ENTRY_POINTS[got_source][got_name]
    # The pointers and strides of a pass, then its ints: batch, heads, Tq,
    # Tk, head_dim, (dtype,) causal.
    assert argtypes.count(ctypes.c_int) == 6 + len(dtype_code)


def test_dkv_wrapper_counts_the_inputs_it_copies():
    """flash_bwd_dkv reads q, k, v and dO by TMA: an input TMA cannot read
    as it lies is copied, and the copy counted on the wrapper."""
    wrapper = _kernels.flash_bwd_dkv
    before = wrapper.copies
    q, k, v = _fused_qkv(64, torch.bfloat16)
    bad = torch.zeros((2, 100, 12, 65), dtype=torch.bfloat16)[..., :64]
    try:
        out = _kernels._tma_inputs(wrapper, q, k, v, bad)
        assert wrapper.copies == before + 1
        assert all(a is b for a, b in zip(out[:3], (q, k, v)))
        assert _kernels.tma_aligned(out[3]) and torch.equal(out[3], bad)
    finally:
        wrapper.copies = before


def test_fwd_wrapper_reads_fp32_by_tma(monkeypatch):
    """flash_fwd hands fp32 q, k, v to its kernel as the TMA kernels take
    them: the model's fused-qkv views in place, an input TMA cannot read
    as it lies copied, and the copy counted. The C call is recorded, not
    made (the CUDA checks are passed over: no card here)."""
    wrapper = _kernels.flash_fwd
    calls = []
    monkeypatch.setattr(_kernels, "_check_attention_inputs",
                        lambda name, q, k, v: (*q.shape, k.shape[1]))
    monkeypatch.setattr(_kernels, "_launch", lambda source, name, t, *args: calls.append(args))
    for counter in ("launches", "launches_fp32", "copies"):
        monkeypatch.setattr(wrapper, counter, 0)
    q, k, v = _fused_qkv(64, torch.float32)
    wrapper(q, k, v, causal=True, return_lse=True)
    assert calls[0][:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert wrapper.copies == 0
    bad = torch.zeros((2, 100, 12, 65), dtype=torch.float32)[..., :64]
    wrapper(q, k, bad, causal=True, return_lse=True)
    assert calls[1][:2] == (q.data_ptr(), k.data_ptr()) and calls[1][2] != bad.data_ptr()
    assert wrapper.copies == 1
    assert wrapper.launches == wrapper.launches_fp32 == 2


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_S2_NS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv_kernelI13__nv_bfloat16Li64EEEv14CUtensorMap_stS2_S2_S2_NS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 157 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function 'plain_kernel' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers
"""


def test_kernel_report_reads_registers_and_spills_from_ptxas():
    """The ptxas log reader behind PERF.md's register and spill counts."""
    rows = kernel_report.ptxas_rows(_PTXAS_LOG)
    assert rows == [
        {"kernel": "flash_bwd_dkv_kernelI13__nv_bfloat16Li64EE", "notes": [],
         "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 157},
        {"kernel": "plain_kernel",
         "notes": ["ptxas info    : (C7515) Potential Performance Loss: "
                   "wgmma.mma_async instructions are serialized"],
         "stack": 8, "spill_stores": 4, "spill_loads": 4, "registers": 255},
    ]
