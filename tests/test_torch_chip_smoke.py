"""chip_smoke.py's own yardsticks, on the CPU: the tolerance it holds the
backward kernels to, and the pair count its bounds are built on."""

import math

import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops.attention import flash_forward_plain


def _inputs(b, t, h, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g).to(dtype) for _ in range(4)]


def _dense_backward(q, k, v, o, lse, do, *, round_p: bool):
    """Causal attention backward in f32 from the forward's LSE, as
    (dQ, dK, dV) in the input type. ``round_p`` rounds p and dS to the
    input type before the dV and dK products, as the tensor-core kernels
    do; without it they stay f32, as in the plain version."""
    b, t, h, d = q.shape
    qf, kf, vf, gf, of = (x.float().transpose(1, 2) for x in (q, k, v, do, o))
    s = qf @ kf.transpose(-1, -2) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool).tril()
    p = torch.where(mask, torch.exp(s - lse.reshape(b, h, t, 1)), 0.0)
    delta = (gf * of).sum(-1, keepdim=True)
    ds = p * (gf @ vf.transpose(-1, -2) - delta) / math.sqrt(d)
    r = (lambda x: x.to(q.dtype).float()) if round_p else (lambda x: x)
    dq = ds.to(q.dtype).float() @ kf
    dk = r(ds).transpose(-1, -2) @ qf
    dv = r(p).transpose(-1, -2) @ gf
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_backward_tolerance_tells_rounding_from_faults(dtype):
    """The 16-bit p and dS of the tensor-core kernels pass _BWD_TOL; a 1%
    error in half of dV, and dQ missing one key tile's share in half of
    its rows, fail it."""
    b, t, h, d = 2, 256, 2, 64
    q, k, v, do = _inputs(b, t, h, d, dtype)
    o, lse = flash_forward_plain(q, k, v, causal=True, block_k=t)
    plain = _dense_backward(q, k, v, o, lse, do, round_p=False)
    kernel_like = _dense_backward(q, k, v, o, lse, do, round_p=True)
    for got, ref in zip(kernel_like, plain):
        assert chip_smoke._grad_within(chip_smoke._grad_error(got, ref, dtype), dtype)

    dv = plain[2].float().clone()
    dv[:, t // 2:] *= 0.99
    e = chip_smoke._grad_error(dv.to(dtype), plain[2], dtype)
    assert not chip_smoke._grad_within(e, dtype), e

    tile = chip_smoke._BWD_TILE
    k_cut = k.clone()
    k_cut[:, :tile] = 0  # key tile 0 dropped (q·k = 0 and k = 0 in dQ)
    v_cut = v.clone()
    v_cut[:, :tile] = 0
    dq_cut = _dense_backward(q, k_cut, v_cut, o, lse, do, round_p=True)[0]
    dq = plain[0].clone()
    dq[:, t // 2:] = dq_cut[:, t // 2:]
    e = chip_smoke._grad_error(dq, plain[0], dtype)
    assert not chip_smoke._grad_within(e, dtype), e


def test_backward_tolerance_takes_ragged_and_zero_tiles():
    """T = 100 (a short last tile) and all-zero key tiles (Tq < Tk under
    the causal mask): equal gradients pass, garbage in a zero tile fails."""
    ref = _inputs(1, 100, 2, 16, torch.bfloat16)[0]
    ref[:, 64:] = 0
    assert chip_smoke._grad_within(chip_smoke._grad_error(ref, ref, torch.bfloat16),
                                   torch.bfloat16)
    bad = ref.clone()
    bad[0, 90, 1, 3] = 1e-3
    e = chip_smoke._grad_error(bad, ref, torch.bfloat16)
    assert not chip_smoke._grad_within(e, torch.bfloat16), e


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, True), (64, 200, True),
                                          (200, 64, True), (100, 30, False)])
def test_attended_pairs_counts_the_mask(tq, tk, causal):
    """The bounds count the (query, key) pairs the mask keeps (global
    positions from 0, key j hidden from query i < j)."""
    i = torch.arange(tq)[:, None]
    j = torch.arange(tk)[None, :]
    kept = int((j <= i).sum()) if causal else tq * tk
    assert chip_smoke._attended_pairs(tq, tk, causal) == kept


def test_kernel_summary_names_sources_that_are_built():
    """Every source chip_smoke's kernels line names is one the port builds,
    and every kernel it names has a wrapper with a launch count."""
    from ray_tpu_torch.ops import _kernels

    assert set(chip_smoke._KERNEL_SOURCES.values()) <= set(_kernels.SOURCES)
    assert set(chip_smoke._REPLACES) == set(chip_smoke._KERNEL_SOURCES)
    for name in chip_smoke._KERNEL_SOURCES:
        assert isinstance(getattr(_kernels, name).launches, int), name


def test_copy_check_covers_every_counting_wrapper():
    """chip_smoke requires 0 copies on the main path from every wrapper
    that counts its copies."""
    from ray_tpu_torch.ops import _kernels

    counting = {name for name, obj in vars(_kernels).items()
                if callable(obj) and hasattr(obj, "copies")}
    assert counting == set(chip_smoke._COPYING)
