"""3xTF32 on the CPU: the fp32 backward kernels (ray_tpu_torch/csrc/flash_bwd.cu)
take every fp32 product on the tensor cores as hi.lo + lo.hi + hi.hi of the
TF32 halves of its operands. Here that split is emulated with numpy, the
products of the backward pass are taken that way, and the gradients are
held against the plain fp32 version at chip_smoke's unchanged fp32 limits,
which TF32 alone (hi.hi) must fail. A second emulation truncates each
tensor-core accumulation as the card's does and tells the kernels' chain
layout from one that missed the fp32 limit on an H100."""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from ray_tpu_torch.ops.attention import flash_backward_plain, flash_forward_plain


def tf32(x):
    """cvt.rna.tf32.f32: fp32 rounded to TF32's 10 mantissa bits, to the
    nearest, ties away from zero (add half of the dropped 13 bits' unit to
    the magnitude, then clear them)."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """x = hi + lo (+ about 2^-22 |x|): hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(np.float32(x) - hi)


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2.0 ** -10, 1 + 2.0 ** -10),               # a TF32 value stays
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),               # tie: away (nearest-even gives 1)
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),         # tie, negative: away
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),             # just below the tie
    (1 + 2.0 ** -11 + 2.0 ** -23, 1 + 2.0 ** -10),  # just above
    (2 - 2.0 ** -11, 2.0),                          # the carry reaches the exponent
    ((1 + 2.0 ** -11) * 2.0 ** -20, (1 + 2.0 ** -10) * 2.0 ** -20),  # a tie, small
    (0.0, 0.0),
])
def test_tf32_rounds_to_nearest_ties_away(x, want):
    got = tf32(np.float32(x))
    assert got == np.float32(want), (x, float(got), want)
    assert got.view(np.uint32) & 0x1FFF == 0


def test_split_keeps_22_bits():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x *= np.float32(2.0) ** np.random.default_rng(1).integers(-20, 20, 4096).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    rest = np.abs(x.astype(np.float64) - hi - lo)
    assert (rest <= 2.0 ** -22 * np.abs(x)).all()


def _mm(a, b, mode):
    """a @ b for f32 arrays as the tensor cores take it: ``"3xtf32"`` sums
    hi.lo, lo.hi and hi.hi, each exact (f64) and rounded to f32, in f32 and
    the small terms first; ``"tf32"`` takes hi.hi alone. Each sum rounds
    once, to nearest: this models the split, not the truncating
    accumulation of the tensor cores (``_mm_chained`` does)."""
    (ah, al), (bh, bl) = split(a), split(b)
    f64 = lambda x: x.astype(np.float64)  # noqa: E731
    big = (f64(ah) @ f64(bh)).astype(np.float32)
    if mode == "tf32":
        return big
    small = ((f64(ah) @ f64(bl)).astype(np.float32)
             + (f64(al) @ f64(bh)).astype(np.float32))
    return small + big


def _round_to_zero(x):
    """f64 to f32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma(c, a, b, bits):
    """c + a @ b for one 8-deep step (a [..., M, 8], b [..., 8, N] TF32
    values, c [..., M, N] f32) as a tensor core that truncates adds it:
    the products exact, every term cut toward zero to ``bits`` significant
    bits at the exponent of the largest term, the sum cut to f32."""
    p = a.astype(np.float64)[..., :, :, None] * b.astype(np.float64)[..., None, :, :]
    c = c.astype(np.float64)
    _, e = np.frexp(np.maximum(np.abs(p).max(-2), np.abs(c)))
    unit = np.ldexp(1.0, e - bits)
    cut = (np.trunc(p / unit[..., None, :]) * unit[..., None, :]).sum(-2)
    return _round_to_zero(cut + np.trunc(c / unit) * unit)


def _mm_chained(a, b, chain, small_first, bits):
    """a @ b in 3xTF32 as flash_bwd.cu's mma.sync chains take it: every
    ``chain`` 8-deep steps start from zero, each product an ``_mma``; with
    ``small_first`` the chain's hi.lo and lo.hi come before its hi.hi (the
    kernels' order, chain 2), else each step's three products in turn; each
    chain is added to the running sum in f32, to nearest."""
    (ah, al), (bh, bl) = split(a), split(b)
    depth = a.shape[-1]
    total = None
    for k0 in range(0, depth, 8 * chain):
        steps = [slice(k, k + 8) for k in range(k0, min(depth, k0 + 8 * chain), 8)]
        if small_first:
            terms = ([t for s in steps for t in ((ah, bl, s), (al, bh, s))]
                     + [(ah, bh, s) for s in steps])
        else:
            terms = [t for s in steps for t in ((ah, bl, s), (al, bh, s), (ah, bh, s))]
        d = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
        for x, y, s in terms:
            d = _mma(d, x[..., s], y[..., s, :], bits)
        total = d if total is None else total + d
    return total


def _backward(q, k, v, o, lse, do, causal, mm):
    """flash_backward_plain's five products (S, dP, dQ, dK, dV) through
    ``mm(a, b)``; the elementwise steps in f32 as the plain version takes them.
    Tensors [B, T, H, D] f32; returns (dQ, dK, dV) in that layout."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    heads = lambda x: x.permute(0, 2, 1, 3).numpy()  # noqa: E731  [B, H, T, D]
    qf, kf, vf, gf = heads(q), heads(k), heads(v), heads(do)
    scale = np.float32(1.0 / math.sqrt(d))
    delta = (gf * heads(o)).sum(-1, keepdims=True, dtype=np.float32)
    s = mm(qf, kf.swapaxes(-1, -2)) * scale
    p = np.exp(s - lse.reshape(b, h, tq, 1).numpy())
    if causal:
        p = np.where(np.arange(tq)[:, None] >= np.arange(tk)[None, :], p, np.float32(0))
    dp = mm(gf, vf.swapaxes(-1, -2))
    ds = p * (dp - delta) * scale
    grads = (mm(ds, kf), mm(ds.swapaxes(-1, -2), qf), mm(p.swapaxes(-1, -2), gf))
    return [torch.from_numpy(np.ascontiguousarray(x)).permute(0, 2, 1, 3) for x in grads]


def _inputs(b, tq, tk, h, d, causal):
    """q, k, v, dO from a seed, the forward's O and LSE, and the exact
    plain gradients."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32))
                   for t in (tq, tk, tk, tq))
    o, lse = flash_forward_plain(q, k, v, causal=causal, block_k=tk)
    ref = flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                               block_q=min(256, tq), block_k=min(256, tk))
    return (q, k, v, o, lse, do), ref


@pytest.mark.parametrize("b,tq,tk,h,d,causal", [(2, 256, 256, 2, 64, True),
                                                 (1, 100, 100, 2, 128, False)])
def test_3xtf32_meets_the_fp32_limits_and_tf32_does_not(b, tq, tk, h, d, causal):
    args, ref = _inputs(b, tq, tk, h, d, causal)
    f32 = torch.float32
    for name, got, want in zip(("dq", "dk", "dv"),
                               _backward(*args, causal, lambda x, y: _mm(x, y, "3xtf32")),
                               ref):
        e = chip_smoke._grad_error(got, want, f32)
        assert chip_smoke._grad_within(e, f32), (name, e)
    tf32_alone = _backward(*args, causal, lambda x, y: _mm(x, y, "tf32"))
    for name, got, want in zip(("dq", "dk", "dv"), tf32_alone, ref):
        e = chip_smoke._grad_error(got, want, f32)
        assert not chip_smoke._grad_within(e, f32), (name, e)
        assert e["max_tile_err"] > 10 * chip_smoke._BWD_TOL[f32][2], (name, e)


@pytest.mark.parametrize("bits,in_turn_fails", [(24, False), (23, True)])
@pytest.mark.parametrize("b,tq,tk,h,d,causal", [(1, 128, 128, 2, 64, True),
                                                 (1, 100, 100, 2, 128, False)])
def test_truncating_accumulation_tells_the_chain_layouts_apart(b, tq, tk, h, d, causal,
                                                               bits, in_turn_fails):
    """Under truncating accumulation the kernels' layout (chains of 2
    steps, small products first) meets the fp32 limits and gives well under
    the tile error of one chain over each 64-deep stretch with each step's
    three products in turn. The card's accumulation width is not published:
    at 24 bits, an ulp of the f32 sum, the 64-deep chain still meets the
    limit; at 23 it misses it, at the 2-3e-6 tile error that such a chain
    gave on an H100."""
    args, ref = _inputs(b, tq, tk, h, d, causal)
    f32 = torch.float32
    tile = {}
    for layout, chain, small_first in (("built", 2, True), ("in_turn", 8, False)):
        got = _backward(*args, causal,
                        lambda x, y: _mm_chained(x, y, chain, small_first, bits))
        errs = [chip_smoke._grad_error(g, w, f32) for g, w in zip(got, ref)]
        tile[layout] = max(e["max_tile_err"] for e in errs)
        if layout == "built":
            assert all(chip_smoke._grad_within(e, f32) for e in errs), errs
        elif in_turn_fails:
            assert not all(chip_smoke._grad_within(e, f32) for e in errs), errs
    assert tile["in_turn"] > 1.5 * tile["built"], tile
