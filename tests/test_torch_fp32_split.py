"""3xTF32 on the CPU: the fp32 kernels (ray_tpu_torch/csrc/flash_fwd.cu's
fp32 forward, flash_bwd.cu's backward passes, both built on tf32x3.cuh)
take every fp32 product on the tensor cores as hi.lo + lo.hi + hi.hi of the
TF32 halves of its operands. Here that split is emulated with numpy, the
products of the backward pass are taken that way, and the gradients are
held against the plain fp32 version at chip_smoke's unchanged fp32 limits,
which TF32 alone (hi.hi) must fail. A second emulation truncates each
tensor-core accumulation as the card's does and tells the kernels' chain
layout from one that missed the fp32 limit on an H100. The forward is
emulated tile by tile as the kernel runs it (online softmax per key tile,
at head_dim 128 the two halves of each key tile merged) and held to
chip_smoke's forward limits."""

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


def _mm_chained(a, b, chain, small_first, bits, acc=None):
    """a @ b (acc + a @ b with ``acc``) in 3xTF32 as the kernels' mma.sync
    chains take it: every ``chain`` 8-deep steps start from zero, each
    product an ``_mma``; with ``small_first`` the chain's hi.lo and lo.hi
    come before its hi.hi (the kernels' order, chain 2), else each step's
    three products in turn; each chain is added to the running sum in f32,
    to nearest."""
    (ah, al), (bh, bl) = split(a), split(b)
    depth = a.shape[-1]
    total = acc
    for k0 in range(0, depth, 8 * chain):
        steps = [slice(k, k + 8) for k in range(k0, min(depth, k0 + 8 * chain), 8)]
        if small_first:
            terms = ([t for s in steps for t in ((ah, bl, s), (al, bh, s))]
                     + [(ah, bh, s) for s in steps])
        else:
            terms = [t for s in steps for t in ((ah, bl, s), (al, bh, s), (ah, bh, s))]
        d = np.zeros(np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                     + (a.shape[-2], b.shape[-1]), np.float32)
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


def _forward(q, k, v, causal, mm_rows, mm_cols):
    """flash_fwd.cu's fp32 forward on the CPU, tile by tile, in its tiling:
    at head_dim 64 128-row query tiles over whole 64-key tiles; at 128
    64-row query tiles over 32-key tiles split into two parts. Each part
    keeps its own running max, sum and O (S = mm_rows(q, k^T); O =
    mm_cols(p, v, O * corr)) over key tiles up to the causal diagonal; the
    parts merge as the kernel merges them (part 0 first). q, k, v
    [B, T, H, D] f32; returns (O [B, Tq, H, D], LSE [B*H, Tq, 1])."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    rows_q, r, parts = (128, 64, 1) if d == 64 else (64, 32, 2)
    heads = lambda x: x.permute(0, 2, 1, 3).numpy()  # noqa: E731  [B, H, T, D]
    qf, kf, vf = heads(q), heads(k), heads(v)
    kf, vf = (np.pad(x, ((0, 0), (0, 0), (0, -tk % r), (0, 0))) for x in (kf, vf))
    scale, neg = np.float32(1.0 / math.sqrt(d)), np.float32(-1e30)
    out = np.zeros((b, h, tq, d), np.float32)
    lse = np.zeros((b, h, tq, 1), np.float32)
    for m0 in range(0, tq, rows_q):
        rows = np.arange(m0, min(m0 + rows_q, tq))
        qt = np.ascontiguousarray(
            np.broadcast_to(qf[:, :, None, rows], (b, h, parts, len(rows), d)))
        m = np.full((b, h, parts, len(rows), 1), neg, np.float32)
        l = np.zeros_like(m)
        o = np.zeros((b, h, parts, len(rows), d), np.float32)
        for n0 in range(0, min(tk, m0 + rows_q) if causal else tk, r):
            cols = n0 + np.arange(r).reshape(parts, 1, r // parts)  # [part, 1, key]
            keep = (cols < tk) & ((rows[:, None] >= cols) if causal else True)
            kt, vt = (x[:, :, n0:n0 + r].reshape(b, h, parts, r // parts, d) for x in (kf, vf))
            x = np.where(keep, mm_rows(qt, kt.swapaxes(-1, -2)) * scale, neg)
            m_new = np.maximum(m, x.max(-1, keepdims=True))
            corr = np.exp(m - m_new)
            p = np.where(keep, np.exp(x - m_new), np.float32(0))
            l = l * corr + p.sum(-1, keepdims=True)
            o = mm_cols(p, vt, o * corr)
            m = m_new
        mx = m.max(2)
        e = [np.exp(m[:, :, i] - mx) for i in range(parts)]
        den, acc = np.float32(0), np.float32(0)
        for i in range(parts):
            den, acc = den + l[:, :, i] * e[i], acc + o[:, :, i] * e[i]
        den = np.maximum(den, np.float32(1e-30))
        out[:, :, rows] = acc / den
        lse[:, :, rows] = mx + np.log(den)
    return (torch.from_numpy(out).permute(0, 2, 1, 3),
            torch.from_numpy(lse).reshape(b * h, tq, 1))


def _forward_errors(b, tq, tk, h, d, causal, mm_rows, mm_cols):
    """The largest |O| and |LSE| errors of ``_forward`` against
    flash_forward_plain (256-key blocks, as chip_smoke runs it) on
    standard normal q, k, v from a seed."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d), dtype=np.float32))
               for t in (tq, tk, tk))
    want_o, want_lse = flash_forward_plain(q, k, v, causal=causal, block_k=256)
    got_o, got_lse = _forward(q, k, v, causal, mm_rows, mm_cols)
    return ((got_o - want_o).abs().max().item(), (got_lse - want_lse).abs().max().item())


_FORWARD_SHAPES = [(1, 192, 192, 2, 64, True), (1, 100, 100, 2, 64, False),
                   (1, 64, 100, 1, 128, True)]


@pytest.mark.parametrize("bits", [24, 23])
@pytest.mark.parametrize("b,tq,tk,h,d,causal", _FORWARD_SHAPES)
def test_forward_in_3xtf32_chains_meets_the_fp32_limits(b, tq, tk, h, d, causal, bits):
    """The fp32 forward's products in the kernel's chain layout (2-step
    chains, small products first), every tensor-core accumulation
    truncated at ``bits`` kept bits: O and LSE within chip_smoke's
    unchanged fp32 limits of the plain version."""
    err_o, err_lse = _forward_errors(
        b, tq, tk, h, d, causal,
        lambda x, y: _mm_chained(x, y, 2, True, bits),
        lambda p, y, acc: _mm_chained(p, y, 2, True, bits, acc=acc))
    tol_o, tol_lse = chip_smoke._TOL[torch.float32]
    assert err_o <= tol_o and err_lse <= tol_lse, (err_o, err_lse)


@pytest.mark.parametrize("b,tq,tk,h,d,causal", _FORWARD_SHAPES)
def test_forward_in_tf32_alone_misses_the_fp32_limits(b, tq, tk, h, d, causal):
    """The same forward with each product as hi.hi alone (TF32) misses at
    least one of the fp32 limits: 3xTF32 is what meets them."""
    err_o, err_lse = _forward_errors(
        b, tq, tk, h, d, causal,
        lambda x, y: _mm(x, y, "tf32"),
        lambda p, y, acc: acc + _mm(p, y, "tf32"))
    tol_o, tol_lse = chip_smoke._TOL[torch.float32]
    assert err_o > tol_o or err_lse > tol_lse, (err_o, err_lse)
