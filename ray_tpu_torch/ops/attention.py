"""Attention ops (port of ray_tpu/ops/attention.py).

Shapes follow [batch, seq, heads, head_dim] throughout.

Three tiers:
  - ``dot_product_attention`` — O(T^2)-memory reference; ground truth in
    tests and the path for short sequences.
  - ``blockwise_attention`` — online softmax over key blocks in a Python
    loop: O(T) memory for the scores, differentiable.
  - ``flash_attention`` — the hand-written Hopper kernels on a CUDA
    tensor (forward csrc/flash_fwd.cu; backward a dQ pass,
    csrc/flash_bwd_dq.cu, and a dK/dV pass, csrc/flash_bwd_dkv.cu, for
    bf16/fp16, both passes in csrc/flash_bwd.cu for fp32, bound to it by
    a torch.autograd.Function),
    their plain PyTorch versions (``flash_forward_plain``,
    ``flash_backward_plain``) on a CPU tensor.
"""

from __future__ import annotations

import math

import torch

from ray_tpu_torch.ops import _kernels

_NEG_INF = -1e30


def _causal_mask(q_pos, k_pos):
    return q_pos[:, None] >= k_pos[None, :]


def dot_product_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """Reference attention. q: [B,Tq,H,D], k/v: [B,Tk,H,D].

    ``q_offset`` is the global position of q's first row relative to k
    (used by decode steps).

    Dtype policy: q is pre-scaled in the input dtype, the [B,H,Tq,Tk]
    scores and the softmax output stay in the INPUT dtype, and the
    softmax itself runs in fp32. fp32 inputs keep full fp32 math.
    """
    *_, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(_causal_mask(q_pos, k_pos)[None, None], s, _NEG_INF)
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)).to(q.dtype)


# ---------------------------------------------------------------------------
# Online-softmax building block of the blockwise path.
# ---------------------------------------------------------------------------


def online_softmax_block(q, k, v, m, l, o, *, q_pos, k_pos, causal,
                         k_valid=None):
    """One flash step: fold key block (k, v) into accumulators (m, l, o).

    q [B,Tq,H,D]; k/v [B,Tk,H,D]; m,l [B,H,Tq]; o [B,Tq,H,D] float32.
    ``k_valid`` [Tk] masks padded keys. Masked-out scores contribute
    exactly zero probability, so fully masked blocks are no-ops.
    """
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = _causal_mask(q_pos, k_pos)
    if k_valid is not None:
        valid = k_valid[None, :].expand(q.shape[1], k.shape[1])
        mask = valid if mask is None else (mask & valid)
    if mask is not None:
        mask = mask[None, None]
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _finalize(o, l):
    return o / l.clamp_min(1e-30).transpose(1, 2)[..., None]


def blockwise_attention(q, k, v, *, causal: bool = True, block_k: int = 512,
                        q_offset: int = 0):
    """Flash-style attention as a loop over key blocks."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    block_k = min(block_k, tk)
    n_blocks = (tk + block_k - 1) // block_k
    pad = n_blocks * block_k - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    for idx in range(n_blocks):
        sl = slice(idx * block_k, (idx + 1) * block_k)
        k_pos = idx * block_k + torch.arange(block_k, device=q.device)
        m, l, o = online_softmax_block(
            q, k[:, sl], v[:, sl], m, l, o, q_pos=q_pos, k_pos=k_pos,
            causal=causal, k_valid=(k_pos < tk) if pad else None,
        )
    return _finalize(o, l).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash-attention forward: the Hopper kernel and its plain version.
# ---------------------------------------------------------------------------


def flash_forward_plain(q, k, v, *, causal: bool, block_k: int):
    """Plain PyTorch version of the flash kernel: the same function with
    the same numerics as ray_tpu's _flash_fwd_kernel, in key blocks of
    ``block_k`` — f32 scores scaled after the product, -1e30 masking, an
    online softmax in f32, p rounded to v's dtype before p·v, O divided
    by max(l, 1e-30).

    Returns (O [B,Tq,H,D] in q's dtype, LSE [B*H, Tq, 1] f32).
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf = q.permute(0, 2, 1, 3).float()  # [B,H,Tq,D]
    kf = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3)
    q_pos = torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, tk, block_k):
        if causal and k0 > tq - 1:
            break  # every later key block lies wholly above the diagonal
        sl = slice(k0, k0 + block_k)
        s = (qf @ kf[:, :, sl].transpose(-1, -2)) * scale
        mask = None
        if causal:
            mask = _causal_mask(q_pos, torch.arange(k0, min(k0 + block_k, tk),
                                                    device=q.device))
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * corr + p.to(v.dtype).float() @ vh[:, :, sl].float()
    denom = l.clamp_min(1e-30)
    out = (acc / denom).to(q.dtype).permute(0, 2, 1, 3)
    lse = (m + torch.log(denom)).reshape(b * h, tq, 1)
    return out, lse


def _flash_forward(q, k, v, *, causal, block_q, block_k,
                   return_lse: bool = False):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor.

    ``block_q``/``block_k`` keep the reference's divisibility contract;
    the CUDA kernel tiles by its own sizes.
    """
    tq, tk = q.shape[1], k.shape[1]
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    if tq % block_q or tk % block_k:
        raise ValueError(f"seq lens ({tq},{tk}) must divide blocks ({block_q},{block_k})")
    if q.device.type == "cpu":
        out, lse = flash_forward_plain(q, k, v, causal=causal, block_k=block_k)
    else:
        out, lse = _kernels.flash_fwd(q, k, v, causal=causal,
                                      return_lse=return_lse)
    return (out, lse) if return_lse else out


def flash_backward_plain(q, k, v, o, lse, do, *, causal: bool,
                         block_q: int, block_k: int):
    """Plain PyTorch version of the flash backward kernels: the same
    function with the same numerics as ray_tpu's _flash_backward, in
    (``block_q``, ``block_k``) tiles, skipping the tiles those kernels
    skip (causal: wholly above the diagonal) —
    delta = rowsum(dO·O) in f32; s = q·kᵀ in f32, then ``* scale``; the
    -1e30 mask with p = exp(s − lse) set to 0 where masked; dP = dO·vᵀ in
    f32; dS = p∘(dP − delta)·scale; dQ = Σ dS (rounded to k's dtype)·k;
    dV = Σ pᵀ·dO and dK = Σ dSᵀ·q, both from the unrounded f32 p and dS.

    q/o/do [B,Tq,H,D], k/v [B,Tk,H,D], lse [B*H, Tq, 1] f32 (the
    forward's). Returns (dQ, dK, dV) in q's, k's and v's dtypes.
    """
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    heads = lambda x: x.permute(0, 2, 1, 3).float()  # noqa: E731  [B,H,T,D]
    qf, kf, vf, gf = heads(q), heads(k), heads(v), heads(do)
    delta = (gf * heads(o)).sum(-1, keepdim=True)  # [B,H,Tq,1]
    lse = lse.reshape(b, h, tq, 1)
    dq = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, tk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, h, tk, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, tq, block_q):
        qs = slice(q0, q0 + block_q)
        for k0 in range(0, tk, block_k):
            if causal and k0 > q0 + block_q - 1:
                break  # this key block and every later one lie above the diagonal
            ks = slice(k0, k0 + block_k)
            s = (qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)) * scale
            mask = None
            if causal:
                mask = _causal_mask(torch.arange(q0, min(q0 + block_q, tq), device=q.device),
                                    torch.arange(k0, min(k0 + block_k, tk), device=q.device))
                s = torch.where(mask, s, _NEG_INF)
            p = torch.exp(s - lse[:, :, qs])
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            dp = gf[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
            ds = p * (dp - delta[:, :, qs]) * scale
            dq[:, :, qs] += ds.to(k.dtype).float() @ kf[:, :, ks]
            dv[:, :, ks] += p.transpose(-1, -2) @ gf[:, :, qs]
            dk[:, :, ks] += ds.transpose(-1, -2) @ qf[:, :, qs]
    back = lambda x, dt: x.to(dt).permute(0, 2, 1, 3)  # noqa: E731
    return back(dq, q.dtype), back(dk, k.dtype), back(dv, v.dtype)


def _flash_backward(q, k, v, o, lse, do, *, causal, block_q, block_k):
    """The backward kernels on a CUDA tensor, their plain version on a CPU
    tensor; the counterpart of ``_flash_forward``, with the same
    divisibility contract. Returns (dQ, dK, dV).

    On the card delta = rowsum(dO·O) is one PyTorch reduction here, outside
    the kernels, as the reference computes it outside its kernels (one XLA
    fusion). Both kernels read it and the forward's LSE.
    """
    tq, tk = q.shape[1], k.shape[1]
    block_q = min(block_q, tq)
    block_k = min(block_k, tk)
    if tq % block_q or tk % block_k:
        raise ValueError(f"seq lens ({tq},{tk}) must divide blocks ({block_q},{block_k})")
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                    block_q=block_q, block_k=block_k)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(lse.shape).contiguous()
    dq = _kernels.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernels as its gradient; the
    residuals are q, k, v, O and the forward's LSE (ray_tpu's
    _flash_fwd_rule / _flash_bwd_rule)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = _flash_forward(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, block_q, block_k = ctx.blocks
        if do.stride(-1) != 1:
            do = do.contiguous()  # the kernels read rows with a unit stride
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, causal=causal,
                                     block_q=block_q, block_k=block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 256,
                    block_k: int = 256):
    """Flash attention: the Hopper kernels on a CUDA tensor, their plain
    versions on a CPU tensor. Differentiable: when a gradient is needed
    the forward keeps its LSE and the backward runs the dQ and dK/dV
    passes; otherwise only the forward runs."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, block_q, block_k)
    return _flash_forward(q, k, v, causal=causal, block_q=block_q,
                          block_k=block_k)


def attention(q, k, v, *, causal: bool = True, impl: str = "auto",
              block_q: int = 256, block_k: int = 256):
    """Dispatch: 'reference' | 'blockwise' | 'flash' | 'flash_jax' |
    'auto'.

    'auto' uses the flash kernel on a CUDA device when shapes tile
    cleanly and the keys are longer than 1024, plain attention for
    shorter sequences, else the blockwise path.
    """
    if impl == "reference":
        return dot_product_attention(q, k, v, causal=causal)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal)
    if impl == "flash":
        return flash_attention(q, k, v, causal, block_q, block_k)
    tq, tk = q.shape[1], k.shape[1]
    if impl == "flash_jax":
        # The reference routes this name to the TPU kernel bundled with
        # jax; the port has no such library kernel, so it routes to its
        # own flash kernel, under the same shape guard (blockwise for
        # shapes the tiles do not divide).
        if tq % min(block_q, tq) == 0 and tk % min(block_k, tk) == 0:
            return flash_attention(q, k, v, causal, block_q, block_k)
        return blockwise_attention(q, k, v, causal=causal)
    if tk <= 1024:
        return dot_product_attention(q, k, v, causal=causal)
    if q.is_cuda and tq % block_q == 0 and tk % block_k == 0:
        return flash_attention(q, k, v, causal, block_q, block_k)
    return blockwise_attention(q, k, v, causal=causal)
