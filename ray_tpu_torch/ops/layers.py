"""Elementwise/normalization building blocks (port of ray_tpu/ops/layers.py).

Plain functions on tensors: float32 statistics under bf16 activations,
results cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, weight, *, eps: float = 1e-5):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * weight).to(x.dtype)


def layer_norm(x, weight, bias, *, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def rope_frequencies(head_dim: int, max_len: int, *, theta: float = 10000.0,
                     device="cuda"):
    """Precompute RoPE cos/sin tables [max_len, head_dim/2] (float32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, *, position_offset: int = 0, positions=None):
    """Rotate [B, T, H, D] by position. ``positions`` overrides the
    arange (needed by sequence-parallel shards and decode steps)."""
    t = x.shape[1]
    if positions is None:
        positions = position_offset + torch.arange(t, device=x.device)
    c = cos[positions][None, :, None, :]
    s = sin[positions][None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: (silu(x·Wg) ⊙ (x·Wu)) · Wd."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """GPT-2 style MLP (tanh-approximated GELU)."""
    h = F.gelu(x @ w_in + b_in, approximate="tanh")
    return h @ w_out + b_out
