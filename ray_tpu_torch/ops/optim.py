"""Fused clip + AdamW for the training step (port of ray_tpu/ops/optim.py).

Same semantics as ray_tpu's ``FusedClipAdamW`` (and so as
optax.chain(clip_by_global_norm(c), adamw(...))): one global gradient
norm, the clip scale min(1, clip / max(norm, 1e-12)) applied inline, the
bias-corrected Adam direction, and decoupled weight decay added after it,
NOT rescaled by the clip. The norm is returned so the step's metric costs
nothing more.

The reference is an XLA fusion, not a Pallas kernel; here it is plain
PyTorch. Unlike the reference, ``apply`` updates the parameters and the
moments IN PLACE (JAX returns new arrays): the returned trees are the
ones passed in.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch.ops.tree import tree_leaves, zeros_like


@dataclass(frozen=True)
class FusedClipAdamW:
    """AdamW with inline global-norm clipping.

    ``init`` mirrors optax's state shape {m, v, count}; ``apply(grads,
    state, params)`` returns (params, state, grad_norm) after updating
    params, m and v in place. ``mu_dtype`` (a torch dtype, e.g.
    torch.bfloat16) stores the first moment in fewer bits.
    """

    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0
    mu_dtype: torch.dtype | None = None

    def init(self, params):
        device = next(tree_leaves(params)).device
        return {
            "m": zeros_like(params, self.mu_dtype),
            "v": zeros_like(params),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }

    @torch.no_grad()
    def apply(self, grads, state, params):
        gl = list(tree_leaves(grads))
        gnorm = torch.stack([g.float().square().sum() for g in gl]).sum().sqrt()
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        count = state["count"] + 1
        c = count.float()
        # optax's bias correction: m̂ = m/(1-b1^t), v̂ = v/(1-b2^t).
        bc1 = 1.0 - torch.pow(self.b1, c)
        bc2 = 1.0 - torch.pow(self.b2, c)
        for p, g, m, v in zip(tree_leaves(params), gl, tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            gf = g.float() * scale
            m_new = self.b1 * m.float() + (1.0 - self.b1) * gf
            v_new = self.b2 * v.float() + (1.0 - self.b2) * (gf * gf)
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p.float()
            p.copy_(p.float() - self.learning_rate * update)
            m.copy_(m_new)
            v.copy_(v_new)
        return params, {"m": state["m"], "v": state["v"], "count": count}, gnorm
