"""Mixture-of-Experts ops (port of ray_tpu/ops/moe.py): top-k routing with
static-shape dispatch.

Routing is the reference's dense GShard/Switch form: one-hot dispatch and
combine tensors over a fixed per-expert capacity, applied by einsums;
every shape is static and nothing is gathered by index. The router, the
softmax, dispatch and combine run in float32, the expert products in the
compute dtype. Keep float32 products true float32 on the card
(``torch.backends.cuda.matmul.allow_tf32`` off, its default): a TF32
router product moves the logits by ~1e-4 and flips top-k choices.

Expert parallelism (``moe_swiglu``'s ``constrain_fn``): each rank of the
expert axis routes all tokens and runs its own experts on their slots;
the experts' outputs are gathered, and every rank combines all of them.

Aux (load-balance) loss follows Switch Transformer: E * Σ_e f_e · p_e,
where f_e is the fraction of tokens routed to expert e and p_e the mean
router probability — minimized when routing is uniform.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots, rounded up to a multiple of 8."""
    c = int(math.ceil(top_k * num_tokens / num_experts * capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def topk_dispatch(router_logits, top_k: int, capacity: int):
    """Build dispatch/combine tensors from router logits [..., G, E].

    Returns (dispatch [..., G, E, C] float32, combine [..., G, E, C]
    float32, aux_loss [...]); leading dims are independent token groups
    (the reference maps [G, E] and vmaps over groups). Tokens are assigned
    to their top-k experts in choice order, ties to the lower expert index
    (jax.lax.top_k's order, hence the stable sort); each expert has C
    slots filled first-come-first-served (position = running count of
    earlier tokens choosing it); overflow tokens are dropped for that
    expert (combine weight 0: they pass through the residual unchanged).
    """
    G, E = router_logits.shape[-2:]
    probs = torch.softmax(router_logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    # Renormalize the selected gates so combine weights sum to 1 per token.
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # Slot arithmetic in int64 throughout (one_hot's and cumsum's type).
    counts = torch.zeros((*router_logits.shape[:-2], E), dtype=torch.int64,
                         device=router_logits.device)
    dispatch = combine = None
    for j in range(top_k):  # unrolled: top_k is tiny (1 or 2 typically)
        oh = F.one_hot(topi[..., j], E)  # [..., G, E]
        pos = oh.cumsum(-2) - 1 + counts[..., None, :]  # slot per token
        counts = counts + oh.sum(-2)
        pos_sel = (pos * oh).sum(-1)  # [..., G]
        kept = ((pos < capacity) & (oh > 0)).any(-1)
        # Capacity overflow → index C, whose one-hot column is cut off:
        # an all-zero row (the token is dropped), as jax.nn.one_hot(C, C).
        slot = F.one_hot(torch.where(kept, pos_sel, capacity),
                         capacity + 1)[..., :capacity].float()  # [..., G, C]
        d_j = oh.float()[..., :, None] * slot[..., None, :]
        c_j = topv[..., j, None, None] * d_j
        dispatch = d_j if dispatch is None else dispatch + d_j
        combine = c_j if combine is None else combine + c_j

    # Switch aux loss on the FULL probability mass (pre-top-k).
    frac_routed = dispatch.sum(dim=(-3, -1)) / max(G, 1)  # f_e
    mean_prob = probs.mean(dim=-2)  # p_e
    aux = E * (frac_routed * mean_prob).sum(-1)
    return dispatch, combine, aux


def _group_size(total: int, target: int) -> int:
    """Largest divisor of ``total`` that is <= target."""
    g = min(target, total)
    while total % g:
        g -= 1
    return g


def route(x, router_w, *, top_k: int, capacity_factor: float = 1.25,
          group_size: int = 1024):
    """moe_swiglu's routing of x [B, S, D] by router_w [D, E]: the tokens
    in n groups of g, as (xg [n, g, D] float32, dispatch [n, g, E, C],
    combine [n, g, E, C], aux [n])."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    G = B * S
    g = _group_size(G, group_size)
    xg = x.reshape(G // g, g, D).float()
    logits = torch.einsum("ngd,de->nge", xg, router_w.float())
    C = expert_capacity(g, E, top_k, capacity_factor)
    return (xg, *topk_dispatch(logits, top_k, C))


def moe_swiglu(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               capacity_factor: float = 1.25, group_size: int = 1024,
               constrain_fn=None):
    """MoE SwiGLU FFN for one layer.

    x [B, S, D]; router_w [D, E]; w_gate/w_up [E, D, F]; w_down [E, F, D].
    Returns (out [B, S, D], aux_loss scalar).

    Tokens are processed in GROUPS of ~``group_size`` (GShard-style):
    dispatch/combine are [n, g, E, C_g] with C_g ∝ g, so memory and
    dispatch FLOPs scale O(G·g) instead of the O(G²) a single global
    dispatch would cost. The n groups are one batch dimension of every
    product. ``constrain_fn`` (optional) lays out the [n, E, C, D]
    dispatched activations and the experts' outputs, at ray_tpu's two
    points: under expert parallelism (parallel._collectives.ExpertShard)
    it keeps a rank's experts of the first and gathers every rank's into
    the second, and w_gate/w_up/w_down then hold that rank's experts only.
    """
    dt = x.dtype
    xg, dispatch, combine, aux = route(x, router_w, top_k=top_k,
                                       capacity_factor=capacity_factor,
                                       group_size=group_size)
    expert_in = torch.einsum("ngec,ngd->necd", dispatch, xg).to(dt)
    if constrain_fn is not None:
        expert_in = constrain_fn(expert_in)
    gate = F.silu(torch.einsum("necd,edf->necf", expert_in, w_gate.to(dt)))
    up = torch.einsum("necd,edf->necf", expert_in, w_up.to(dt))
    expert_out = torch.einsum("necf,efd->necd", gate * up, w_down.to(dt))
    if constrain_fn is not None:
        expert_out = constrain_fn(expert_out)
    out = torch.einsum("ngec,necd->ngd", combine, expert_out.float()).to(dt)
    return out.reshape(x.shape), aux.mean()
