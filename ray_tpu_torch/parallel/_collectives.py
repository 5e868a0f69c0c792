"""Differentiable collectives along one mesh dim, written out where the
sharded paths need them inside a rank's local program: a point-to-point
shift around the dim's ring (the port's counterpart of
``jax.lax.ppermute``, for ring attention and the SPMD pipeline), and the
expert dim's split and gather (expert parallelism's layout changes, as
moe_swiglu's ``constrain_fn``)."""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_group(mesh, axis: str):
    """(process group, this rank's index, size) of mesh dim ``axis``."""
    dim = tuple(mesh.mesh_dim_names).index(axis)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)


def _exchange(x, group, send_to: int, recv_from: int):
    """Send ``x`` to group rank ``send_to`` and receive a tensor like it
    from ``recv_from``, in one batch_isend_irecv."""
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, send_to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Every rank of ``group`` sends ``x`` to the next rank (index + 1,
    wrapping) and returns what the previous one sent; the gradient
    travels the other way (ppermute's transpose)."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.ring = (group, index, size)
        return _exchange(x, group, (index + 1) % size, (index - 1) % size)

    @staticmethod
    def backward(ctx, grad):
        group, index, size = ctx.ring
        return _exchange(grad, group, (index - 1) % size, (index + 1) % size), None, None, None


def ring_shift(x, group, index: int, size: int):
    """``x`` of the previous rank along the ring of ``group``."""
    return _RingShift.apply(x, group, index, size)


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` [n, E_local, ...] joined along dim 1 in rank order
    (an all-gather). The result is the same on every rank and so is its
    gradient, of which each rank keeps its own part."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.part = (index, x.shape[1])
        lead = x.transpose(0, 1).contiguous()
        out = torch.empty((size * lead.shape[0], *lead.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, lead, group=group)
        return out.transpose(0, 1)

    @staticmethod
    def backward(ctx, grad):
        index, n = ctx.part
        return grad[:, index * n:(index + 1) * n], None, None, None


class _Split(torch.autograd.Function):
    """This rank's part of ``x`` [n, E, ...] along dim 1 (no transfer): the
    value is the same on every rank, so its gradient is every rank's part
    joined (an all-gather)."""

    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.ring = (group, index, size)
        n = x.shape[1] // size
        return x[:, index * n:(index + 1) * n]

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, *ctx.ring), None, None, None


class ExpertShard:
    """moe_swiglu's ``constrain_fn`` under expert parallelism, on a rank
    holding experts [i·E/n, (i+1)·E/n) of the E experts (the mesh's
    ``axis`` of size n, this rank at index i). ray_tpu lays the dispatched
    activations and the experts' outputs out with their expert dim over
    the expert axis; here the dispatched activations [n, E, C, D], the
    same on every rank, keep this rank's experts, and the experts' outputs
    [n, E/n, C, D] are gathered from every rank, so that each rank combines
    all experts as the unsharded layer does. Values and gradients are the
    same on every rank of the axis, but for the experts' own weights'."""

    def __init__(self, mesh, axis: str, n_experts: int):
        self.group, self.index, self.size = axis_group(mesh, axis)
        self.n_experts = n_experts

    def __call__(self, t):
        args = (self.group, self.index, self.size)
        if self.size == 1:
            return t
        if t.shape[1] == self.n_experts:
            return _Split.apply(t, *args)
        if t.shape[1] * self.size == self.n_experts:
            return _Gather.apply(t, *args)
        raise ValueError(f"dim 1 of {tuple(t.shape)} holds neither all {self.n_experts} "
                         f"experts nor 1/{self.size} of them")
