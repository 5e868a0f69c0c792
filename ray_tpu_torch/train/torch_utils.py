"""Helpers for the per-worker training loop (port of
ray_tpu/train/jax_utils.py).

A data-parallel loop in which every worker is one rank of the session's
process group: ``sync_model_params`` starts every rank from rank 0's
parameters, ``allreduce_gradients`` averages the gradients, ``barrier``
waits for every rank. Trees are nested dicts (lists and tuples too) of
tensors. Inside one process sharded over a DeviceMesh, use
``ray_tpu_torch.parallel`` instead: DTensor inserts those collectives.

As in the reference, a world of one rank sends nothing, and each call
sends one buffer, not one per leaf. The second parameter is the
reference's ``group_name``: None is the session's group, a name is the
process group ``TorchBackend.on_worker_setup`` registered under it
(``backend.get_group``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.tree import tree_leaves, tree_unflatten
from ray_tpu_torch.train.backend import get_group
from ray_tpu_torch.train.session import get_session

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _check_name(group_name) -> None:
    if group_name is not None and not isinstance(group_name, str):
        raise TypeError(f"group_name must be a str or None, got "
                        f"{type(group_name).__name__}")


def _group(session, group_name):
    """The process group ``group_name`` names (None: the session's)."""
    return session.group if group_name is None else get_group(group_name)


def sync_model_params(params, group_name: str | None = None):
    """Rank 0's ``params`` on every rank (DDP's initial broadcast). Every
    leaf's bytes travel in one uint8 buffer, so dtypes and bits come
    through as they are, whatever mix of dtypes the tree holds."""
    _check_name(group_name)
    session = get_session()
    if session.world_size == 1:
        return params
    group = _group(session, group_name)
    leaves = list(tree_leaves(params))
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0) if group is not None else 0,
                   group=group)
    out, pos = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        # A copy of the slice first: viewing bytes as a wider dtype needs
        # an offset that is a multiple of its size, which a leaf after an
        # odd-length 16-bit leaf does not have.
        out.append(flat[pos:pos + n].clone().view(t.dtype).reshape(t.shape))
        pos += n
    return tree_unflatten(params, out)


def allreduce_gradients(grads, group_name: str | None = None, op: str = "mean"):
    """Gradients reduced over the session's ranks (``op``: "mean", "sum",
    "max" or "min"). All leaves travel in ONE flat float32 buffer (the
    reduction is in f32, whatever the leaves' dtype), and each leaf comes
    back in its own dtype, so bf16 gradients stay bf16. A mean on NCCL is
    its AVG reduction; gloo has none, so there it is a sum and a divide."""
    _check_name(group_name)
    session = get_session()
    if session.world_size == 1:
        return grads
    group = _group(session, group_name)
    if op == "mean":
        backend = dist.get_backend(group)
        reduce_op = dist.ReduceOp.AVG if backend == "nccl" else dist.ReduceOp.SUM
    elif op in _REDUCE:
        reduce_op = _REDUCE[op]
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    leaves = list(tree_leaves(grads))
    flat = torch.cat([g.detach().reshape(-1).float() for g in leaves])
    dist.all_reduce(flat, op=reduce_op, group=group)
    if op == "mean" and reduce_op == dist.ReduceOp.SUM:
        flat /= session.world_size
    out, pos = [], 0
    for g in leaves:
        out.append(flat[pos:pos + g.numel()].reshape(g.shape).to(g.dtype))
        pos += g.numel()
    return tree_unflatten(grads, out)


def barrier(group_name: str | None = None):
    _check_name(group_name)
    session = get_session()
    if session.world_size == 1:
        return
    dist.barrier(group=_group(session, group_name))
