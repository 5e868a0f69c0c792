"""Helpers for the per-worker training loop (port of
ray_tpu/train/jax_utils.py).

A data-parallel loop in which every worker is one rank of the session's
process group: ``sync_model_params`` starts every rank from rank 0's
parameters, ``allreduce_gradients`` averages the gradients, ``barrier``
waits for every rank. Trees are nested dicts (lists and tuples too) of
tensors. Inside one process sharded over a DeviceMesh, use
``ray_tpu_torch.parallel`` instead: DTensor inserts those collectives.

As in the reference, a world of one rank sends nothing, and each call
sends one buffer, not one per leaf.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.train.session import get_session

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    """``tree``'s structure holding the tensors ``it`` yields, in _leaves'
    order (NamedTuples keep their type)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, it) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return next(it)


def _session_group(group):
    session = get_session()
    return session, (group if group is not None else session.group)


def sync_model_params(params, group=None):
    """Rank 0's ``params`` on every rank (DDP's initial broadcast). Every
    leaf's bytes travel in one uint8 buffer, so dtypes and bits come
    through as they are. ``group`` defaults to the session's."""
    session, group = _session_group(group)
    if session.world_size == 1:
        return params
    leaves = _leaves(params)
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0) if group is not None else 0,
                   group=group)
    out, pos = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        out.append(flat[pos:pos + n].view(t.dtype).reshape(t.shape))
        pos += n
    return _rebuild(params, iter(out))


def allreduce_gradients(grads, group=None, op: str = "mean"):
    """Gradients reduced over the session's ranks (``op``: "mean", "sum",
    "max" or "min"). All leaves travel in ONE flat float32 buffer (the
    reduction is in f32, whatever the leaves' dtype), and each leaf comes
    back in its own dtype, so bf16 gradients stay bf16. A mean on NCCL is
    its AVG reduction; gloo has none, so there it is a sum and a divide."""
    session, group = _session_group(group)
    if session.world_size == 1:
        return grads
    if op == "mean":
        backend = dist.get_backend(group)
        reduce_op = dist.ReduceOp.AVG if backend == "nccl" else dist.ReduceOp.SUM
    elif op in _REDUCE:
        reduce_op = _REDUCE[op]
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    leaves = _leaves(grads)
    flat = torch.cat([g.detach().reshape(-1).float() for g in leaves])
    dist.all_reduce(flat, op=reduce_op, group=group)
    if op == "mean" and reduce_op == dist.ReduceOp.SUM:
        flat /= session.world_size
    out, pos = [], 0
    for g in leaves:
        out.append(flat[pos:pos + g.numel()].reshape(g.shape).to(g.dtype))
        pos += g.numel()
    return _rebuild(grads, iter(out))


def barrier(group=None):
    session, group = _session_group(group)
    if session.world_size == 1:
        return
    dist.barrier(group=group)
