"""SPMD pipeline parallelism: GPipe-style microbatch rotation in one
program on every rank (port of ray_tpu/parallel/pipeline.py).

Every rank of the ``pipeline`` mesh dim runs the same loop over clock
ticks; stage-to-stage transfer is a point-to-point shift along that dim's
ring (``batch_isend_irecv`` on its process group), the counterpart of
ray_tpu's ``ppermute``. Differentiable: the shift carries gradients back
a stage.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.tree import tree_leaves, tree_map, tree_unflatten
from ray_tpu_torch.parallel._collectives import axis_group, ring_shift
from ray_tpu_torch.parallel.mesh import AXIS_PIPELINE


def pipeline_stage_params(params_per_stage):
    """Stack per-stage param trees along a leading stage axis (each
    pipeline rank takes its own stage's slice)."""
    leaves = [list(tree_leaves(p)) for p in params_per_stage]
    return tree_unflatten(params_per_stage[0], [torch.stack(xs) for xs in zip(*leaves)])


def spmd_pipeline(stage_fn, stage_params, microbatches, *, mesh,
                  axis_name: str = AXIS_PIPELINE):
    """Run ``stage_fn`` as a pipeline over ``mesh``'s ``axis_name`` dim.

    Called on every rank of the dim. Each holds ``stage_params`` for its
    own stage and the full stack of ``microbatches`` [n_micro, micro, ...]
    (stage 0's copy is the one that is read).

    Returns outputs [n_micro, micro, ...], valid on the *last* stage
    (other ranks hold zeros — combine with ``pipeline_last_to_all`` or let
    the loss live on the last stage).
    """
    group, stage, n_stages = axis_group(mesh, axis_name)
    n_micro = microbatches.shape[0]
    state = torch.zeros_like(microbatches[0])
    outputs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # Stage 0 injects microbatch t (clamped once the bubble drains);
        # later stages consume what the previous tick shifted in.
        x = microbatches[min(t, n_micro - 1)] if stage == 0 else state
        y = stage_fn(stage_params, x)
        # Microbatch index emerging from the last stage at tick t:
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outputs[out_idx] = y
        state = ring_shift(y, group, stage, n_stages)
    return torch.stack([torch.zeros_like(state) if y is None else y for y in outputs])


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank of the group (a broadcast).
    The value is replicated, so its gradient — the same on every rank —
    goes back to the last stage once, and the others get zeros."""

    @staticmethod
    def forward(ctx, x, group, src, is_src):
        import torch.distributed as dist

        ctx.is_src = is_src
        x = x.contiguous().clone()
        dist.broadcast(x, src=src, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_src else torch.zeros_like(grad)), None, None, None


def pipeline_last_to_all(outputs, *, mesh, axis_name: str = AXIS_PIPELINE):
    """Broadcast last-stage pipeline outputs to every rank (for losses or
    metrics computed off-pipeline)."""
    import torch.distributed as dist

    group, stage, n_stages = axis_group(mesh, axis_name)
    src = dist.get_global_rank(group, n_stages - 1)
    return _FromLast.apply(outputs, group, src, stage == n_stages - 1)


def pipelined_apply(stage_fn, params_per_stage, mesh, batch, *, num_microbatches):
    """Split ``batch`` into microbatches, run the pipeline over ``mesh``'s
    pipeline dim, return the full output batch on all ranks. ``batch`` is
    the global batch, the same on every rank."""
    from ray_tpu_torch.parallel.mesh import mesh_axis_size

    n_stages = mesh_axis_size(mesh, AXIS_PIPELINE)
    if n_stages == 1:
        # Degenerate mesh (pipeline axis collapsed): sequential apply.
        out = batch
        for p in params_per_stage:
            out = stage_fn(p, out)
        return out
    if len(params_per_stage) != n_stages:
        raise ValueError(
            f"{len(params_per_stage)} stages != pipeline axis size {n_stages}"
        )

    stage = axis_group(mesh, AXIS_PIPELINE)[1]
    stacked = pipeline_stage_params(params_per_stage)
    own = tree_map(lambda p: p[stage], stacked)
    micro = batch.reshape((num_microbatches, -1) + tuple(batch.shape[1:]))
    outs = pipeline_last_to_all(spmd_pipeline(stage_fn, own, micro, mesh=mesh), mesh=mesh)
    return outs.reshape(tuple(batch.shape[:1]) + tuple(outs.shape[2:]))
