"""The port's side of the sharded tests (test_torch_parallel.py):
functions each rank of a gloo CPU group runs, spawned by
ray_tpu_torch.parallel._spawn. This module imports no JAX (the children
must not load XLA); inputs arrive as numpy arrays, made by the
test from seeds or carried across from the JAX package's params, and
results go back as numpy arrays."""

from __future__ import annotations

import os

import torch

from ray_tpu_torch import models
from ray_tpu_torch.interop import params_from_jax
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.ops import optim
from ray_tpu_torch.ops.moe import route
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded
from ray_tpu_torch.ops.tree import tree_map
from ray_tpu_torch.parallel import (
    MeshConfig,
    P,
    batch_sharding,
    pipelined_apply,
    shard_params,
    to_placements,
)
from ray_tpu_torch.parallel.multislice import (
    build_multislice_mesh,
    dcn_allreduce_axes,
    detect_num_slices,
    multislice_batch_axes,
)


def stage(p, x):
    """The pipeline's stage (tests/test_ops_parallel.py:150)."""
    return torch.tanh(x @ p["w"])


def _full(tree):
    """Every DTensor leaf of ``tree`` gathered whole."""
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)


def placement(params):
    """shard_params on (data 1, fsdp 4): this rank's shard of every leaf."""
    mesh = MeshConfig(data=1, fsdp=4).build("cpu")
    c = models.tiny(dtype="float32")
    placed, specs = shard_params(params_from_jax(params, "cpu"), mesh, T.partition_specs(c))
    return {"shards": tree_map(lambda t: t.to_local(), placed),
            "specs": tree_map(repr, specs)}


def batch_rows(rows):
    """A batch over (data 2, fsdp 2), its rows naming their own index: the
    rows this rank holds, by batch_sharding and by the spec
    P(("data", "fsdp"))."""
    from torch.distributed.tensor import distribute_tensor

    mesh = MeshConfig(data=2, fsdp=2).build("cpu")
    t = torch.as_tensor(rows)
    by_batch = distribute_tensor(t, mesh, batch_sharding(mesh), src_data_rank=None)
    by_spec = distribute_tensor(t, mesh, to_placements(P(("data", "fsdp")), mesh),
                                src_data_rank=None)
    return {"batch_sharding": by_batch.to_local(), "spec": by_spec.to_local()}


def ring(q, k, v, w, causal):
    """ring_attention_sharded on (data 1, sequence 4): the output and the
    gradients of sum(tanh(out @ w)) in q, k, v."""
    mesh = MeshConfig(data=1, sequence=4).build("cpu")
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ring_attention_sharded(*leaves, mesh, causal=causal).full_tensor()
    grads = torch.autograd.grad(torch.tanh(out @ torch.as_tensor(w)).sum(), leaves)
    return {"out": out, "grads": list(grads)}


def pipeline(params, batch):
    """pipelined_apply on (data 1, pipeline 4) with 8 microbatches; the
    degenerate path (no pipeline axis); the stage-count error."""
    params = [{"w": torch.as_tensor(p["w"])} for p in params]
    batch = torch.as_tensor(batch)
    out = pipelined_apply(stage, params, MeshConfig(data=1, pipeline=4).build("cpu"),
                          batch, num_microbatches=8)
    flat = pipelined_apply(stage, params, MeshConfig(data=4).build("cpu"), batch,
                           num_microbatches=8)
    try:
        pipelined_apply(stage, params[:3], MeshConfig(data=1, pipeline=4).build("cpu"),
                        batch, num_microbatches=8)
        error = None
    except ValueError as e:
        error = str(e)
    return {"out": out, "sequential": flat, "error": error}


def meshes():
    """detect_num_slices; build_multislice_mesh(2, MeshConfig(fsdp=2))'s
    dims, shape and batch axes, and its error for 3 slices of 4 ranks;
    single_device_mesh's dims, size and rank."""
    from ray_tpu_torch.parallel import single_device_mesh

    mesh = build_multislice_mesh(2, MeshConfig(fsdp=2), device_type="cpu")
    try:
        build_multislice_mesh(3, device_type="cpu")
        error = None
    except ValueError as e:
        error = str(e)
    one = single_device_mesh("cpu")
    return {"slices": detect_num_slices(), "names": list(mesh.mesh_dim_names),
            "shape": list(mesh.shape), "batch_axes": list(multislice_batch_axes(mesh)),
            "allreduce_axes": list(dcn_allreduce_axes(mesh)), "error": error,
            "single": [list(one.mesh_dim_names), one.size(), one.mesh.tolist()]}


def _optimizer(kind):
    if kind == "fused":
        return optim.FusedClipAdamW(learning_rate=1e-3, eps=1e-3, weight_decay=0.1,
                                    clip_norm=1.0)
    if kind == "chain":
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(1e-3, eps=1e-6, weight_decay=0.1))
    return optim.sgd(1e-2)


def _mesh(kind):
    if kind == "multislice":
        return build_multislice_mesh(2, MeshConfig(tensor=2), device_type="cpu")
    return MeshConfig(**dict(kind)).build("cpu")


def train(config, params, tokens, mesh_kind, opt_kind, mask=None, steps=2, routing=False):
    """``steps`` steps of make_train_step(mesh=) from ``params``: each
    step's metrics, the final params gathered whole, each expert weight's
    placements, and (``routing``) the experts keeping each token in every
    MoE layer before each step, as seen by the sharded forward's
    moe_swiglu."""
    c = T.TransformerConfig(**config)
    mesh = _mesh(mesh_kind)
    opt = _optimizer(opt_kind)
    placed, _ = shard_params(params_from_jax(params, "cpu"), mesh, T.partition_specs(c))
    state = {"params": placed, "opt_state": opt.init(placed),
             "step": torch.zeros((), dtype=torch.int32)}
    step = T.make_train_step(c, opt, mesh=mesh)
    batch = {"tokens": torch.as_tensor(tokens)}
    if mask is not None:
        batch["mask"] = torch.as_tensor(mask)
    if mesh_kind == "multislice":  # the batch over (dcn, ...), as the JAX test puts it
        from torch.distributed.tensor import distribute_tensor

        batch = {k: distribute_tensor(
            v, mesh, to_placements(P(multislice_batch_axes(mesh)), mesh),
            src_data_rank=None) for k, v in batch.items()}
    metrics, kept = [], []
    for _ in range(steps):
        if routing:
            kept.append(_sharded_routing(state["params"], torch.as_tensor(tokens)[:, :-1],
                                         c, mesh))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": _full(state["params"]), "kept": kept,
           "mesh": list(mesh.mesh_dim_names)}
    if c.n_experts > 0:
        out["expert_placements"] = repr(state["params"]["layers"]["mlp"]["w_gate"].placements)
    return out


def _sharded_routing(params, inputs, c, mesh):
    """The experts keeping each token ([n, g, E] bool per layer), from the
    inputs of every moe_swiglu call of one sharded forward."""
    kept, orig = [], T.moe_swiglu

    def spy(x, router_w, *w, top_k, capacity_factor, group_size, **kw):
        kept.append(route(x, router_w, top_k=top_k, capacity_factor=capacity_factor,
                          group_size=group_size)[1].sum(-1) > 0)
        return orig(x, router_w, *w, top_k=top_k, capacity_factor=capacity_factor,
                    group_size=group_size, **kw)

    T.moe_swiglu = spy
    try:
        with torch.no_grad():
            T.forward(params, inputs, c, mesh=mesh)
    finally:
        T.moe_swiglu = orig
    return [k.numpy() for k in kept]


def run(rank, world, cases):
    """Every case in ``cases`` ({name: (function name, kwargs)}), in order,
    on this rank: {name: result}. Each rank takes its share of the cores
    (torch's default of all of them on every rank oversubscribes)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return {name: globals()[fn](**kwargs) for name, (fn, kwargs) in cases.items()}
