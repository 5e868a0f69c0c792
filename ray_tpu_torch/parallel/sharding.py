"""Parameter and activation sharding rules over DTensor (port of
ray_tpu/parallel/sharding.py).

A layout is written as ray_tpu writes it, a ``P`` (PartitionSpec): one
entry per tensor dim, each a mesh axis name, a tuple of names (the dim
split over all of them, major to minor) or None. ``to_placements`` turns
it into DTensor placements on a mesh, and parameters become DTensors
(``torch.distributed.tensor.distribute_tensor``); DTensor's
redistributions then do what GSPMD's inserted collectives do in ray_tpu
(the all-gather before use, the reduce-scatter of gradients).

Strategies:
  - ``dp``    — replicate params; batch over the data axes (DDP).
  - ``fsdp``  — ZeRO-3: shard the largest divisible dim of every param
                over the fsdp axis.
  - model-provided spec trees — TP/EP layouts are model knowledge; the
                model library exports ``partition_specs()`` consumed here.
"""

from __future__ import annotations

from ray_tpu_torch.ops.tree import tree_map
from ray_tpu_torch.parallel.mesh import AXIS_FSDP, mesh_axis_size


class P(tuple):
    """A PartitionSpec: ``P(None, "tensor")``, ``P(("data", "fsdp"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def replicated(mesh) -> list:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def fsdp_spec_for(shape, fsdp_size: int, base_spec: P | None = None) -> P:
    """ZeRO-3 layout for one param: shard its largest eligible dim over the
    fsdp axis. ``base_spec`` (e.g. a TP spec from the model) is preserved;
    fsdp claims the biggest dim the base spec leaves unsharded (the later
    dim among equals)."""
    base = tuple(base_spec) if base_spec is not None else ()
    base = base + (None,) * (len(shape) - len(base))
    if fsdp_size <= 1:
        return P(*base)
    candidates = [
        (dim_size, i)
        for i, dim_size in enumerate(shape)
        if base[i] is None and dim_size % fsdp_size == 0
    ]
    if not candidates:
        return P(*base)  # tiny/odd param: stays replicated over fsdp
    _, dim = max(candidates)
    new = list(base)
    new[dim] = AXIS_FSDP
    return P(*new)


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a param tree and a spec tree mirroring it,
    where a spec subtree may be one None for all of its leaves."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs.get(k) if isinstance(specs, dict) else None)
                for k, v in tree.items()}
    return fn(tree, specs)


def infer_param_specs(params, mesh, base_specs=None):
    """P tree for a param tree: model base specs (TP/EP) plus fsdp
    sharding of whatever they leave unsharded."""
    fsdp = mesh_axis_size(mesh, AXIS_FSDP)

    def one(leaf, base):
        # Model base specs name the full logical layout; drop axes this
        # mesh doesn't have before layering fsdp on top.
        if base is not None:
            base = prune_spec(base, mesh)
        return fsdp_spec_for(tuple(leaf.shape), fsdp, base)

    return _map_specs(one, params, base_specs)


def to_placements(spec: P | None, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: Shard(d) on each mesh
    dim that tensor dim d names, Replicate on the others. A dim split over
    several axes takes them major to minor, which must be the mesh's
    order (DTensor splits by mesh dim, outer first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(prune_spec(spec, mesh)):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} is split over {axes}, not in the mesh's "
                             f"order {names}")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {spec}")
            placements[i] = Shard(dim)
    return placements


def make_shardings(mesh, spec_tree):
    """P tree → tree of DTensor placements."""
    return tree_map(lambda s: to_placements(s, mesh), spec_tree)


def shard_params(params, mesh, base_specs=None):
    """Place a param tree onto the mesh: every leaf becomes a DTensor laid
    out by ``infer_param_specs``; returns (params, specs). Every rank
    passes the same tree (as ``interop.params_from_jax`` gives it) and
    keeps its own shards of it; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    specs = infer_param_specs(params, mesh, base_specs)
    placed = _map_specs(
        lambda t, s: distribute_tensor(t.to(mesh.device_type), mesh,
                                       to_placements(s, mesh), src_data_rank=None),
        params, specs)
    return placed, specs


def constrain(x, mesh, *spec):
    """Lay ``x`` out as ``spec`` says (ray_tpu's with_sharding_constraint):
    a DTensor is redistributed, a plain tensor is taken as the whole
    value, which every rank holds. Differentiable. Axes absent from the
    mesh (collapsed size-1 axes) are dropped from the spec, so model code
    can name its full logical layout and run on any degenerate mesh; with
    ``mesh=None`` it returns ``x``."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    placements = to_placements(P(*spec), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, replicated(mesh), run_check=False)
    return x.redistribute(mesh, placements)


def _prune_axes(entry, mesh):
    names = mesh.mesh_dim_names or ()
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None
    return entry if entry in names else None


def prune_spec(spec: P | None, mesh) -> P:
    """Drop mesh-absent axis names from a P."""
    if spec is None:
        return P()
    return P(*(_prune_axes(s, mesh) for s in spec))
