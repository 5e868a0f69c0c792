"""Device meshes over torch.distributed (port of ray_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions, one per parallelism strategy, in ray_tpu's outer→inner order:

    pipeline > data > fsdp > expert > sequence > tensor

Axes of size 1 collapse away, so a mesh names only the axes it splits
(an all-collapsed mesh is ``("data",)`` of size 1). The mesh spans the
ranks of the initialised default process group, rank r at the r-th
position in row-major order; ``MeshConfig.build`` initialises no group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

AXIS_PIPELINE = "pipeline"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"

# Outer→inner order: tensor-parallel collectives come once per layer, so
# the tensor axis is innermost (neighbouring ranks); pipeline outermost.
DEFAULT_AXIS_ORDER = (
    AXIS_PIPELINE,
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_EXPERT,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
)

# Batch-like axes: a global batch dimension is split over all of these
# together (data-parallel replicas and fsdp shards both take distinct
# examples; fsdp also shards the parameters).
BATCH_AXES = (AXIS_DATA, AXIS_FSDP)


def _world_size(device_type: str) -> int:
    """The default group's size, after checking that ``device_type`` has
    a device here and that the group is initialised."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                           "device_type='cpu' for a CPU (gloo) mesh")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _device_mesh(device_type: str, names: tuple, shape: tuple, ranks=None):
    """A DeviceMesh of ``shape`` named ``names`` over the default group's
    ranks, laid out row-major (or in the order ``ranks`` gives)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if ranks is None:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def _axes(sizes: dict, order: tuple) -> tuple[tuple, tuple]:
    """(names, shape) of the axes of size > 1 in ``order``; ("data",), (1,)
    when every axis collapses."""
    names = tuple(a for a in order if sizes[a] > 1)
    if not names:
        return (AXIS_DATA,), (1,)
    return names, tuple(sizes[a] for a in names)


@dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. Any axis left at 1 collapses away.

    ``data=-1`` (default) absorbs all remaining ranks, so
    ``MeshConfig(tensor=4)`` on 16 ranks gives a 4×4 data×tensor mesh.
    """

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipeline: int = 1
    sequence: int = 1
    expert: int = 1
    axis_order: tuple = field(default=DEFAULT_AXIS_ORDER)

    def sizes(self) -> dict:
        return {
            AXIS_PIPELINE: self.pipeline,
            AXIS_DATA: self.data,
            AXIS_FSDP: self.fsdp,
            AXIS_EXPERT: self.expert,
            AXIS_SEQUENCE: self.sequence,
            AXIS_TENSOR: self.tensor,
        }

    def resolve(self, num_devices: int) -> dict:
        """Fill in the -1 axis and validate the factorization."""
        sizes = self.sizes()
        wildcard = [a for a, n in sizes.items() if n == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(n for n in sizes.values() if n != -1)
        if wildcard:
            if num_devices % fixed:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wildcard[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f"mesh axes product {fixed} != device count {num_devices}"
            )
        return sizes

    def build(self, device_type: str = "cuda"):
        """The DeviceMesh of this shape over every rank of the initialised
        default group, one device (of ``device_type``) per rank."""
        names, shape = _axes(self.resolve(_world_size(device_type)), self.axis_order)
        return _device_mesh(device_type, names, shape)


def single_device_mesh(device_type: str = "cuda"):
    """A ("data",) mesh of one device: this rank's. Every rank of the
    default group calls it together (it makes the one-rank groups of all
    of them)."""
    from torch.distributed.device_mesh import DeviceMesh

    _world_size(device_type)
    group, _ = dist.new_subgroups(group_size=1)
    return DeviceMesh.from_group(group, device_type, mesh_dim_names=(AXIS_DATA,))


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh``, treating absent axes as 1."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def batch_sharding(mesh) -> list:
    """Placements for a batch-leading tensor: the leading dim split over
    every batch-like axis present in the mesh (in mesh order, so rank r's
    rows are the r-th block), trailing dims replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name in BATCH_AXES and mesh.size(i) > 1 else Replicate()
            for i, name in enumerate(mesh.mesh_dim_names)]
