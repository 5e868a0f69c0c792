"""Multi-slice meshes (port of ray_tpu/parallel/multislice.py).

ray_tpu's slice is one ICI torus; going bigger means several slices
whose only link is the data-center network. Here a slice is a host: the
ranks of one machine talk over NVLink, hosts over the network. The
recipe is the same, hierarchical parallelism:

- a ``dcn`` mesh axis spans slices — put DATA parallelism there: one
  gradient all-reduce per step crosses the thin link;
- every other axis (fsdp/tensor/sequence/expert) stays INSIDE a slice.

``build_multislice_mesh`` lays the ranks out so (the ``dcn`` axis
outermost, each slice's ranks contiguous in it). On a single host there
is no slice information, and the ranks are split into ``num_slices``
contiguous groups — the simulation the CPU tests use.

Usage:

    mesh = build_multislice_mesh(num_slices=2, per_slice=MeshConfig(
        fsdp=2, tensor=2))
    # dims: ("dcn", "fsdp", "tensor") — shard batch over ("dcn", "fsdp"),
    # params over fsdp/tensor.
"""

from __future__ import annotations

import socket

import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import BATCH_AXES, MeshConfig, _axes, _device_mesh, _world_size

AXIS_DCN = "dcn"


def _hosts() -> list:
    """The host name of every rank of the default group, in rank order."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts


def detect_num_slices() -> int:
    """Distinct hosts among the default group's ranks (1 on one host, or
    with no group)."""
    if not dist.is_initialized():
        return 1
    return max(1, len(set(_hosts())))


def build_multislice_mesh(num_slices: int | None = None,
                          per_slice: MeshConfig | None = None,
                          device_type: str = "cuda"):
    """A DeviceMesh whose leading ``dcn`` axis spans slices and whose
    remaining axes factor each slice's ranks per ``per_slice``.

    Across hosts, each host is a slice and its ranks lie contiguous along
    the other axes (ranks ordered by host, then by rank). On one host the
    ranks are split into ``num_slices`` contiguous groups.
    """
    world = _world_size(device_type)
    hosts = _hosts()
    real = sorted(set(hosts))
    if num_slices is None:
        num_slices = len(real)
    if world % num_slices:
        raise ValueError(f"{world} devices not divisible into {num_slices} slices")
    if len(real) > 1 and len(real) != num_slices:
        # Splitting hosts would lay per-layer axes across the network.
        raise ValueError(
            f"requested {num_slices} slices but the ranks span {len(real)} "
            f"hosts ({real}); pass num_slices=None to use the detected count")
    per_slice = per_slice or MeshConfig()
    names, ici_shape = _axes(per_slice.resolve(world // num_slices), per_slice.axis_order)
    ranks = None
    if len(real) > 1:
        ranks = sorted(range(world), key=lambda r: (real.index(hosts[r]), r))
    return _device_mesh(device_type, (AXIS_DCN,) + names, (num_slices,) + ici_shape, ranks)


def multislice_batch_axes(mesh) -> tuple:
    """Axes a global batch dimension shards over in a multi-slice mesh:
    the dcn axis (data parallel across slices) plus the usual batch-like
    axes."""
    names = tuple(mesh.mesh_dim_names)
    present = tuple(a for a in (AXIS_DCN,) + BATCH_AXES
                    if a in names and mesh.size(names.index(a)) > 1)
    return present or (AXIS_DCN,)


def dcn_allreduce_axes(mesh) -> tuple:
    """Axes gradients reduce over for hierarchical DP: the batch axes of
    ``multislice_batch_axes``. DTensor reduces a gradient over each mesh
    dim it is partial on, the dcn dim included."""
    return multislice_batch_axes(mesh)
