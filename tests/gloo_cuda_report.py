"""Which collectives a gloo process group takes on CUDA tensors here.

    PYTHONPATH=. python3 tests/gloo_cuda_report.py     # from the repo root

Two ranks share card 0 over gloo (NCCL will not put two ranks on one
GPU). Each collective that the sharded paths of ray_tpu_torch use (and
DTensor's redistributions on a 2-rank ``cuda`` mesh) runs once on small
CUDA tensors, in a process group of its own, since a transport that
reads a device pointer as host memory ends the process; its result is
checked against the value it must have. Then the DTensor calls in an
NCCL group of one. One JSON line each: {"op": ..., "backend": ...,
"world": ..., "ok": true/false, "error": ...}. It needs a CUDA card.
Its readings decide which world-size-2 cases ``chip_smoke.py`` runs on
one card (phase 7 (b)); PERF.md keeps them.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import _spawn


def _ops(rank, world):
    """name -> a check that runs one collective on CUDA tensors and says
    whether its result is the value it must have."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    dev = torch.device("cuda", 0)
    ones = lambda n: torch.ones(n, device=dev) * (rank + 1)  # noqa: E731
    seq = lambda *v: torch.tensor([float(x) for x in v])  # noqa: E731

    def all_reduce():
        t = ones(4)
        dist.all_reduce(t)
        return torch.equal(t.cpu(), torch.full((4,), 3.0))

    def broadcast():
        t = ones(4)
        dist.broadcast(t, src=1)
        return torch.equal(t.cpu(), torch.full((4,), 2.0))

    def all_gather():
        out = [torch.empty(2, device=dev) for _ in range(world)]
        dist.all_gather(out, ones(2))
        return torch.equal(torch.cat(out).cpu(), seq(1, 1, 2, 2))

    def all_gather_into_tensor():
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, ones(2))
        return torch.equal(out.cpu(), seq(1, 1, 2, 2))

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, ones(4))
        return torch.equal(out.cpu(), torch.full((2,), 3.0))

    def scatter():
        out = torch.empty(2, device=dev)
        src = [torch.full((2,), float(r), device=dev) for r in range(world)]
        dist.scatter(out, src if rank == 0 else None, src=0)
        return torch.equal(out.cpu(), torch.full((2,), float(rank)))

    def all_to_all_single():
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, ones(4))
        return torch.equal(out.cpu(), seq(1, 1, 2, 2))

    def batch_isend_irecv():
        send = torch.full((4,), float(rank), device=dev)
        recv = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return torch.equal(recv.cpu(), torch.full((4,), float((rank - 1) % world)))

    def mesh():
        return init_device_mesh("cuda", (world,), mesh_dim_names=("data",))

    full = torch.arange(4.0 * world, device=dev).reshape(2 * world, 2)

    def dtensor_distribute_shard():  # no transfer: each rank keeps its chunk
        d = distribute_tensor(full, mesh(), [Shard(0)], src_data_rank=None)
        return torch.equal(d.to_local().cpu(), full.cpu().chunk(world)[rank])

    def functional_all_gather_tensor():  # what DTensor's Shard -> Replicate calls
        from torch.distributed import _functional_collectives as funcol

        out = funcol.all_gather_tensor(ones(2), 0, dist.group.WORLD)
        return torch.equal(funcol.wait_tensor(out).cpu(), seq(1, 1, 2, 2))

    def dtensor_shard_to_replicate():
        d = DTensor.from_local(full.chunk(world)[rank].contiguous(), mesh(), [Shard(0)],
                               run_check=False)
        return torch.equal(d.redistribute(d.device_mesh, [Replicate()]).to_local().cpu(),
                           full.cpu())

    def dtensor_partial_to_replicate():
        d = DTensor.from_local(full, mesh(), [Partial()], run_check=False)
        return torch.equal(d.redistribute(d.device_mesh, [Replicate()]).to_local().cpu(),
                           (full * world).cpu())

    def dtensor_partial_to_shard():
        d = DTensor.from_local(full, mesh(), [Partial()], run_check=False)
        local = d.redistribute(d.device_mesh, [Shard(0)]).to_local().cpu()
        return torch.equal(local, (full * world).cpu().chunk(world)[rank])

    return {f.__name__: f for f in (
        all_reduce, broadcast, all_gather, all_gather_into_tensor, reduce_scatter_tensor,
        scatter, all_to_all_single, batch_isend_irecv, dtensor_distribute_shard,
        functional_all_gather_tensor, dtensor_shard_to_replicate,
        dtensor_partial_to_replicate, dtensor_partial_to_shard)}


def _one(rank, world, name):
    torch.cuda.set_device(0)
    return bool(_ops(rank, world)[name]())


OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "scatter", "all_to_all_single", "batch_isend_irecv",
       "dtensor_distribute_shard", "functional_all_gather_tensor",
       "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
       "dtensor_partial_to_shard")


def _row(op, backend, world):
    """One op in a group of its own (a crash ends only that group)."""
    try:
        ok = all(_spawn.run(_one, world, op, backend=backend, timeout=90))
        return {"op": op, "backend": backend, "world": world, "ok": ok,
                "error": None if ok else "wrong result"}
    except (RuntimeError, TimeoutError) as e:
        return {"op": op, "backend": backend, "world": world, "ok": False,
                "error": str(e).strip().splitlines()[-1][:300]}


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_report: no CUDA device", file=sys.stderr)
        return 1
    import inspect

    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0),
                      "local_map": str(inspect.signature(local_map)),
                      "distribute_tensor": str(inspect.signature(distribute_tensor))}))
    rows = [_row(op, "gloo", 2) for op in OPS]
    rows += [_row(op, "nccl", 1) for op in OPS if op.startswith("dtensor_")]
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
