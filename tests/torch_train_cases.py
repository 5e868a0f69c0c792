"""The port's side of tests/test_torch_train_backend.py: what each rank of
a gloo CPU group runs, spawned by ray_tpu_torch.parallel._spawn. This
module imports no JAX (the children must not load XLA): inputs arrive as
numpy arrays made by the test from seeds, results go back as numpy."""

from __future__ import annotations

import os

import numpy as np
import torch

from ray_tpu_torch.train import load_pytree, save_pytree, torch_utils
from ray_tpu_torch.train.session import TrainSession, set_session


def _tree(arrays, dtypes):
    """numpy leaves as tensors of the named dtypes (bf16 leaves arrive as
    float32 arrays holding bf16 values exactly)."""
    return {k: (_tree(v, dtypes[k]) if isinstance(v, dict)
                else torch.from_numpy(np.asarray(v)).to(getattr(torch, dtypes[k])))
            for k, v in arrays.items()}


def _bits(tree):
    """Leaves as numpy, bf16 as its int16 view (bit for bit)."""
    return {k: (_bits(v) if isinstance(v, dict) else
                (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy())
            for k, v in tree.items()}


def sync(rank, world, per_rank, dtypes):
    """sync_model_params on rank-specific params: rank 0's on every rank."""
    set_session(TrainSession(rank, world, rank, experiment_name="sync"))
    try:
        return _bits(torch_utils.sync_model_params(_tree(per_rank[rank], dtypes)))
    finally:
        set_session(None)


def named_group(rank, world, per_rank, dtypes):
    """The helpers under the name TorchBackend.on_worker_setup registered
    the run's group by; an unknown name and a non-str are refused."""
    from ray_tpu_torch.train import TorchBackend, TorchConfig

    TorchBackend().on_worker_setup(rank, world, "run-group",
                                   TorchConfig(distributed="off", collective_group=False,
                                               device="cpu"))
    set_session(TrainSession(rank, world, rank, experiment_name="named",
                             group_name="run-group"))
    try:
        tree = _tree(per_rank[rank], dtypes)
        out = {"sync": _bits(torch_utils.sync_model_params(tree, "run-group")),
               "sum": _bits(torch_utils.allreduce_gradients(tree, "run-group", op="sum"))}
        torch_utils.barrier("run-group")
        for fn, args in ((torch_utils.sync_model_params, (tree,)),
                         (torch_utils.allreduce_gradients, (tree,)), (torch_utils.barrier, ())):
            for name, err in (("no-such-group", ValueError), (7, TypeError)):
                try:
                    fn(*args, name)
                except err as e:
                    out[f"{fn.__name__}-{type(e).__name__}"] = str(e)
        return out
    finally:
        set_session(None)


def allreduce(rank, world, per_rank, dtypes, op):
    """allreduce_gradients of this rank's gradients; then a barrier."""
    set_session(TrainSession(rank, world, rank, experiment_name="grads"))
    try:
        out = torch_utils.allreduce_gradients(_tree(per_rank[rank], dtypes), op=op)
        torch_utils.barrier()
        return _bits(out)
    finally:
        set_session(None)


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if n == "R" else Shard(int(n[1:])) for n in names]


def checkpoint(rank, world, path, leaves, save_as, load_as):
    """DTensor leaves on a (data 2, tensor 2) mesh saved by shard with
    placements ``save_as`` ({leaf: ["S0", "R"]...}), then restored into
    ``load_as``: [(mesh shape, {leaf: placements})] (a 1-D mesh is ("data",)
    over all ranks), and whole without a target. Returns each restore's
    local shards (bits) beside the target's, which distribute_tensor laid
    out from the same leaves, and the whole tree."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.parallel import MeshConfig

    def place(mesh, layout):
        return {k: distribute_tensor(torch.from_numpy(leaves[k]).to(getattr(torch, dt)), mesh,
                                     _placements(p), src_data_rank=None)
                for k, (dt, p) in layout.items()}

    mesh = MeshConfig(data=2, tensor=2).build("cpu")
    state = {"params": place(mesh, save_as), "step": torch.tensor(7, dtype=torch.int32),
             "lr": 0.5}
    save_pytree(state, path)
    out = {}
    for i, (shape, layout) in enumerate(load_as):
        target_mesh = (MeshConfig(data=2, tensor=2) if len(shape) == 2 else
                       MeshConfig(data=shape[0])).build("cpu")
        target = {"params": place(target_mesh, layout), "step": torch.tensor(0, dtype=torch.int32),
                  "lr": 0.0}
        got = load_pytree(path, target)
        out[f"load{i}"] = {"params": _bits({k: t.to_local() for k, t in got["params"].items()}),
                           # DTensor's own layout of the leaves, for the test.
                           "want": _bits({k: t.to_local() for k, t in target["params"].items()}),
                           "placements": {k: [repr(p) for p in t.placements]
                                          for k, t in got["params"].items()},
                           "step": got["step"].numpy(), "lr": got["lr"]}
    whole = load_pytree(path, device="cpu")
    out["whole"] = {"params": _bits(whole["params"]), "step": whole["step"].numpy()}
    out["files"] = sorted(os.listdir(path))
    return out


def run(rank, world, cases):
    """Every case in ``cases`` ({name: (function name, kwargs)}), in order,
    on this rank: {name: result}. Each rank takes its share of the cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return {name: globals()[fn](rank, world, **kwargs) for name, (fn, kwargs) in cases.items()}
