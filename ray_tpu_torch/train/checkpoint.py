"""Checkpoints: a directory of training state, tensor trees saved into it,
and top-k retention (port of ray_tpu/train/checkpoint.py).

``Checkpoint`` and ``CheckpointManager`` keep the reference's directory
layout, manifest, retention order, ``latest`` and ``best``.

``save_pytree``/``load_pytree`` write a format of their own (ray_tpu's
go through orbax, which the port does not use). A checkpoint of a tree
is a directory:

  tree.json         the tree's structure (dicts, lists, tuples, plain
                    values) and, per tensor leaf, its dtype, shape and,
                    for a DTensor, its placements and mesh shape;
  arrays.npz        the whole leaves, one array each;
  shards-<r>.npz    the DTensor leaves' shards that rank r owns, each
                    with the box of the global tensor it covers.

Every leaf keeps its bits: a dtype numpy has (float32, int32, bool, ...)
is stored as itself, any other (bfloat16, float8) as the signed integer
of its width, and read back through a view of the same width.

DTensor leaves are saved by shard: each rank writes the shards it holds,
and of the shards several ranks hold (a Replicate mesh dim), only the
rank at index 0 of those dims writes. Saving by shard needs no
collective but a barrier, where saving whole would gather every leaf
onto one rank: a leaf larger than one card's memory could not be saved,
and the gather is DTensor's all-gather, which ends gloo ranks holding
CUDA tensors (tests/gloo_cuda_report.py). A load reads the boxes of a
leaf, joins them on the host and keeps the part the target's placement
gives this rank, so a checkpoint restores into any placement on any
mesh, or whole.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

_TREE = "tree.json"
_WHOLE = "arrays.npz"
_SHARDS = "shards-{:05d}.npz"
_FORMAT = 1


class Checkpoint:
    """A directory of training state."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    def to_directory(self, dest: str | None = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        if os.path.abspath(dest) != os.path.abspath(self.path):
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    def as_directory(self):
        """Context manager yielding a readable directory path."""

        @contextlib.contextmanager
        def _ctx():
            yield self.path

        return _ctx()

    def __repr__(self):
        return f"Checkpoint({self.path})"

    # --- tensor tree helpers ---

    def save_pytree(self, state: Any, name: str = "state") -> None:
        save_pytree(state, os.path.join(self.path, name))

    def load_pytree(self, target: Any = None, name: str = "state", *,
                    device="cuda") -> Any:
        return load_pytree(os.path.join(self.path, name), target, device=device)


# -- the tree format --------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _encode(node, leaves: list):
    """The JSON structure of ``node``; its tensors appended to ``leaves``."""
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        return {"leaf": len(leaves) - 1}
    if isinstance(node, dict):
        if not all(isinstance(k, str) for k in node):
            raise TypeError(f"a saved dict's keys must be strings: {list(node)}")
        return {"dict": {k: _encode(v, leaves) for k, v in node.items()}}
    if isinstance(node, tuple):  # NamedTuples too (restored as the target's)
        return {"tuple": [_encode(v, leaves) for v in node]}
    if isinstance(node, list):
        return {"list": [_encode(v, leaves) for v in node]}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"cannot save a {type(node).__name__} in a tensor tree")


# The dtypes numpy holds as they are; any other is stored as the signed
# integer of its width and read back through a view.
_NUMPY = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64,
          torch.float16, torch.float32, torch.float64, torch.complex64, torch.complex128)
_INT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s bits on the host."""
    t = t.detach().cpu().contiguous()
    return (t if t.dtype in _NUMPY else t.view(_INT[t.element_size()])).numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype, shape) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))  # (at least 1-D)
    return (t if t.dtype == dtype else t.view(dtype)).reshape(shape)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _shard_box(shape, placements, coordinate, mesh_shape) -> list[list[int]]:
    """[lo, hi) per dim of the part of a tensor of global ``shape`` that the
    rank at ``coordinate`` holds under ``placements`` (torch.chunk's split,
    mesh dims applied in order, as DTensor lays out Shard)."""
    from torch.distributed.tensor import Shard

    box = [[0, n] for n in shape]
    for p, c, n in zip(placements, coordinate, mesh_shape):
        if isinstance(p, Shard):
            lo, hi = box[p.dim]
            step = -(-(hi - lo) // n)
            box[p.dim] = [min(lo + c * step, hi), min(lo + (c + 1) * step, hi)]
    return box


def _placement_record(p) -> list:
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(p, Shard):
        return ["shard", p.dim]
    if isinstance(p, Replicate):
        return ["replicate"]
    raise ValueError(f"cannot save a DTensor with placement {p}: reduce it first")


def _sharded_record(t, i: int, shards: dict) -> dict:
    """The leaf record of DTensor ``t``, adding this rank's shard to
    ``shards`` when the rank owns it."""
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    coordinate = mesh.get_coordinate()
    mesh_shape = list(mesh.shape)
    record = {"dtype": _dtype_name(t.dtype), "shape": list(t.shape),
              "placements": [_placement_record(p) for p in t.placements],
              "mesh_shape": mesh_shape}
    if coordinate is None:  # this rank is not on the leaf's mesh
        return record
    owner = all(c == 0 for p, c in zip(t.placements, coordinate)
                if isinstance(p, Replicate))
    if owner:
        box = _shard_box(t.shape, t.placements, coordinate, mesh_shape)
        local = t.to_local()
        if list(local.shape) != [hi - lo for lo, hi in box]:
            raise ValueError(f"leaf {i}: local shard {tuple(local.shape)} is not the "
                             f"box {box} of its placement {t.placements}")
        shards[str(i)] = _to_numpy(local)
        shards[f"{i}.box"] = np.asarray(box, np.int64).reshape(-1, 2)
    return record


def _collective(leaves) -> bool:
    """Whether saving these leaves is a call every rank makes together: a
    tree holding DTensors is saved by all of their ranks at once."""
    import torch.distributed as dist

    return dist.is_initialized() and any(_is_dtensor(t) for t in leaves)


def save_pytree(state: Any, path: str) -> None:
    """Save a tree of tensors (nested dicts, lists and tuples; plain values
    kept as they are) into directory ``path``, replacing it. A tree holding
    DTensors is saved by every rank of the default process group together,
    each writing the shards it owns; otherwise the call is the caller's own."""
    import torch.distributed as dist

    path = os.path.abspath(path)
    leaves: list = []
    tree = _encode(state, leaves)
    collective = _collective(leaves)
    lead = not collective or dist.get_rank() == 0
    if lead:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
    if collective:
        dist.barrier()
    records, whole, shards = [], {}, {}
    for i, t in enumerate(leaves):
        if _is_dtensor(t):
            records.append(_sharded_record(t, i, shards))
        else:
            records.append({"dtype": _dtype_name(t.dtype), "shape": list(t.shape)})
            whole[str(i)] = _to_numpy(t)
    if shards:
        np.savez(os.path.join(path, _SHARDS.format(dist.get_rank())), **shards)
    if lead:
        np.savez(os.path.join(path, _WHOLE), **whole)
        with open(os.path.join(path, _TREE), "w") as f:
            json.dump({"format": _FORMAT, "tree": tree, "leaves": records}, f)
    if collective:
        dist.barrier()


class _Reader:
    """The leaves of a saved tree, each read on first use."""

    def __init__(self, path: str):
        with open(os.path.join(path, _TREE)) as f:
            meta = json.load(f)
        if meta.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a tree checkpoint of format {_FORMAT}")
        self.tree, self.records = meta["tree"], meta["leaves"]
        self.whole = np.load(os.path.join(path, _WHOLE))
        self.shards = [np.load(f) for f in sorted(glob.glob(os.path.join(path, "shards-*.npz")))]

    def leaf(self, i: int) -> torch.Tensor:
        """Leaf ``i`` whole, on the host."""
        rec = self.records[i]
        dtype = getattr(torch, rec["dtype"])
        if "placements" not in rec:
            return _from_numpy(self.whole[str(i)], dtype, rec["shape"])
        parts = [(z[str(i)], z[f"{i}.box"]) for z in self.shards if str(i) in z.files]
        if not parts:
            raise ValueError(f"leaf {i}: no rank's shards were saved")
        full = np.empty(rec["shape"], parts[0][0].dtype)
        covered = 0
        for part, box in parts:
            full[tuple(slice(lo, hi) for lo, hi in box)] = part
            covered += part.size
        if covered != full.size:
            raise ValueError(f"leaf {i}: the saved shards cover {covered} of "
                             f"{full.size} elements")
        return _from_numpy(full, dtype, rec["shape"])

    def close(self):
        for z in [self.whole, *self.shards]:
            z.close()


def _place(value: torch.Tensor, like):
    """``value`` (whole, on the host) laid out as ``like`` is: the same
    device and, for a DTensor, this rank's part of its placements."""
    if tuple(value.shape) != tuple(like.shape):
        raise ValueError(f"a saved leaf of shape {tuple(value.shape)} cannot restore "
                         f"a leaf of shape {tuple(like.shape)}")
    if _is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor

        mesh = like.device_mesh
        return distribute_tensor(value.to(mesh.device_type), mesh, like.placements,
                                 src_data_rank=None)
    return value.to(like.device)


def _restore(node: dict, reader: _Reader, target, device):
    """The saved structure ``node`` rebuilt, each leaf placed as its
    counterpart in ``target`` (or on ``device`` without one)."""
    kind, body = next(iter(node.items()))
    if kind == "leaf":
        value = reader.leaf(body)
        return value.to(device) if target is None else _place(value, target)
    if kind == "value":
        return body
    if kind == "dict":
        if target is not None and (not isinstance(target, dict) or set(target) != set(body)):
            held = sorted(target) if isinstance(target, dict) else type(target).__name__
            raise ValueError(f"the target ({held}) does not hold the saved keys {sorted(body)}")
        return {k: _restore(v, reader, None if target is None else target[k], device)
                for k, v in body.items()}
    if target is not None and len(target) != len(body):
        raise ValueError(f"the target holds {len(target)} entries where {len(body)} were saved")
    items = [_restore(v, reader, None if target is None else target[j], device)
             for j, v in enumerate(body)]
    if kind == "list":
        return items
    if target is not None and hasattr(target, "_fields"):  # a NamedTuple
        return type(target)(*items)
    return tuple(items)


def load_pytree(path: str, target: Any = None, *, device="cuda") -> Any:
    """The tree saved in ``path``. With ``target`` (a tree of the same
    structure), each leaf is placed as the target's is: on its device, and
    a DTensor target leaf as this rank's part of its placements on its
    mesh; NamedTuples come back as the target's types. Without, every leaf
    comes back whole on ``device``. Leaves keep their saved dtypes."""
    reader = _Reader(os.path.abspath(path))
    try:
        return _restore(reader.tree, reader, target, device)
    finally:
        reader.close()


class CheckpointManager:
    """Top-k retention over a storage directory."""

    def __init__(
        self,
        storage_path: str,
        num_to_keep: int | None = None,
        score_attribute: str | None = None,
        score_order: str = "max",
    ):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._records: list[dict] = []  # {path, score, index, metrics}
        self._index = 0
        os.makedirs(storage_path, exist_ok=True)

    def register(self, checkpoint_dir: str, metrics: dict | None = None) -> Checkpoint:
        """Move a freshly written checkpoint into managed storage."""
        metrics = metrics or {}
        dest = os.path.join(self.storage_path, f"checkpoint_{self._index:06d}")
        if os.path.abspath(checkpoint_dir) != dest:
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.move(checkpoint_dir, dest)
        score = metrics.get(self.score_attribute) if self.score_attribute else None
        self._records.append(
            {"path": dest, "score": score, "index": self._index, "metrics": metrics}
        )
        self._index += 1
        self._save_manifest()
        self._enforce_retention()
        return Checkpoint(dest)

    def _enforce_retention(self) -> None:
        if self.num_to_keep is None or len(self._records) <= self.num_to_keep:
            return
        # Keep the best k by score; unscored checkpoints rank below every
        # scored one (they survive only while fewer than k are scored), and
        # the later one wins a tie.
        def sort_key(r):
            if r["score"] is None:
                return (0, 0.0, r["index"])
            value = r["score"] if self.score_order == "max" else -r["score"]
            return (1, value, r["index"])

        ranked = sorted(self._records, key=sort_key, reverse=True)
        keep = set(id(r) for r in ranked[: self.num_to_keep])
        for r in list(self._records):
            if id(r) not in keep:
                shutil.rmtree(r["path"], ignore_errors=True)
                self._records.remove(r)
        self._save_manifest()

    def _save_manifest(self) -> None:
        manifest = [
            {k: v for k, v in r.items() if k != "metrics"} | {"metrics": r["metrics"]}
            for r in self._records
        ]
        with open(os.path.join(self.storage_path, "manifest.json"), "w") as f:
            json.dump(manifest, f, default=str)

    @property
    def latest(self) -> Checkpoint | None:
        if not self._records:
            return None
        return Checkpoint(max(self._records, key=lambda r: r["index"])["path"])

    @property
    def best(self) -> Checkpoint | None:
        if not self._records:
            return None
        scored = [r for r in self._records if r["score"] is not None]
        if not scored:
            return self.latest
        best = (max if self.score_order == "max" else min)(scored, key=lambda r: r["score"])
        return Checkpoint(best["path"])
