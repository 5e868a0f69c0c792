"""Collective communication library (port of ray_tpu/util/collective.py).

Counterpart of ``ray.util.collective`` (init_collective_group,
allreduce, allgather, reducescatter, broadcast, send, recv, barrier).

This is the HOST plane, ray_tpu's ``backend="kv"`` design: ranks meet
through the head's KV store and exchange payloads through the object
store. It is for control-plane traffic between actors and tasks
(weights broadcast at start, metric reductions, barriers). The data
plane is elsewhere: ``ray_tpu_torch.parallel``'s collectives over
torch.distributed inside a program, and ``train.torch_utils``'s
gradient and parameter sync.

torch tensors are accepted beside numpy arrays: a tensor crosses as
host bytes (the object store's rule) and the result comes back on the
caller's device (the device of the tensor it passed). numpy in, numpy
out, as in ray_tpu.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np

from ray_tpu_torch._private.worker_context import global_runtime

_DEFAULT_GROUP = "default"
_groups: dict[str, "CollectiveGroup"] = {}


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _reduce_tensors(parts: list, op: str, device):
    """ray_tpu's numpy reductions over axis 0 of the stacked parts, in
    torch, on ``device`` (an integer mean is a float64 one, as numpy's)."""
    import torch

    out = torch.stack([torch.as_tensor(p).to(device) for p in parts])
    if op == "sum":
        return out.sum(dim=0)
    if op == "mean":
        if not (out.is_floating_point() or out.is_complex()):
            out = out.to(torch.float64)
        return out.mean(dim=0)
    if op == "max":
        return out.amax(dim=0)
    if op == "min":
        return out.amin(dim=0)
    raise ValueError(f"unknown reduce op {op!r}")


class CollectiveGroup:
    """One named world of `world_size` ranks; this process is `rank`."""

    def __init__(self, world_size: int, rank: int, group_name: str = _DEFAULT_GROUP):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.name = group_name
        self._seq: dict[str, int] = {}  # per-op-type sequence counters
        self._rt = global_runtime()
        # A re-created group (same name, new world) must not consume keys a
        # previous incarnation left behind: purge everything this rank ever
        # posted under this group name.
        suffix = f":{rank}"
        for key in self._rt.kv_keys(prefix=f"collective:{group_name}:", ns="__collective__"):
            if key.endswith(suffix):
                self._rt.kv_del(key, ns="__collective__")

    # --- rendezvous keys ---

    def _key(self, op: str, seq: int, rank: int) -> str:
        return f"collective:{self.name}:{op}:{seq}:{rank}"

    def _next_seq(self, op: str) -> int:
        seq = self._seq.get(op, 0)
        self._seq[op] = seq + 1
        return seq

    def _post(self, op: str, seq: int, value: Any, gc: bool = True) -> None:
        ref = self._rt.put(value)
        # Keep the payload alive until every rank consumed it: the KV holds
        # the ref hex; each consumer reads through a borrowed ref while this
        # owner's ref is pinned in _live until trimmed.
        self._live = getattr(self, "_live", [])
        self._live.append(ref)
        limit = max(4 * self.world_size, 128)
        if len(self._live) > limit:
            self._live = self._live[-limit // 2 :]
        self._rt.kv_put(self._key(op, seq, self.rank), ref.hex().encode(), ns="__collective__")
        # Lazy GC for ALL-BLOCKING ops only: by the time this rank reaches
        # seq, every rank consumed seq-2 of the same op, so our old key is
        # dead. Never applied to p2p (a receiver may lag arbitrarily; its
        # fetch deletes the key instead).
        if gc and seq >= 2:
            self._rt.kv_del(self._key(op, seq - 2, self.rank), ns="__collective__")

    def _fetch(self, op: str, seq: int, rank: int, timeout: float) -> Any:
        from ray_tpu_torch._private.ids import ObjectRef

        deadline = time.monotonic() + timeout
        key = self._key(op, seq, rank)
        while time.monotonic() < deadline:
            raw = self._rt.kv_get(key, ns="__collective__")
            if raw is not None:
                return self._rt.get(ObjectRef(raw.decode()), timeout=timeout)
            time.sleep(0.002)
        raise TimeoutError(f"collective {op} seq={seq}: rank {rank} missing after {timeout}s")

    # --- ops (API shape mirrors reference collective.py:268-625) ---

    def allreduce(self, tensor, op: str = "sum", timeout: float = 60.0):
        seq = self._next_seq("allreduce")
        if _is_tensor(tensor):
            self._post("allreduce", seq, tensor.detach())
            parts = [self._fetch("allreduce", seq, r, timeout) for r in range(self.world_size)]
            return _reduce_tensors(parts, op, tensor.device)
        self._post("allreduce", seq, np.asarray(tensor))
        parts = [self._fetch("allreduce", seq, r, timeout) for r in range(self.world_size)]
        out = np.stack(parts)
        if op == "sum":
            return out.sum(axis=0)
        if op == "mean":
            return out.mean(axis=0)
        if op == "max":
            return out.max(axis=0)
        if op == "min":
            return out.min(axis=0)
        raise ValueError(f"unknown reduce op {op!r}")

    def allgather(self, tensor, timeout: float = 60.0) -> list:
        seq = self._next_seq("allgather")
        if _is_tensor(tensor):
            self._post("allgather", seq, tensor.detach())
            return [self._fetch("allgather", seq, r, timeout).to(tensor.device)
                    for r in range(self.world_size)]
        self._post("allgather", seq, np.asarray(tensor))
        return [self._fetch("allgather", seq, r, timeout) for r in range(self.world_size)]

    def reducescatter(self, tensor, op: str = "sum", timeout: float = 60.0):
        """Each rank gets its 1/world_size shard of the reduction (axis 0)."""
        total = self.allreduce(tensor, op=op, timeout=timeout)
        if _is_tensor(total):
            import torch

            return torch.tensor_split(total, self.world_size, dim=0)[self.rank]
        shards = np.array_split(total, self.world_size, axis=0)
        return shards[self.rank]

    def broadcast(self, tensor, src: int = 0, timeout: float = 60.0):
        """``src``'s tensor on every rank. A rank that passes a tensor
        (any value: a receive buffer) gets the result on that tensor's
        device; one that passes None gets it as the store hands it back
        (a CUDA tensor lands on this process's current CUDA device)."""
        if _is_tensor(tensor):
            out = self.broadcast_object(tensor.detach(), src, timeout)
            import torch

            return torch.as_tensor(out).to(tensor.device)
        out = self.broadcast_object(
            None if tensor is None else np.asarray(tensor), src, timeout)
        return out if _is_tensor(out) else np.asarray(out)

    def broadcast_object(self, obj: Any, src: int = 0, timeout: float = 60.0) -> Any:
        """Broadcast any picklable object. All-blocking: every rank acks
        and the source waits for the acks (NCCL-style synchronous
        collective). This is load-bearing for GC, not just semantics —
        _post's lazy seq-2 deletion is only sound when no rank can run
        two sequences ahead of the slowest; a fire-and-forget source
        posting K broadcasts would delete keys a slow joiner (e.g. a
        worker still importing torch) has not read yet, deadlocking it."""
        seq = self._next_seq("broadcast")
        if self.rank == src:
            self._post("broadcast", seq, obj)
            out = obj
        else:
            out = self._fetch("broadcast", seq, src, timeout)
        self._post("broadcast_ack", seq, 0)
        for r in range(self.world_size):
            self._fetch("broadcast_ack", seq, r, timeout)
        return out

    def barrier(self, timeout: float = 60.0) -> None:
        self.allgather(np.zeros(1), timeout=timeout)

    def _p2p_seq(self, src: int, dst: int) -> int:
        # P2P sequencing is per (src, dst) pair — uninvolved ranks don't
        # advance it, so send/recv interleave freely with collectives.
        self._p2p = getattr(self, "_p2p", {})
        seq = self._p2p.get((src, dst), 0)
        self._p2p[(src, dst)] = seq + 1
        return seq

    def send(self, tensor, dst_rank: int, timeout: float = 60.0) -> None:
        seq = self._p2p_seq(self.rank, dst_rank)
        value = tensor.detach() if _is_tensor(tensor) else np.asarray(tensor)
        self._post(f"p2p:{self.rank}->{dst_rank}", seq, value, gc=False)

    def recv(self, src_rank: int, timeout: float = 60.0):
        """The next message from ``src_rank``; a CUDA tensor lands on this
        process's current CUDA device."""
        seq = self._p2p_seq(src_rank, self.rank)
        op = f"p2p:{src_rank}->{self.rank}"
        value = self._fetch(op, seq, src_rank, timeout)
        # Receiver-side GC: the message is consumed exactly once.
        self._rt.kv_del(self._key(op, seq, src_rank), ns="__collective__")
        return value


# --- module-level API (reference collective.py shape) ---


def init_collective_group(
    world_size: int, rank: int, backend: str = "kv", group_name: str = _DEFAULT_GROUP
) -> CollectiveGroup:
    """Call once per participant process (reference :123)."""
    group = CollectiveGroup(world_size, rank, group_name)
    _groups[group_name] = group
    return group


def get_group(group_name: str = _DEFAULT_GROUP) -> CollectiveGroup:
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized in this process")
    return _groups[group_name]


def destroy_collective_group(group_name: str = _DEFAULT_GROUP) -> None:
    _groups.pop(group_name, None)


def allreduce(tensor, group_name: str = _DEFAULT_GROUP, op: str = "sum"):
    return get_group(group_name).allreduce(tensor, op=op)


def allgather(tensor, group_name: str = _DEFAULT_GROUP):
    return get_group(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = _DEFAULT_GROUP, op: str = "sum"):
    return get_group(group_name).reducescatter(tensor, op=op)


def broadcast(tensor, src_rank: int = 0, group_name: str = _DEFAULT_GROUP):
    return get_group(group_name).broadcast(tensor, src=src_rank)


def barrier(group_name: str = _DEFAULT_GROUP):
    get_group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = _DEFAULT_GROUP):
    get_group(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = _DEFAULT_GROUP):
    return get_group(group_name).recv(src_rank)
