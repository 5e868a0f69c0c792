"""Zero-copy data plane: shared helpers for payload movement.

Counterpart of the reference's plasma + push/pull-manager layer
(reference: src/ray/object_manager/push_manager.h:32, pull_manager.h:57,
plasma/store.h:55): payload bytes move peer-to-peer
over the bulk plane (or not at all, for host-colocated readers) while
the control plane carries metadata-only seals.

This module holds the pieces every layer shares:

  * ``enabled()`` — the RAY_TPU_DATA_PLANE=0 kill switch. Off, workers
    fall back to the PR-era behavior (payloads stored through the head
    paths, owners resolve via head metas, no device cache).
  * Transfer accounting — ``record(path, nbytes)`` counters behind
    ``ray_tpu_object_bytes_transferred_total{path=...}``. Paths:
      p2p       bytes pulled from a primary holder over the bulk plane
      relay     bytes pulled from a relay (replica) source
      local     bytes read from a host-mapped arena (no network)
      zero_copy bytes served as aliasing views (no host copy at all)
      inline    payload bytes that rode control-plane frames
      spill     bytes restored from external storage
      handoff   KV pages moved prefill→decode (LLM disaggregation);
                always copies=0 — the record is resolved via the same
                local/p2p machinery, this path just sizes the handoff
    ``host_copies`` counts host-side payload copies on the read path —
    the structural guard that a large result reaches the caller with at
    most ONE copy end to end.
  * ``host_id()`` — boot-scoped host identity: two "nodes" (simulated
    or real) sharing it share physical RAM, so readers may map the
    holder's arena directly instead of pulling bytes through a socket.
  * ``array_meta(value)`` — dtype/shape (+ the device type for a
    torch tensor) stamped into metadata-only seals so consumers can
    reason about a tensor result without ever deserializing the
    payload.
  * ``DeviceCache`` — the colocated fast path: a bounded cache of
    CUDA tensor results keyed by object id. A get() in the producing
    process returns a device-side copy of the cached tensor — no
    device→host→device round trip.
  * ``rematerialize(value, meta)`` — the cross-node half: a pulled
    result whose producer returned a CUDA tensor goes back onto the
    reader's current CUDA device.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any

_TRANSFER_PATHS = ("p2p", "relay", "local", "zero_copy", "inline", "spill",
                   "handoff")


def enabled() -> bool:
    """Master kill switch (read per call — tests flip the env var)."""
    return os.environ.get("RAY_TPU_DATA_PLANE", "1").lower() not in (
        "0", "false", "no")


# ---------------------------------------------------------------------------
# transfer accounting

# Mutated with GIL-atomic ops only (dict __setitem__ on str keys) — the
# hot path never takes a lock; snapshots copy atomically via dict().
_bytes: dict[str, int] = {}
_copies: dict[str, int] = {}


def record(path: str, nbytes: int, copies: int = 1) -> None:
    """One payload movement of ``nbytes`` over ``path`` costing
    ``copies`` host-side copies (0 for aliasing zero-copy reads)."""
    _bytes[path] = _bytes.get(path, 0) + int(nbytes)
    if copies:
        _copies[path] = _copies.get(path, 0) + int(copies)


def counters() -> dict:
    """Snapshot: {"bytes": {path: n}, "host_copies": {path: n}}."""
    return {"bytes": dict(_bytes), "host_copies": dict(_copies)}


def reset_counters() -> None:
    """Tests only."""
    _bytes.clear()
    _copies.clear()


# ---------------------------------------------------------------------------
# host identity

_host_id: "str | None" = None


def host_id() -> str:
    """Boot-scoped host identity: processes sharing it share physical
    memory (and /dev/shm), so arenas are cross-mappable between them.
    Containers with private /dev/shm also get distinct ids via the
    shm namespace device stamp."""
    global _host_id
    if _host_id is None:
        boot = ""
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                boot = f.read().strip()
        except OSError:
            boot = "no-boot-id"
        try:
            st = os.stat("/dev/shm")
            boot += f":{st.st_dev}:{st.st_ino}"
        except OSError:
            pass
        _host_id = boot
    return _host_id


# ---------------------------------------------------------------------------
# tensor seal metadata

def array_meta(value: Any) -> "dict | None":
    """Metadata-only description of a top-level tensor result: consumers
    of a metadata seal learn dtype/shape (+ the device type of a torch
    tensor) without deserializing the payload. None for non-tensor
    values. Never imports numpy/torch into a process that hasn't
    already."""
    mods = sys.modules
    np = mods.get("numpy")
    if np is not None and isinstance(value, np.ndarray):
        return {"kind": "ndarray", "dtype": str(value.dtype),
                "shape": tuple(value.shape)}
    torch = mods.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return {"kind": "torch",
                "dtype": str(value.dtype).removeprefix("torch."),
                "shape": tuple(value.shape), "device": value.device.type}
    if isinstance(value, (bytes, bytearray)):
        return {"kind": "bytes", "shape": (len(value),)}
    return None


def device_resident(meta: "dict | None") -> bool:
    """Whether array_meta describes a CUDA tensor (the results the
    DeviceCache keeps and rematerialize puts back on a device)."""
    return bool(meta) and meta.get("kind") == "torch" \
        and meta.get("device") == "cuda"


def rematerialize(value: Any, meta: "dict | None") -> Any:
    """Cross-node device fast path: a result pulled over the data plane
    goes back onto the reader's current CUDA device when the seal
    metadata says the producer returned a CUDA tensor and the reader
    has a device. dtype/shape ride the deserialized tensor itself.
    (The serializer already does this for a top-level CUDA tensor;
    this covers a seal whose payload did not say so.)"""
    torch = sys.modules.get("torch")
    if (not device_resident(meta) or torch is None
            or not isinstance(value, torch.Tensor) or value.is_cuda
            or not torch.cuda.is_available()):
        return value
    return value.to(torch.device("cuda", torch.cuda.current_device()))


# ---------------------------------------------------------------------------
# colocated device-result cache

class DeviceCache:
    """Bounded LRU of device-resident results keyed by object id.

    The producing process keeps a device-side copy of a large CUDA
    tensor result alongside the serialized copy it stored for remote
    readers; a colocated get() returns a device-side copy of it — zero
    device→host→device round trips. Entries retire on LRU pressure
    (count and byte bounds) and when the cluster frees the object.
    Tensors are mutable (jax.Arrays, which ray_tpu caches, are not), so
    both ends copy on the device: the producer's later in-place writes
    and a reader's writes reach neither the cache nor another reader,
    exactly as with a fresh deserialization."""

    def __init__(self, max_entries: int, max_bytes: int):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "dict[str, tuple[Any, int]]" = {}
        self._bytes = 0
        self.hits = 0

    def put(self, hex_id: str, value: Any, nbytes: int) -> None:
        if self.max_entries <= 0 or nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(hex_id, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[hex_id] = (value.clone(), nbytes)
            self._bytes += nbytes
            while self._entries and (len(self._entries) > self.max_entries
                                     or self._bytes > self.max_bytes):
                oldest = next(iter(self._entries))
                if oldest == hex_id and len(self._entries) == 1:
                    break  # never evict the entry just inserted
                _v, b = self._entries.pop(oldest)
                self._bytes -= b

    def get(self, hex_id: str) -> Any:
        with self._lock:
            ent = self._entries.pop(hex_id, None)
            if ent is None:
                return None
            # Move-to-back keeps the LRU order honest on dict pop/insert.
            self._entries[hex_id] = ent
            self.hits += 1
            return ent[0].clone()

    def pop(self, hex_id: str) -> None:
        with self._lock:
            ent = self._entries.pop(hex_id, None)
            if ent is not None:
                self._bytes -= ent[1]

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "hits": self.hits}
