"""Device-resident DAG edges over CUDA IPC (the counterpart of
ray_tpu/experimental/device_channel.py).

ray_tpu keeps a ``with_tensor_transport("device")`` edge's arrays on the
TPU by serving them from the writer's ``jax.experimental.transfer``
server and pulling them into the reader's device. On the GPU the same
edge is CUDA IPC: the writer exports each CUDA tensor's allocation as an
IPC memory handle, the reader maps it and copies device to device into
an allocation of its own. Only a descriptor crosses the host META
channel (the shm or TCP ring underneath): a uid, the host, and per
tensor its device's UUID, shape, stride, dtype, the memory handle and
an interprocess event; the non-tensor leaves ride in it as they are.

    writer.write(tree_with_cuda_tensors)
      -> per device, an interprocess event recorded on the producing
         stream; per tensor, an IPC memory handle of its allocation
      -> the descriptor written to the meta channel
    reader.begin_read()
      -> the descriptor read from the meta channel
      -> per tensor: the handle opened, the event waited on by the
         reader's current stream, a device-to-device copy into an
         allocation made on that stream; the copies synchronised before
         begin_read returns, so end_read (the ack) comes after the
         reader is done with the writer's memory

The copy runs on the stream the reader's own code runs on: the caching
allocator ties a block to the stream that allocated it, so a received
tensor the consumer drops goes back to the pool only after that stream's
work on it, and the next message's copy, ordered on the same stream,
cannot overwrite memory a kernel of the consumer still reads.

Lifetime: the writer holds each message's tensors and events until the
meta ring hands that message's slot back, which the next write into the
slot proves (its write-acquire waits for every reader's release): the
same guarantee as ray_tpu's ``await_pull``, with no extra channel.

Devices are named by UUID: two processes with different
``CUDA_VISIBLE_DEVICES`` both call one card ``cuda:0``, so the reader
maps the descriptor's UUID to its own index. A tensor whose export or
open fails, a device the reader cannot see and a reader on another host
(CUDA IPC is same-host, as ray_tpu's localhost-bound transfer server)
raise; nothing falls back to a host copy. CPU tensors cross as host
bytes in the slot (the plain version of the edge).

Capacity, backpressure and teardown ride the meta channel's ring.
"""

from __future__ import annotations

import collections
import copy
import threading
from typing import Any

_lock = threading.Lock()
_host: "str | None" = None


def _host_id() -> str:
    """This machine and boot: a reader with another id is on another
    host, where the writer's IPC handles mean nothing."""
    global _host
    if _host is None:
        import socket

        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                boot = f.read().strip()
        except OSError:
            boot = ""
        _host = f"{socket.gethostname()}/{boot}"
    return _host


def _device_uuid(index: int) -> str:
    import torch

    return str(torch.cuda.get_device_properties(index).uuid)


def _local_index(device_uuid: str) -> int:
    """This process's index of the card named ``device_uuid``."""
    import torch

    for i in range(torch.cuda.device_count()):
        if _device_uuid(i) == device_uuid:
            return i
    raise RuntimeError(
        f"device edge: the writer's card {device_uuid} is not visible here "
        f"({torch.cuda.device_count()} visible devices, "
        f"CUDA_VISIBLE_DEVICES as this process was started); a device edge "
        f"needs both ends on the same card set")


class _IpcTensor:
    """A CUDA tensor in a descriptor: where its bytes are, not the bytes."""

    __slots__ = ("device_uuid", "dtype", "size", "stride", "offset", "share",
                 "event")

    def __init__(self, device_uuid, dtype, size, stride, offset, share, event):
        self.device_uuid = device_uuid
        self.dtype = dtype
        self.size = size
        self.stride = stride
        self.offset = offset
        self.share = share      # torch's UntypedStorage._share_cuda_() tuple
        self.event = event      # the writer's interprocess event handle


def _is_cuda_tensor(x) -> bool:
    import sys

    torch = sys.modules.get("torch")
    return (torch is not None and isinstance(x, torch.Tensor)
            and x.device.type == "cuda")


class DeviceChannelWriter:
    """Write side: CUDA tensors stay put; the reader copies them out."""

    # Process-wide writer numbering, as in ray_tpu: uids of two writers
    # of one process never collide.
    _next_writer = iter(range(1, 1 << 30)).__next__

    def __init__(self, meta_channel):
        self._meta = meta_channel
        self._seq = 0
        self._base = DeviceChannelWriter._next_writer() << 32
        # One entry per message in flight: its tensors and events, kept
        # until the ring reuses its slot (maxlen = the ring's depth).
        self._held: collections.deque = collections.deque(
            maxlen=max(1, int(getattr(meta_channel, "num_slots", 4))))

    def write(self, value: Any, timeout_s: float = 60.0) -> None:
        from ray_tpu_torch.ops.tree import tree_leaves, tree_map

        if not any(_is_cuda_tensor(x) for x in tree_leaves(value)):
            self._meta.write({"uuid": None, "tree": value}, timeout_s=timeout_s)
            self._held.append(None)
            return
        import torch

        events: dict[int, Any] = {}
        held: list = []

        def export(x):
            if not _is_cuda_tensor(x):
                return x
            x = x.detach()
            dev = x.device.index
            if dev not in events:
                ev = torch.cuda.Event(interprocess=True)
                ev.record(torch.cuda.current_stream(dev))
                events[dev] = ev
            held.append(x)
            share = x.untyped_storage()._share_cuda_()
            return _IpcTensor(_device_uuid(dev), str(x.dtype).removeprefix("torch."),
                              tuple(x.shape), tuple(x.stride()),
                              x.storage_offset(), share,
                              events[dev].ipc_handle())

        tree = tree_map(export, value)
        self._seq += 1
        meta = {"uuid": self._base | self._seq, "host": _host_id(), "tree": tree}
        self._meta.write(meta, timeout_s=timeout_s)
        self._held.append((held, list(events.values())))

    def close(self) -> None:
        self._meta.close()

    def unlink(self) -> None:
        if hasattr(self._meta, "unlink"):
            self._meta.unlink()


class DeviceChannelReader:
    """Read side: maps the descriptor's tensors and copies them into
    this process's allocations."""

    # The copies are owned allocations and the other leaves are copied
    # out of the ring slot below: readers need no defensive copy before
    # end_read.
    owns_payload = True

    def __init__(self, meta_channel):
        self._meta = meta_channel

    @property
    def meta_bytes(self) -> "int | None":
        """The last descriptor's bytes in the meta channel's slot."""
        return getattr(self._meta, "last_read_bytes", None)

    def begin_read(self, timeout_s: float = 60.0) -> Any:
        meta = self._meta.begin_read(timeout_s=timeout_s)
        if not isinstance(meta, dict) or "tree" not in meta:
            return copy.deepcopy(meta)
        # Non-tensor leaves may be zero-copy views into the ring slot,
        # which dies at end_read: copy the (small) descriptor out.
        tree = copy.deepcopy(meta["tree"])
        if meta["uuid"] is None:
            return tree
        if meta["host"] != _host_id():
            raise RuntimeError(
                f"device edge: the writer runs on host {meta['host']!r} and "
                f"this reader on {_host_id()!r}; CUDA IPC is same-host only")
        import torch
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        from ray_tpu_torch.ops.tree import tree_map

        waited: dict = {}
        streams: dict[int, Any] = {}  # device -> this thread's current stream
        views: list = []  # the mapped memory stays open until the copies end

        def fetch(x):
            if not isinstance(x, _IpcTensor):
                return x
            dev = _local_index(x.device_uuid)
            stream = streams.get(dev)
            if stream is None:
                stream = streams[dev] = torch.cuda.current_stream(dev)
            if x.event not in waited:
                ev = torch.cuda.Event.from_ipc_handle(dev, x.event)
                stream.wait_event(ev)
                waited[x.event] = ev
            (_, handle, size_bytes, offset_bytes, ref_handle, ref_offset,
             ev_handle, ev_sync) = x.share
            with torch.cuda.device(dev):
                view = rebuild_cuda_tensor(
                    torch.Tensor, torch.Size(x.size), x.stride, x.offset,
                    torch.storage.TypedStorage, getattr(torch, x.dtype), dev,
                    handle, size_bytes, offset_bytes, False, ref_handle,
                    ref_offset, ev_handle, ev_sync)
                out = torch.empty_like(view, memory_format=torch.contiguous_format)
                out.copy_(view)
            views.append(view)
            return out

        value = tree_map(fetch, tree)
        for stream in streams.values():
            stream.synchronize()
        del views
        return value

    def end_read(self) -> None:
        self._meta.end_read()

    def close(self) -> None:
        self._meta.close()
