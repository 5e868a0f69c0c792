"""Mutable shared-memory channels (Python binding; port of
ray_tpu/experimental/channel.py).

A channel is one POSIX shm region holding a ring of ``num_slots``
payload slots, allocated once and REUSED for every message: a message
costs one serialize into mapped memory and two atomic transitions, no
RPC and no object-store bookkeeping (``ray_tpu_torch/src/channel/
channel.cc``, built into ``build/ray_tpu_torch/native/libchannel.so``).

Usage:
    ch = Channel(capacity=2 << 20, num_readers=1)   # writer side
    ch.write(np.ones((512, 512)))                   # blocks on a slow reader
    # reader side (the handle arrives by pickling):
    value = ch.begin_read()       # numpy arrays view the slot
    ...use value...
    ch.end_read()                 # allows the next write into that slot

Values go through the port's serialization (``_private/serialization``):
a numpy array is read as a zero-copy view into the slot, valid until
``end_read``; a torch tensor crosses as host bytes and is rebuilt as a
fresh tensor (the object store's rule), a top-level CUDA tensor on the
reader's current CUDA device. Device-to-device edges are
``device_channel``'s CUDA IPC.
"""

from __future__ import annotations

import ctypes
import os
import uuid
from typing import Any

from ray_tpu_torch._private import serialization


def _load_lib() -> ctypes.CDLL:
    from ray_tpu_torch._private.native_build import _OUT, ensure_native

    ensure_native()  # also rebuilds when the sources are newer than the .so
    path = os.path.join(_OUT, "libchannel.so")
    if not os.path.exists(path):
        raise RuntimeError(
            "libchannel.so not built; run `make -C ray_tpu_torch/src` at the "
            "repo root")
    lib = ctypes.CDLL(path)
    lib.rtpu_chan_create.restype = ctypes.c_int64
    lib.rtpu_chan_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                     ctypes.c_uint32, ctypes.c_uint32]
    lib.rtpu_chan_open.restype = ctypes.c_int64
    lib.rtpu_chan_open.argtypes = [ctypes.c_char_p]
    lib.rtpu_chan_capacity.restype = ctypes.c_uint64
    lib.rtpu_chan_capacity.argtypes = [ctypes.c_int64]
    lib.rtpu_chan_write_acquire.restype = ctypes.c_void_p
    lib.rtpu_chan_write_acquire.argtypes = [ctypes.c_int64, ctypes.c_double]
    lib.rtpu_chan_write_commit.restype = ctypes.c_int
    lib.rtpu_chan_write_commit.argtypes = [ctypes.c_int64, ctypes.c_uint64]
    lib.rtpu_chan_write_abort.restype = ctypes.c_int
    lib.rtpu_chan_write_abort.argtypes = [ctypes.c_int64]
    lib.rtpu_chan_read_acquire.restype = ctypes.c_int64
    lib.rtpu_chan_read_acquire.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.c_double]
    lib.rtpu_chan_read_release.restype = ctypes.c_int
    lib.rtpu_chan_read_release.argtypes = [ctypes.c_int64]
    lib.rtpu_chan_close.restype = ctypes.c_int
    lib.rtpu_chan_close.argtypes = [ctypes.c_int64]
    lib.rtpu_chan_is_closed.restype = ctypes.c_int
    lib.rtpu_chan_is_closed.argtypes = [ctypes.c_int64]
    lib.rtpu_chan_destroy.restype = ctypes.c_int
    lib.rtpu_chan_destroy.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.rtpu_chan_force_unlink.restype = ctypes.c_int
    lib.rtpu_chan_force_unlink.argtypes = [ctypes.c_char_p]
    return lib


_lib: ctypes.CDLL | None = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class ChannelClosed(Exception):
    """The channel was torn down (CompiledDAG.teardown or peer exit)."""


class ChannelTimeout(Exception):
    pass


class Channel:
    """Single-writer channel with a fixed number of readers.

    The writer can run up to ``num_slots`` messages ahead of the slowest
    reader. Pickling transfers the NAME only: the receiving process
    opens the same shm region. Exactly ``num_readers`` processes must
    read every message or the writer stalls.

    ``last_read_bytes``: the size of the last message this handle read
    (its bytes in the slot)."""

    def __init__(self, capacity: int = 8 << 20, num_readers: int = 1,
                 name: str | None = None, _create: bool = True,
                 num_slots: int = 4):
        self.name = name or f"/ray_tpu_torch-chan-{uuid.uuid4().hex[:12]}"
        self.capacity = capacity
        self.num_readers = num_readers
        self.num_slots = num_slots
        self._creator = _create
        self.last_read_bytes = 0
        lib = _get_lib()
        if _create:
            h = lib.rtpu_chan_create(self.name.encode(), capacity,
                                     num_readers, num_slots)
        else:
            h = lib.rtpu_chan_open(self.name.encode())
        if h < 0:
            raise OSError(-h, f"channel {self.name}: {os.strerror(-h)}")
        self._h = h
        if not _create:
            self.capacity = lib.rtpu_chan_capacity(h)

    # -- writer side -------------------------------------------------------

    def write(self, value: Any, timeout_s: float = 60.0) -> None:
        """Serialize ``value`` straight into the slot. Blocks until every
        reader released the message that last used the slot."""
        lib = _get_lib()
        header, buffers = serialization.serialize(value)
        size = serialization.serialized_size(header, buffers)
        if size > self.capacity:
            raise ValueError(
                f"serialized value ({size} B) exceeds channel capacity "
                f"({self.capacity} B); size the channel for the largest "
                f"message")
        ptr = lib.rtpu_chan_write_acquire(self._h, ctypes.c_double(timeout_s))
        if not ptr:
            self._raise_wait_failure("write")
        try:
            view = (ctypes.c_char * self.capacity).from_address(ptr)
            n = serialization.write_to(memoryview(view).cast("B"), header,
                                       buffers)
        except BaseException:
            # Nothing was published: release the acquired slot, so the
            # next write does not see a permanent bogus ChannelTimeout.
            lib.rtpu_chan_write_abort(self._h)
            raise
        if lib.rtpu_chan_write_commit(self._h, n) != 0:
            raise RuntimeError("channel write commit failed")

    # -- reader side -------------------------------------------------------

    def begin_read(self, timeout_s: float = 60.0) -> Any:
        """The next message, deserialized from the slot: numpy arrays
        view the shared memory and stay valid until end_read(); torch
        tensors are fresh copies."""
        lib = _get_lib()
        out = ctypes.c_void_p()
        n = lib.rtpu_chan_read_acquire(self._h, ctypes.byref(out),
                                       ctypes.c_double(timeout_s))
        if n < 0:
            if n == -2:
                raise ChannelClosed(self.name)
            if n == -1:
                raise ChannelTimeout(
                    f"no message on {self.name} within {timeout_s}s")
            raise RuntimeError(f"read_acquire failed ({n}) on {self.name}")
        self.last_read_bytes = n
        view = memoryview(
            (ctypes.c_char * n).from_address(out.value)).cast("B")
        return serialization.loads_from(view)

    def end_read(self) -> None:
        """Release the slot for the next write. Zero-copy views from
        begin_read are invalid after this."""
        if _get_lib().rtpu_chan_read_release(self._h) != 0:
            raise RuntimeError("end_read without begin_read")

    def read(self, timeout_s: float = 60.0) -> Any:
        """begin_read + deep copy + end_read: safe to hold indefinitely."""
        import copy

        value = self.begin_read(timeout_s)
        try:
            return copy.deepcopy(value)
        finally:
            self.end_read()

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Wake all blocked peers with ChannelClosed."""
        _get_lib().rtpu_chan_close(self._h)

    def unlink(self) -> None:
        """Remove the shm NAME now (mappings stay valid until their
        holders detach or die), so channels of crashed actors, whose
        attach counts never reach zero, do not leak /dev/shm regions."""
        _get_lib().rtpu_chan_force_unlink(self.name.encode())

    def _raise_wait_failure(self, op: str) -> None:
        if _get_lib().rtpu_chan_is_closed(self._h):
            raise ChannelClosed(self.name)
        raise ChannelTimeout(f"{op} on {self.name}: readers did not "
                             f"release the previous message in time")

    def __reduce__(self):
        return (Channel, (self.capacity, self.num_readers, self.name, False))

    def __del__(self):
        # Detach only: the last detacher unlinks the shm name, so a
        # creator handle collected early cannot invalidate readers.
        try:
            _get_lib().rtpu_chan_destroy(self._h, 0)
        except Exception:
            pass
