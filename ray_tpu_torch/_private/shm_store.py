"""Shared-memory object store: Python binding over the C++ arena.

Counterpart of the reference's plasma store + store providers
(reference: src/ray/object_manager/plasma/store.h:55,
src/ray/core_worker/store_provider/plasma_store_provider.h:93), redesigned for
a single-allocator model: the node's store owner (head process) runs the C++
best-fit arena (src/object_store/arena.cc) and hands out offsets over the
control plane; workers attach the same segment and read payloads zero-copy
through memoryviews. torch tensors go through it as raw host bytes
(serialization.py); a colocated CUDA result is also kept on the device
(dataplane.DeviceCache).

Object payload layout in shm: raw bytes written by the creator, then sealed.
Metadata (size, refcount, sealed flag) lives in the owner's directory, not in
shm — avoiding cross-process locks on the read path.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import sys


def _load_lib() -> ctypes.CDLL | None:
    from ray_tpu_torch._private.native_build import _OUT, ensure_native

    path = os.path.join(_OUT, "libobjstore.so")

    ensure_native()  # also rebuilds when sources are newer than the .so
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None  # corrupt/partial artifact — pure-Python fallback
    lib.store_create.restype = ctypes.c_void_p
    lib.store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.store_attach.restype = ctypes.c_void_p
    lib.store_attach.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.store_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.store_alloc.restype = ctypes.c_uint64
    lib.store_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.store_free.restype = ctypes.c_uint64
    lib.store_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.store_base.restype = ctypes.c_void_p
    lib.store_base.argtypes = [ctypes.c_void_p]
    for fn in ("store_in_use", "store_capacity", "store_num_objects", "store_largest_free"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    return lib


_LIB = _load_lib()

OOM = 2**64 - 1


class ShmArena:
    """Owner-side store: allocates offsets in a named shm segment."""

    def __init__(self, name: str, capacity: int):
        if _LIB is None:
            raise RuntimeError(
                "native object store not built; run `make -C src` from the repo root"
            )
        self.name = name
        self.capacity = capacity
        self._h = _LIB.store_create(name.encode(), capacity)
        if not self._h:
            raise RuntimeError(f"failed to create shm segment {name} ({capacity} bytes)")
        base = _LIB.store_base(self._h)
        self._buf = (ctypes.c_char * capacity).from_address(base)
        # Cast to unsigned bytes: ctypes char arrays export format 'c', which
        # memoryview cannot slice-assign from bytes.
        self._view = memoryview(self._buf).cast("B")

    def alloc(self, size: int) -> int | None:
        if not self._h:
            return None  # closed (shutdown raced an RPC handler)
        off = _LIB.store_alloc(self._h, size)
        return None if off == OOM else off

    def free(self, offset: int) -> int:
        if not self._h:
            # Closed arena: a late connection-close handler freeing
            # entries after Head.shutdown must not call into the
            # destroyed native allocator (segfault, not exception).
            return 0
        return _LIB.store_free(self._h, offset)

    def view(self, offset: int, size: int) -> memoryview:
        return self._view[offset : offset + size]

    @property
    def in_use(self) -> int:
        return _LIB.store_in_use(self._h) if self._h else 0

    @property
    def num_objects(self) -> int:
        return _LIB.store_num_objects(self._h) if self._h else 0

    @property
    def largest_free(self) -> int:
        return _LIB.store_largest_free(self._h) if self._h else 0

    def close(self, unlink: bool = True) -> None:
        if self._h:
            self._view.release()
            _LIB.store_destroy(self._h, 1 if unlink else 0)
            self._h = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass


class ShmClient:
    """Worker-side attachment: maps the segment, reads/writes by offset."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = capacity
        # Attach via /dev/shm mmap directly (no allocator state needed).
        fd = os.open(f"/dev/shm/{name.lstrip('/')}", os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, capacity)
        finally:
            os.close(fd)
        self._view = memoryview(self._mm)

    def view(self, offset: int, size: int) -> memoryview:
        return self._view[offset : offset + size]

    def write(self, offset: int, data: bytes | memoryview) -> None:
        self._view[offset : offset + len(data)] = data

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._view.release()
                self._mm.close()
            except BufferError:
                # Zero-copy arrays from get() may legitimately outlive
                # the runtime; their buffer exports keep the mapping
                # alive until they are GC'd (process teardown unmaps).
                pass
            self._mm = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
