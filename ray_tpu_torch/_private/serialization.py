"""Object serialization with zero-copy numpy buffers and torch tensors
as out-of-band host bytes.

Counterpart of the reference's serialization layer
(reference: python/ray/_private/serialization.py, cloudpickle fork under
python/ray/cloudpickle/, zero-copy arrow in arrow_serialization.py). Uses
upstream cloudpickle + pickle protocol 5 out-of-band buffers so large numpy
arrays land in shared memory unsharded and deserialize as zero-copy views.

Wire layout of a serialized object:
    [u32 magic][u64 len(header)][header pickle bytes]
    [u64 nbuffers]([u64 aligned_offset][u64 len])* [padded buffers...]
Buffers are 64-byte aligned inside the payload so zero-copy numpy views keep
alignment guarantees.

torch tensors (the port's counterpart of ray_tpu's jax.Array handling):
a tensor at any depth pickles as ONE out-of-band buffer of its
contiguous host bytes plus its dtype and shape (torch's own pickling
puts the storage in-band, and a CUDA tensor would unpickle onto the
producer's device index, or fail where there is no CUDA). bf16 has no
numpy dtype, so every tensor travels as raw bytes. A tensor is mutable,
so it comes back as a fresh CPU tensor, never as a view of the
payload: one reader's in-place write cannot reach the stored object or
another reader. A TOP-LEVEL CUDA tensor comes back on the reader's
current CUDA device when the reader has one.
"""

from __future__ import annotations

import contextlib
import io
import pickle
import struct
import sys
import threading
from typing import Any

import cloudpickle

from ray_tpu_torch._private.ids import ObjectRef

MAGIC = 0x52545055  # 'RTPU'
_ALIGN = 64

# Per-thread ObjectRef collector: while active, every ObjectRef pickled
# (at any nesting depth) is recorded. The runtime uses this for
# containment pins (refs serialized into a stored object) and for
# pinning refs nested inside task args (reference: reference_count.h
# "contained in owned object" / serialized-ref tracking).
_ref_collector = threading.local()


@contextlib.contextmanager
def collect_refs():
    """Context manager yielding a list that accumulates the hex ids of
    every ObjectRef serialized within (nested scopes stack)."""
    prev = getattr(_ref_collector, "ids", None)
    collected: list[str] = []
    _ref_collector.ids = collected
    try:
        yield collected
    finally:
        _ref_collector.ids = prev


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


# Reducers installed via ray_tpu_torch.util.register_serializer. Scoped to THIS
# serializer (reference: the worker's SerializationContext custom-type
# table, _private/serialization.py) — plain pickle.dumps/copy.deepcopy in
# user code are untouched.
custom_reducers: dict[type, Any] = {}


class _RuntimePickler(cloudpickle.Pickler):
    """CloudPickler with the runtime's custom reducers layered on top.

    Hooked via reducer_override (PEP 574), not dispatch_table: the C
    pickler snapshots self.dispatch_table at __init__, so an instance
    assignment after super().__init__ is never consulted — and mutating
    cloudpickle's class-level table would be process-global again.
    reducer_override is called for every non-builtin object and takes
    priority, which is exactly the per-pickler scoping we need."""

    def reducer_override(self, obj):
        if type(obj) is ObjectRef:
            lst = getattr(_ref_collector, "ids", None)
            if lst is not None:
                lst.append(obj.hex())
            return NotImplemented  # normal __reduce__ path
        reducer = custom_reducers.get(type(obj))
        if reducer is not None:
            return reducer(obj)
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in (torch.Tensor,
                                               torch.nn.Parameter):
            # Device→host conversion at ANY nesting depth, as raw
            # out-of-band bytes. Guarded on sys.modules so torch-free
            # processes never pay the import.
            return _reduce_tensor(obj, self)
        return super().reducer_override(obj)


# Per-thread id() of the value serialize() was handed when it is a CUDA
# tensor: only that tensor is rebuilt on the reader's device.
_top_level = threading.local()


def _reduce_tensor(t, pickler):
    """One out-of-band PickleBuffer of ``t``'s contiguous host bytes.
    Strided dense tensors only; other layouts (sparse, quantized,
    nested) keep torch's own pickling."""
    import torch

    if t.layout != torch.strided or t.is_quantized or t.is_nested:
        return cloudpickle.Pickler.reducer_override(pickler, t)
    on_cuda = t.device.type == "cuda"
    to_device = on_cuda and getattr(_top_level, "id", None) == id(t)
    host = t.detach().resolve_conj().resolve_neg().to("cpu").contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (pickle.PickleBuffer(raw),
                             str(t.dtype).removeprefix("torch."),
                             tuple(t.shape), to_device,
                             type(t) is torch.nn.Parameter, t.requires_grad)


def _rebuild_tensor(buf, dtype: str, shape: tuple, to_device: bool,
                    parameter: bool, requires_grad: bool):
    """A fresh CPU tensor holding a copy of ``buf`` (the zero-copy read
    path hands in a read-only view of the store: copying here keeps
    the stored object immutable). ``to_device``: a top-level CUDA
    result, put on the reader's current CUDA device when it has one."""
    import numpy as np
    import torch

    src = np.frombuffer(buf, dtype=np.uint8)
    out = torch.empty(src.size, dtype=torch.uint8)
    out.numpy()[:] = src
    t = out.view(getattr(torch, dtype)).reshape(shape)
    if to_device and torch.cuda.is_available():
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


def _dump(obj: Any, protocol: int = 5, buffer_callback=None) -> bytes:
    # The C-pickler fast path is only safe when no per-runtime reducer
    # can fire: custom reducers, an active ref collector, or a loaded
    # torch (tensors at any depth need reducer_override's host bytes).
    if (not custom_reducers and "torch" not in sys.modules
            and getattr(_ref_collector, "ids", None) is None):
        return cloudpickle.dumps(obj, protocol=protocol,
                                 buffer_callback=buffer_callback)
    f = io.BytesIO()
    _RuntimePickler(f, protocol=protocol,
                    buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def dumps_scoped(obj: Any, protocol: int = 5) -> bytes:
    """cloudpickle.dumps honoring the runtime's custom reducers — the
    pickler for anything crossing a process boundary (task args, function
    blobs, workflow step values, serve payloads); plain in-process
    pickling stays untouched."""
    return _dump(obj, protocol)


def serialize(obj: Any) -> tuple[bytes, list[pickle.PickleBuffer]]:
    """Returns (header_bytes, oob_buffers).

    torch tensors — top-level OR nested — convert to host bytes exactly
    once, in _RuntimePickler.reducer_override, one out-of-band buffer
    each. _dump only routes through the Python-class pickler when
    torch is loaded, so torch-free processes keep the C fast path."""
    buffers: list[pickle.PickleBuffer] = []
    _top_level.id = id(obj)
    try:
        return _dump(obj, 5, buffers.append), buffers
    finally:
        _top_level.id = None


def serialized_size(header: bytes, buffers: list[pickle.PickleBuffer]) -> int:
    n = 4 + 8 + len(header)
    n = _pad(n + 8 + 16 * len(buffers))
    for b in buffers:
        n = _pad(n + len(b.raw()))
    return n


def write_to(view: memoryview, header: bytes, buffers: list[pickle.PickleBuffer]) -> int:
    """Writes the object into `view`; returns bytes written."""
    struct.pack_into("<IQ", view, 0, MAGIC, len(header))
    pos = 12
    view[pos : pos + len(header)] = header
    pos += len(header)
    index_pos = pos
    pos = _pad(pos + 8 + 16 * len(buffers))
    struct.pack_into("<Q", view, index_pos, len(buffers))
    ipos = index_pos + 8
    for b in buffers:
        raw = b.raw()
        struct.pack_into("<QQ", view, ipos, pos, len(raw))
        ipos += 16
        view[pos : pos + len(raw)] = raw
        pos = _pad(pos + len(raw))
    return pos


def dumps(obj: Any) -> bytes:
    header, buffers = serialize(obj)
    size = serialized_size(header, buffers)
    out = bytearray(size)
    write_to(memoryview(out), header, buffers)
    return bytes(out)


def loads_from(view: memoryview, *, wrap_buffer=None) -> Any:
    """Deserializes from a view; numpy arrays are zero-copy into the view.

    ``wrap_buffer(mv) -> buffer`` intercepts each out-of-band buffer
    slice before pickle consumes it — the zero-copy read path wraps
    slices in weakref-able holders to track aliasing-array lifetime."""
    magic, hlen = struct.unpack_from("<IQ", view, 0)
    if magic != MAGIC:
        raise ValueError("corrupt object payload")
    pos = 12
    header = bytes(view[pos : pos + hlen])
    pos += hlen
    (nbuf,) = struct.unpack_from("<Q", view, pos)
    pos += 8
    bufs = []
    for _ in range(nbuf):
        off, blen = struct.unpack_from("<QQ", view, pos)
        pos += 16
        b = view[off : off + blen]
        if wrap_buffer is not None:
            b = wrap_buffer(b)
        bufs.append(b)
    return pickle.loads(header, buffers=bufs)


def loads(data: bytes | memoryview) -> Any:
    return loads_from(memoryview(data))
