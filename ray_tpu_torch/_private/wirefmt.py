"""Binary hot-path wire format + the codec behind it.

The control plane's framing was ``[u32 len][pickle((kind, msg_id,
body))]`` for every message (rpc.py). Pickle is the right tool for the
cold path (arbitrary objects, foreign producers), but the HOT frames —
direct pushes, delivery acks, seal confirmations, the task_started/
task_finished bookkeeping casts — are dicts of str/bytes/int/float and
small containers, and paying a pickler round trip per frame caps the
dispatch plane (reference rationale: the reference keeps its entire
core worker + raylet serialization in C++ protobufs for exactly this,
src/ray/protobuf/common.proto + rpc/).

This module provides:

  * The tagged-value codec shared with src/specenc/specenc.c — a
    native (C) implementation when the extension builds, and a
    byte-identical pure-Python fallback (mandatory: a build env
    without Python headers, or RAY_TPU_NATIVE=0, must keep working).
    ``codec()`` returns whichever is active; both expose
    pack/unpack (spec tuples, 0xA7-headed) and pack_value/unpack_value
    (one raw tagged value, used as frame payloads).

  * The binary frame layer: ``encode(kind, msg_id, body)`` returns the
    compact frame for HOT kinds (None -> caller pickles, the cold
    path), ``decode_frame(data)`` the inverse. Frames self-identify by
    a leading magic byte (0xA9) that can never collide with a pickle
    stream (protocol >= 2 always leads with 0x80), carry a version
    byte for mixed-version peers, and are only SENT to peers that
    advertised support during the register/whoami handshake
    (Connection.wire_binary) — decoding is unconditional, so the
    handshake (itself always pickled) can never race a binary frame.

  * Cast coalescing: ``coalesce_casts`` merges CONSECUTIVE buffered
    casts of the same kind (delivery acks, seal batches) into one
    frame with N records, preserving record order across kinds — the
    flood traffic that used to pay per-record framing ships as one
    frame per burst (rpc.Connection.flush_casts).

Frame layout:

  [0] 0xA9 magic   [1] version   [2] kind code   [3] flags (reserved)
  [4..] varint msg_id, then the body as one tagged value.

Tagged values: None, bool, int (64-bit signed, zigzag varint), float
(native-endian f64), str, bytes, list, tuple, dict with str keys.
All-str lists and all-numeric dicts keep the compact v1 tags
(T_LSTR/T_DSF) so packed TaskSpecs are byte-identical to the
pre-wire-format encoding.
"""

from __future__ import annotations

import os
import struct

# ---------------------------------------------------------------------------
# tagged-value codec (pure-Python half; must mirror src/specenc/specenc.c)

_MAGIC = 0xA7
_VERSION = 1
_MAX_DEPTH = 64

_T_NONE = 0
_T_STR = 1
_T_BYTES = 2
_T_INT = 3
_T_FLOAT = 4
_T_TRUE = 5
_T_FALSE = 6
_T_LSTR = 7      # list of str
_T_DSF = 8       # dict str -> float (all-numeric values)
_T_PAIR_SI = 9   # (str, int) — owner_addr
_T_LIST = 10     # generic list
_T_MAP = 11      # dict str -> any
_T_TUPLE = 12    # generic tuple

_F8 = struct.Struct("=d")  # native order, like the C memcpy of a double
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _wv(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _zig(i: int) -> int:
    return ((i << 1) ^ (i >> 63)) & 0xFFFFFFFFFFFFFFFF


def _unzig(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _enc_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _wv(out, len(b))
    out += b


def _enc(out: bytearray, v, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise TypeError("specenc: nesting too deep")
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, str):
        out.append(_T_STR)
        _enc_str(out, v)
    elif isinstance(v, bytes):
        out.append(_T_BYTES)
        _wv(out, len(v))
        out += v
    elif isinstance(v, bool):
        out.append(_T_TRUE if v else _T_FALSE)  # bool subclass path
    elif isinstance(v, int):
        if v < _I64_MIN or v > _I64_MAX:
            raise TypeError("int out of 64-bit range")
        out.append(_T_INT)
        _wv(out, _zig(v))
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out += _F8.pack(v)
    elif isinstance(v, list):
        all_str = all(isinstance(it, str) for it in v)
        out.append(_T_LSTR if all_str else _T_LIST)
        _wv(out, len(v))
        for it in v:
            if all_str:
                _enc_str(out, it)
            else:
                _enc(out, it, depth + 1)
    elif isinstance(v, dict):
        items = list(v.items())
        for k, _val in items:
            if not isinstance(k, str):
                raise TypeError("dict keys must be str")
        all_num = all(
            isinstance(val, float)
            or (isinstance(val, int) and not isinstance(val, bool))
            for _k, val in items)
        out.append(_T_DSF if all_num else _T_MAP)
        _wv(out, len(items))
        for k, val in items:
            _enc_str(out, k)
            if all_num:
                out += _F8.pack(float(val))
            else:
                _enc(out, val, depth + 1)
    elif isinstance(v, tuple):
        if (len(v) == 2 and isinstance(v[0], str)
                and isinstance(v[1], int) and not isinstance(v[1], bool)):
            if v[1] < _I64_MIN or v[1] > _I64_MAX:
                raise TypeError("int out of 64-bit range")
            out.append(_T_PAIR_SI)
            _enc_str(out, v[0])
            _wv(out, _zig(v[1]))
        else:
            out.append(_T_TUPLE)
            _wv(out, len(v))
            for it in v:
                _enc(out, it, depth + 1)
    else:
        raise TypeError(
            f"specenc: unsupported value type {type(v).__name__}")


def _dec_varint(buf: bytes, off: int) -> "tuple[int, int]":
    v = 0
    shift = 0
    while True:
        if off >= len(buf):
            raise ValueError("specenc: truncated")
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, off
        shift += 7
        if shift > 63:
            raise ValueError("specenc: varint overflow")


def _dec_str(buf: bytes, off: int) -> "tuple[str, int]":
    n, off = _dec_varint(buf, off)
    if off + n > len(buf):
        raise ValueError("specenc: truncated")
    return buf[off:off + n].decode("utf-8"), off + n


def _check_count(n: int, buf: bytes, off: int, min_per: int) -> None:
    # Every element costs >= min_per bytes: a count past the remaining
    # buffer is provably corruption, not just a big container.
    if n * min_per > len(buf) - off:
        raise ValueError("specenc: implausible count")


def _dec(buf: bytes, off: int, depth: int):
    if depth > _MAX_DEPTH:
        raise ValueError("specenc: nesting too deep")
    if off >= len(buf):
        raise ValueError("specenc: truncated")
    tag = buf[off]
    off += 1
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_STR:
        return _dec_str(buf, off)
    if tag == _T_BYTES:
        n, off = _dec_varint(buf, off)
        if off + n > len(buf):
            raise ValueError("specenc: truncated")
        return buf[off:off + n], off + n
    if tag == _T_INT:
        v, off = _dec_varint(buf, off)
        return _unzig(v), off
    if tag == _T_FLOAT:
        if off + 8 > len(buf):
            raise ValueError("specenc: truncated")
        return _F8.unpack_from(buf, off)[0], off + 8
    if tag in (_T_LSTR, _T_LIST, _T_TUPLE):
        n, off = _dec_varint(buf, off)
        _check_count(n, buf, off, 1)
        items = []
        for _ in range(n):
            if tag == _T_LSTR:
                it, off = _dec_str(buf, off)
            else:
                it, off = _dec(buf, off, depth + 1)
            items.append(it)
        return (tuple(items) if tag == _T_TUPLE else items), off
    if tag == _T_DSF:
        n, off = _dec_varint(buf, off)
        _check_count(n, buf, off, 9)
        d = {}
        for _ in range(n):
            k, off = _dec_str(buf, off)
            if off + 8 > len(buf):
                raise ValueError("specenc: truncated")
            d[k] = _F8.unpack_from(buf, off)[0]
            off += 8
        return d, off
    if tag == _T_MAP:
        n, off = _dec_varint(buf, off)
        _check_count(n, buf, off, 2)
        d = {}
        for _ in range(n):
            k, off = _dec_str(buf, off)
            d[k], off = _dec(buf, off, depth + 1)
        return d, off
    if tag == _T_PAIR_SI:
        s, off = _dec_str(buf, off)
        v, off = _dec_varint(buf, off)
        return (s, _unzig(v)), off
    raise ValueError(f"specenc: bad tag {tag}")


def py_pack(tup: tuple) -> bytes:
    if not isinstance(tup, tuple):
        raise TypeError("pack() expects a tuple")
    out = bytearray((_MAGIC, _VERSION))
    _wv(out, len(tup))
    for v in tup:
        _enc(out, v, 0)
    return bytes(out)


def py_unpack(data) -> tuple:
    buf = bytes(data)
    if len(buf) < 2 or buf[0] != _MAGIC or buf[1] != _VERSION:
        raise ValueError("specenc: bad magic/version")
    n, off = _dec_varint(buf, 2)
    if n > 4096:
        raise ValueError("specenc: implausible field count")
    vals = []
    for _ in range(n):
        v, off = _dec(buf, off, 0)
        vals.append(v)
    return tuple(vals)


def py_pack_value(v) -> bytes:
    out = bytearray()
    _enc(out, v, 0)
    return bytes(out)


def py_unpack_value(data):
    buf = bytes(data)
    v, off = _dec(buf, 0, 0)
    if off != len(buf):
        raise ValueError("specenc: trailing bytes")
    return v


class _PyCodec:
    """Pure-Python codec with the native module's interface."""

    pack = staticmethod(py_pack)
    unpack = staticmethod(py_unpack)
    pack_value = staticmethod(py_pack_value)
    unpack_value = staticmethod(py_unpack_value)


PY_CODEC = _PyCodec()

# ---------------------------------------------------------------------------
# codec selection (C fast lane with mandatory pure-Python fallback)

_codec = None


def native_disabled() -> bool:
    return os.environ.get("RAY_TPU_NATIVE", "1").lower() in (
        "0", "false", "no")


def _load_codec():
    if native_disabled():
        return PY_CODEC
    try:
        from ray_tpu_torch._private import native_build

        native_build.ensure_native()
        path = os.path.join(native_build._OUT, "_specenc.so")
        if os.path.exists(path):
            import importlib.util

            spec = importlib.util.spec_from_file_location("_specenc", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            # A stale extension predating pack_value must not split the
            # codec across implementations — all-or-nothing.
            if hasattr(mod, "pack_value"):
                return mod
    except Exception:
        pass
    return PY_CODEC


def codec():
    """The active tagged-value codec: the C extension when built (and
    RAY_TPU_NATIVE isn't 0), else the pure-Python fallback."""
    global _codec
    if _codec is None:
        _codec = _load_codec()
    return _codec


def native_active() -> bool:
    return codec() is not PY_CODEC


# ---------------------------------------------------------------------------
# binary frame layer

WIRE_MAGIC = 0xA9
WIRE_VERSION = 1

_CAST_BATCH = "__cast_batch__"  # mirrors rpc.CAST_BATCH (no import cycle)

# Hot frame kinds eligible for binary encoding. Cold-path kinds keep
# pickle (arbitrary payloads, foreign producers, handshake frames —
# register/whoami are ALWAYS pickled, so negotiation can't race a
# binary frame). Codes are wire protocol: never renumber, only append.
KIND_CODES = {
    "direct_push": 1,
    "direct_ack": 2,
    "direct_rej": 3,
    "owner_sealed": 4,
    "task_started": 5,
    "task_finished": 6,
    "seal_objects": 7,
    "push_task": 8,
    "submit_task": 9,
    "submit_actor_task": 10,
    _CAST_BATCH: 11,
    "cancel_direct": 12,
    "put_inline": 13,
    "del_ref": 14,
    "del_borrow": 15,
    "add_borrow": 16,
}
KIND_NAMES = {v: k for k, v in KIND_CODES.items()}


class WireDecodeError(Exception):
    """A binary frame failed to decode (corrupt, truncated, unknown
    version/kind). The connection that produced it cannot be trusted
    to be in frame sync and must close."""


# Hot frames are casts (msg_id 0) in the overwhelming majority: their
# 5-byte header is constant per kind, so precompute it.
CAST_HDR_LEN = 5
_HDR0 = {k: bytes((WIRE_MAGIC, WIRE_VERSION, c, 0, 0))
         for k, c in KIND_CODES.items()}


def cast_payload(data: "bytes | None") -> "bytes | None":
    """The tagged body of an encoded CAST frame, or None when `data`
    is not a canonical zero-flags/zero-msg-id cast (reply, error, or
    pickle fallback). The native event loop (src/eventloop) re-frames
    from (kind code, payload) alone, re-synthesizing this exact 5-byte
    header on the wire — the two sides must agree on its layout, so
    the check lives here next to _HDR0 rather than in rpc.py."""
    if data is not None and data[3] == 0 and data[4] == 0:
        return data[CAST_HDR_LEN:]
    return None


def encode(kind: str, msg_id: int, body) -> "bytes | None":
    """Binary frame for a hot kind, or None -> the caller pickles.
    Batch frames only go binary when EVERY record is a hot kind (a
    cold record's body may hold arbitrary objects or pure-numeric
    dicts whose int/float distinction the compact tags don't keep)."""
    head = _HDR0.get(kind)
    if head is None:
        return None
    if kind == _CAST_BATCH and any(k not in KIND_CODES for k, _b in body):
        return None
    try:
        payload = (_codec or codec()).pack_value(body)
    except (TypeError, ValueError, OverflowError):
        return None  # exotic body: pickle fallback
    if msg_id:
        head = bytearray(head[:4])
        _wv(head, msg_id)
        head = bytes(head)
    return head + payload


def decode_frame(data: bytes):
    """(kind, msg_id, body) from a binary frame. Raises WireDecodeError
    on anything malformed — the caller closes the connection."""
    try:
        if len(data) < 5 or data[0] != WIRE_MAGIC:
            raise WireDecodeError("not a binary frame")
        if data[1] != WIRE_VERSION:
            raise WireDecodeError(f"unsupported wire version {data[1]}")
        kind = KIND_NAMES.get(data[2])
        if kind is None:
            raise WireDecodeError(f"unknown frame kind code {data[2]}")
        if data[4] == 0:  # the cast fast path: varint(0)
            msg_id, off = 0, 5
        else:
            msg_id, off = _dec_varint(data, 4)
        body = (_codec or codec()).unpack_value(memoryview(data)[off:])
        return kind, msg_id, body
    except WireDecodeError:
        raise
    except Exception as e:  # noqa: BLE001 — typed error contract
        raise WireDecodeError(f"corrupt binary frame: {e}") from None


# ---------------------------------------------------------------------------
# cast coalescing (seal/ack record merging)

def _merge_ack(bodies: list) -> dict:
    return {"task_ids": [t for b in bodies
                         for t in (b.get("task_ids") or ())]}


def _merge_objects(bodies: list) -> dict:
    return {"objects": [o for b in bodies
                        for o in (b.get("objects") or ())]}


def _merge_owner_sealed(bodies: list) -> dict:
    merged = _merge_objects(bodies)
    # Records merged here left the same ~1 ms flush window; the latest
    # stamp is the truthful "owner holds all of these" instant.
    ts = [b["t_resolve"] for b in bodies if b.get("t_resolve")]
    if ts:
        merged["t_resolve"] = max(ts)
    return merged


_MERGERS = {
    "direct_ack": _merge_ack,
    "seal_objects": _merge_objects,
    "owner_sealed": _merge_owner_sealed,
}


def coalesce_casts(buf: list) -> list:
    """[(kind, body)] -> [(kind, body, n_records)] merging CONSECUTIVE
    runs of the same mergeable kind into one body with N records.
    Only adjacent records merge, so record order across kinds is
    exactly the buffered order — the ordering contract callers rely
    on (a cancel buffered after a push never overtakes it)."""
    out: list = []
    run_kind: "str | None" = None
    run: list = []

    def _close():
        nonlocal run_kind, run
        if run_kind is not None:
            body = run[0] if len(run) == 1 else _MERGERS[run_kind](run)
            out.append((run_kind, body, len(run)))
            run_kind, run = None, []

    for kind, body in buf:
        if kind == run_kind:
            run.append(body)
        elif kind in _MERGERS:
            _close()
            run_kind, run = kind, [body]
        else:
            _close()
            out.append((kind, body, 1))
    _close()
    return out
