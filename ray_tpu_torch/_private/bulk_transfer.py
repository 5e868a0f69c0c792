"""Raw-socket bulk object transfer plane.

Counterpart of the reference's chunked object push/pull
(reference: src/ray/object_manager/push_manager.h:32,
pull_manager.h:57 — 64 MiB chunks streamed over dedicated gRPC
channels, separate from the control plane). The control-plane rpc layer
pickles every frame — fine for metadata, but a 256 MiB payload would
cross ~5 extra buffer copies (arena→bytes→pickle→frame join→recv
join→unpickle). This plane speaks a minimal binary protocol instead:

    request:  [u32 len][wirefmt tagged value {"o", "s", "l"}]
    response: [i64 n][n raw bytes]     (n < 0: error; -n-byte message)

No pickle anywhere on the bulk hot path: the request header is the
the tagged binary encoding (wirefmt codec), and a corrupt or legacy
pickled request raises a typed ``BulkRequestError`` server-side and
CLOSES the connection — the mirror of the control plane's
WireDecodeError contract (a peer out of frame sync cannot be trusted).

The server writes straight from an arena memoryview (sendall accepts
buffers — no copy) and the client ``recv_into``s a caller-provided
buffer — one copy end to end. Multiple stripes of one object are pulled
over parallel connections (reference: push_manager parallel chunk
streams), which overlaps the copy with the network and multiplies
throughput across relays.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable

from ray_tpu_torch._private import faultinject

_REQ_HDR = struct.Struct("<I")
_RSP_HDR = struct.Struct("<q")
_REQ_MAX = 4096  # a pull request is ~tens of bytes; more is corruption


class BulkError(Exception):
    pass


class BulkRequestError(BulkError):
    """A bulk request frame failed to decode (corrupt, oversized, or
    legacy pickle). The connection is out of frame sync and closes —
    the client's stripe retry dials fresh (mirror of the control
    plane's WireDecodeError contract)."""


def _encode_request(object_id: str, start: int, length: int) -> bytes:
    from ray_tpu_torch._private import wirefmt

    req = wirefmt.codec().pack_value(
        {"o": object_id, "s": start, "l": length})
    return _REQ_HDR.pack(len(req)) + req


def _decode_request(body: bytes) -> tuple:
    """(object_id, start, length) from a request body, or raise
    BulkRequestError. Pickle streams (protocol >= 2 leads 0x80) are
    rejected explicitly: no pickle decodes on the bulk hot path."""
    from ray_tpu_torch._private import wirefmt

    if body[:1] == b"\x80":
        raise BulkRequestError(
            "legacy pickled bulk request rejected (no pickle on the "
            "bulk hot path)")
    try:
        req = wirefmt.codec().unpack_value(body)
        return req["o"], int(req["s"]), int(req["l"])
    except Exception as e:  # noqa: BLE001 — typed error contract
        raise BulkRequestError(f"corrupt bulk request: {e}") from None


class BulkServer:
    """Serves raw object-byte reads.

    ``reader(object_id, start, length)`` returns a releasable
    (memoryview, release_fn) pair or raises; the lock discipline (pin
    the region while sending) belongs to the caller-provided reader.
    """

    def __init__(self, reader: Callable, host: str = "0.0.0.0",
                 port: int = 0):
        self._reader = reader
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.address = self._sock.getsockname()
        self._stopped = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="bulk-accept").start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,), daemon=True,
                             name="bulk-serve").start()

    def _serve(self, sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                hdr = _recv_exact(sock, _REQ_HDR.size)
                if hdr is None:
                    return
                n = _REQ_HDR.unpack(hdr)[0]
                if n > _REQ_MAX:
                    # Implausible header (a raw payload byte stream or
                    # wrong protocol dialed in): out of frame sync.
                    return
                body = _recv_exact(sock, n)
                if body is None:
                    return
                try:
                    object_id, start, length = _decode_request(body)
                except BulkRequestError:
                    # Typed contract: the connection closes — a decode
                    # failure means nothing after this frame can be
                    # trusted to be in sync.
                    return
                try:
                    view, release = self._reader(object_id, start, length)
                except Exception as e:  # noqa: BLE001 — error crosses wire
                    msg = repr(e).encode()
                    sock.sendall(_RSP_HDR.pack(-len(msg)) + msg)
                    continue
                try:
                    sock.sendall(_RSP_HDR.pack(len(view)))
                    sock.sendall(view)  # straight from the arena mapping
                finally:
                    release()
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass


def _recv_exact(sock: socket.socket, n: int) -> "bytes | None":
    chunks = []
    while n:
        try:
            c = sock.recv(min(n, 1 << 20))
        except OSError:
            return None
        if not c:
            return None
        chunks.append(c)
        n -= len(c)
    return b"".join(chunks)


def _recv_into_exact(sock: socket.socket, view: memoryview) -> bool:
    pos, n = 0, len(view)
    while pos < n:
        try:
            got = sock.recv_into(view[pos:], n - pos)
        except OSError:
            return False
        if got == 0:
            return False
        pos += got
    return True


def alloc_pull_buffer(size: int):
    """A pull destination WITHOUT the zero-fill tax: bytearray(n) zeroes
    every page before recv_into overwrites it — measurable at broadcast
    sizes (tens of ms per 256 MiB on one core). numpy.empty skips the
    fill; the caller sees the same writable buffer protocol. Falls back
    to bytearray in numpy-free processes."""
    import sys

    np = sys.modules.get("numpy")
    if np is None:
        try:
            import numpy as np
        except Exception:
            return bytearray(size)
    return np.empty(size, dtype=np.uint8)


def pull_into(addr: tuple, object_id: str, buf: memoryview, start: int,
              length: int, sock: "socket.socket | None" = None):
    """Pull [start, start+length) of an object into ``buf`` (which must
    be exactly ``length`` long). Returns the socket for reuse."""
    if faultinject.active() is not None:
        # Chaos plane: the bulk plane fails like a flaky link — drops
        # and resets surface as BulkError (the caller's retry policy
        # re-resolves and re-pulls), delays slow the stripe down.
        try:
            drop, _dup = faultinject.apply_send(
                f"bulk|{addr[0]}:{addr[1]}", "bulk_pull")
        except faultinject.FaultInjectedError as e:
            raise BulkError(str(e)) from None
        if drop:
            raise BulkError(
                f"injected bulk-pull loss for {object_id} from {addr}")
    if sock is None:
        sock = socket.create_connection(addr, timeout=60)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.sendall(_encode_request(object_id, start, length))
    hdr = _recv_exact(sock, _RSP_HDR.size)
    if hdr is None:
        raise BulkError(f"bulk source {addr} closed mid-pull")
    n = _RSP_HDR.unpack(hdr)[0]
    if n < 0:
        msg = _recv_exact(sock, -n) or b"?"
        raise BulkError(msg.decode(errors="replace"))
    if n != length:
        raise BulkError(f"source returned {n} bytes, wanted {length}")
    if not _recv_into_exact(sock, buf):
        raise BulkError(f"bulk source {addr} closed mid-payload")
    return sock


def _pull_stripe(addr: tuple, object_id: str, view: memoryview, start: int,
                 length: int, retry) -> None:
    """One stripe, retried per the policy (fresh connection each
    attempt — a reset socket is never reused)."""

    def _attempt(_budget):
        sock = pull_into(addr, object_id, view, start, length)
        try:
            sock.close()
        except OSError:
            pass

    if retry is None:
        _attempt(None)
    else:
        retry.run(_attempt, retry_on=(BulkError, OSError),
                  describe=f"bulk pull {object_id}[{start}:{start+length}]")


def pull_object(addr: tuple, object_id: str, size: int,
                streams: int = 4, stripe_min: int = 8 << 20,
                retry=None, out=None):
    """Pull a whole object with up to ``streams`` parallel stripe
    connections (one connection when the object is small). ``retry``
    (a retry.RetryPolicy) makes each stripe survive transient resets /
    injected drops with backoff instead of failing the whole pull.
    ``out`` (optional) receives the bytes in place — pass an arena view
    to land the payload directly in a store (relay caching without a
    second copy); by default a fresh non-zeroed buffer is returned."""
    if out is None:
        out = alloc_pull_buffer(size)
    mv = memoryview(out)
    if mv.nbytes != size:
        raise ValueError(f"out buffer is {mv.nbytes} bytes, want {size}")
    n_streams = max(1, min(streams, size // stripe_min))
    if n_streams == 1:
        _pull_stripe(addr, object_id, mv, 0, size, retry)
        return out
    stripe = (size + n_streams - 1) // n_streams
    errors: list = []

    def _one(i: int) -> None:
        s, e = i * stripe, min((i + 1) * stripe, size)
        try:
            _pull_stripe(addr, object_id, mv[s:e], s, e - s, retry)
        except Exception as exc:  # noqa: BLE001 — reraised below
            errors.append(exc)

    threads = [threading.Thread(target=_one, args=(i,), daemon=True)
               for i in range(n_streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
