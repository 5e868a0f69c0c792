"""Cross-node compiled-DAG channels over TCP (port of
ray_tpu/experimental/tcp_channel.py).

The lane between actors on DIFFERENT nodes, with the shm channel's ring
semantics: single writer, fixed reader set, ``num_slots`` of run-ahead
per reader, a write blocks while the slowest reader is a full ring
behind (write-acquire), end_read acks (read-release).

Wire format: ``<u64 len><payload>`` frames; ``len == CLOSE`` tears the
channel down; each ack is one byte back on the same socket.

The WRITER owns the listening socket (created where the data is
produced); readers dial its advertised endpoint. Endpoints travel
through the compiled DAG's two-phase setup (dag/nodes.py), not by
pickling the channel object. Values go through the port's
serialization, as on the shm channel.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Any

from ray_tpu_torch._private import serialization
from ray_tpu_torch.experimental.channel import ChannelClosed, ChannelTimeout

_CLOSE = (1 << 64) - 1
_LEN = struct.Struct("<Q")


def advertise_ip() -> str:
    """The IP other nodes should dial to reach this one: RAY_TPU_NODE_IP
    (a multi-node cluster sets it on each node), else loopback. The port
    never probes a route to find one (ray_tpu connects a UDP socket
    toward 10.255.255.255 to pick the outbound interface)."""
    return os.environ.get("RAY_TPU_NODE_IP") or "127.0.0.1"


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    pos = 0
    while pos < n:
        got = sock.recv_into(view[pos:], n - pos)
        if got == 0:
            raise ChannelClosed("peer closed the channel socket")
        pos += got
    return bytes(buf)


class TcpChannelServer:
    """Writer side: listener + per-reader ack windows."""

    def __init__(self, name: str, num_readers: int = 1, num_slots: int = 4):
        self.name = name
        self.num_readers = num_readers
        self.num_slots = num_slots
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("0.0.0.0", 0))
        self._lsock.listen(num_readers)
        self.endpoint = (advertise_ip(), self._lsock.getsockname()[1])
        self._lock = threading.Condition()
        self._conns: list[socket.socket] = []
        self._unacked: dict[socket.socket, int] = {}
        self._dead = False
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"chan-accept-{name[-8:]}").start()

    def _accept_loop(self) -> None:
        try:
            for _ in range(self.num_readers):
                conn, _addr = self._lsock.accept()
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with self._lock:
                    self._conns.append(conn)
                    self._unacked[conn] = 0
                    self._lock.notify_all()
                threading.Thread(target=self._ack_loop, args=(conn,),
                                 daemon=True,
                                 name=f"chan-ack-{self.name[-8:]}").start()
        except OSError:
            pass  # listener closed during teardown

    def _ack_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                if not conn.recv(1):
                    break
                with self._lock:
                    self._unacked[conn] -= 1
                    self._lock.notify_all()
        except OSError:
            pass
        with self._lock:
            # Reader gone: a live pipeline cannot make progress — treat
            # as closed (matches the shm channel's closed-wakes-writers).
            if not self._closed:
                self._dead = True
            self._lock.notify_all()

    def write(self, value: Any, timeout_s: float = 60.0) -> None:
        # Serialize straight into the framed buffer: one allocation, no
        # header+payload concat copy (matters at MiB message sizes).
        header, buffers = serialization.serialize(value)
        size = serialization.serialized_size(header, buffers)
        frame = bytearray(8 + size)
        _LEN.pack_into(frame, 0, size)
        serialization.write_to(memoryview(frame)[8:], header, buffers)
        import time as _time

        deadline = _time.monotonic() + timeout_s
        with self._lock:
            while True:
                if self._closed or self._dead:
                    raise ChannelClosed(self.name)
                ready = (len(self._conns) == self.num_readers and all(
                    self._unacked[c] < self.num_slots for c in self._conns))
                if ready:
                    break
                left = deadline - _time.monotonic()
                if left <= 0:
                    raise ChannelTimeout(
                        f"write on {self.name}: readers did not ack within "
                        f"{timeout_s}s")
                self._lock.wait(min(left, 0.2))
            for c in self._conns:
                self._unacked[c] += 1
            conns = list(self._conns)
        for c in conns:
            try:
                c.sendall(frame)
            except OSError:
                with self._lock:
                    self._dead = True
                raise ChannelClosed(self.name) from None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = list(self._conns)
            self._lock.notify_all()
        for c in conns:
            try:
                c.sendall(_LEN.pack(_CLOSE))
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        try:
            self._lsock.close()
        except OSError:
            pass

    def unlink(self) -> None:  # API parity with the shm Channel
        pass


class TcpChannelReader:
    """Reader side: dial the writer; begin_read/end_read mirror the shm
    channel's ReadAcquire/ReadRelease."""

    # Values from begin_read own their buffer (fresh recv allocation) —
    # unlike shm slots, they stay valid after end_read, so consumers can
    # skip defensive copies.
    owns_payload = True

    def __init__(self, name: str, endpoint: tuple, connect_timeout_s:
                 float = 20.0):
        self.name = name
        self._sock = socket.create_connection(
            (endpoint[0], int(endpoint[1])), timeout=connect_timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reading = False

    def begin_read(self, timeout_s: float = 60.0) -> Any:
        if self._reading:
            raise RuntimeError("begin_read without end_read")
        self._sock.settimeout(timeout_s)
        try:
            head = _recv_exact(self._sock, 8)
        except (socket.timeout, TimeoutError):
            raise ChannelTimeout(
                f"no message on {self.name} within {timeout_s}s") from None
        except OSError:
            raise ChannelClosed(self.name) from None
        (n,) = _LEN.unpack(head)
        if n == _CLOSE:
            raise ChannelClosed(self.name)
        # Frame started: allow ample time for the body regardless of the
        # first-byte timeout.
        self._sock.settimeout(max(timeout_s, 120.0))
        try:
            payload = _recv_exact(self._sock, n)
        except (socket.timeout, TimeoutError, OSError):
            raise ChannelClosed(self.name) from None
        self._reading = True
        return serialization.loads(payload)

    def end_read(self) -> None:
        if not self._reading:
            raise RuntimeError("end_read without begin_read")
        self._reading = False
        try:
            self._sock.sendall(b"\x01")
        except OSError:
            raise ChannelClosed(self.name) from None

    def read(self, timeout_s: float = 60.0) -> Any:
        value = self.begin_read(timeout_s)
        self.end_read()
        return value

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def unlink(self) -> None:  # API parity
        pass
