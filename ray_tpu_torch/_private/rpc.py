"""Control-plane RPC: framed, bidirectional messaging over TCP.

Counterpart of the reference's gRPC wrapper layer (reference: src/ray/rpc/,
5.9k LoC; client pools in rpc/worker/core_worker_client_pool.h). The control
plane rides DCN/loopback TCP; the data plane (tensors) never touches this —
it uses XLA collectives over ICI (SURVEY.md §5 "Distributed communication
backend").

Frame: [u32 length][payload]. The payload is pickled (kind, msg_id,
body) on the cold path, or — for HOT kinds, to peers that negotiated it
— the compact binary frame format from wirefmt.py (leading 0xA9 magic;
a pickle stream always leads with 0x80, so the reader self-detects).
Each connection is bidirectional: either side can issue requests
("call") and push one-way notifications ("cast"). A reader thread per
connection dispatches to the registered handler; replies resolve
per-call futures.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Callable

from ray_tpu_torch._private import evloop, faultinject, wirefmt

_HDR = struct.Struct("<I")

_cfg = None


def _config():
    global _cfg
    if _cfg is None:
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        _cfg = GLOBAL_CONFIG
    return _cfg

REPLY = "__reply__"
ERROR = "__error__"
CAST_BATCH = "__cast_batch__"


class _CastFlusher:
    """Module-global flusher for buffered casts: bounds the latency of a
    lone ``cast_buffered`` (a sender that buffers and then goes quiet) to
    ~1 ms without a timer thread per connection. Connections register
    when their buffer becomes non-empty; under a sustained burst the
    flusher keeps the connection HOT (drained every pass) so senders
    skip the register lock/notify churn entirely until it goes quiet."""

    # Passes a hot connection may sit with an empty buffer before it is
    # dropped back to register()-driven tracking.
    _IDLE_PASSES = 8

    def __init__(self):
        self._pending: set = set()
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None

    def register(self, conn: "Connection") -> None:
        if conn._flusher_hot:
            return  # already on the hot list: the loop will drain it
        with self._cond:
            self._pending.add(conn)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="rpc-cast-flush")
                self._thread.start()
            self._cond.notify()

    def _loop(self) -> None:
        import time as _time

        hot: dict = {}  # conn -> consecutive empty passes
        while True:
            with self._cond:
                while not self._pending and not hot:
                    self._cond.wait()
                for c in self._pending:
                    hot[c] = 0
                    c._flusher_hot = True
                self._pending.clear()
            # Tiny coalescing window: lets a burst in progress finish
            # filling the buffer so the flush ships one big frame.
            # (time.sleep, not a fresh threading.Event per pass — the
            # Event allocated a lock + object per millisecond forever.)
            _time.sleep(0.001)
            for c in list(hot):
                try:
                    had = bool(c._cast_buf)
                    if had:
                        c.flush_casts()
                        hot[c] = 0
                    else:
                        hot[c] += 1
                except Exception:
                    hot[c] = self._IDLE_PASSES
                if hot[c] >= self._IDLE_PASSES or c.closed:
                    # Quiet (or dead): stop polling it. Order matters:
                    # clear the flag FIRST, then re-check the buffer — a
                    # cast_buffered racing the drop either sees the
                    # cleared flag and registers itself, or its item is
                    # already in the buffer and the re-check re-adopts.
                    c._flusher_hot = False
                    del hot[c]
                    if c._cast_buf and not c.closed:
                        self.register(c)


_cast_flusher = _CastFlusher()


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class DeferredReply:
    """Returned by a handler to move its (slow) body OFF the
    connection's reader thread: ``run`` executes on a dedicated thread
    and its return value / exception becomes the reply. Without this, a
    long-blocking handler stalls every other message multiplexed on the
    same connection."""

    def __init__(self, run):
        self._run = run


class Connection:
    """One bidirectional framed-message connection.

    handler(kind, body, conn) is invoked on the reader thread for every
    non-reply message; its return value (for `call`s) is sent back as a reply.
    Handlers that may block should offload to their own executor.
    """

    def __init__(
        self,
        sock: socket.socket,
        handler: Callable[[str, dict, "Connection"], Any] | None = None,
        on_close: Callable[["Connection"], None] | None = None,
        name: str = "",
    ):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._handler = handler
        self._on_close = on_close
        self.name = name
        self.peer_info: dict = {}  # set during registration by the server
        # Cheap dispatch-plane counters (exposed via
        # ray_tpu_torch.util.metrics.rpc_counters): frames that actually hit
        # the wire, synchronous request/response calls, and a per-kind
        # message census. The frame-count regression guard
        # (tests/test_dispatch_fastpath.py) asserts steady-state direct
        # dispatch adds ZERO per-call frames on the head connection —
        # a deterministic check, not a timing benchmark.
        self.frames_sent = 0
        self.calls_sent = 0
        self.bytes_sent = 0
        self.sent_kinds: dict[str, int] = {}
        # Binary hot-path wire format (wirefmt.py): gates SENDING only
        # (decode is self-detecting). False until the registration /
        # whoami handshake confirms the peer advertised the same wire
        # version — mixed-version peers stay on pickle framing.
        self.wire_binary = False
        self._pending: dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0
        self._closed = threading.Event()
        # Async send plane: _send serializes the message immediately
        # (snapshot semantics — callers may mutate the body after) but
        # the socket write happens on this connection's writer thread.
        # Senders holding big locks (the head's global lock during a
        # dispatch pass) therefore never block on a slow peer's socket;
        # profiling the 100k-task flood showed exactly that convoy:
        # worker seal RPCs queuing behind dispatch's in-lock sendalls.
        import collections as _collections

        self._send_q: "_collections.deque[bytes]" = _collections.deque()
        self._send_q_bytes = 0          # guarded by _sendq_lock
        self._sendq_lock = threading.Lock()
        # Signaled by the writer after it credits drained bytes, so
        # senders blocked at the high-water mark wake exactly when
        # space opens instead of sleep-polling.
        self._sendq_drained = threading.Condition(self._sendq_lock)
        # Cast micro-batching (reference rationale: the per-message gRPC
        # overhead the reference amortizes with its C++ client pools;
        # here one pickled list replaces N framed pickles — ~100x less
        # serialization overhead for flood traffic). Ordering contract:
        # call()/cast() flush the buffer first, so buffered casts are
        # never reordered after a later synchronous message.
        self._cast_buf: list = []
        self._cast_lock = threading.Lock()
        # True while the global cast flusher is actively polling this
        # connection (sustained-burst mode): cast_buffered skips the
        # register() lock/notify round entirely.
        self._flusher_hot = False
        # Serializes buffer-swap + send in flush_casts: without it the
        # global flusher could swap the buffer, get preempted before
        # sending, and let a later direct cast()/call() frame overtake
        # the buffered casts (e.g. a cancel arriving before its task's
        # buffered submit).
        self._flush_lock = threading.Lock()
        self._send_ev = threading.Event()
        self._writer_idle = threading.Event()
        self._writer_idle.set()
        # Native fast lane (evloop.py → src/eventloop): when armed, the
        # reader/writer threads and the cast coalescer live in C
        # pthreads owning a dup() of this socket's fd; Python sees one
        # callback per BATCH of inbound frames (_native_deliver) and
        # hands complete outbound frames to the C send ring. The
        # Python threads below simply aren't started — every slow-path
        # method (dispatch, futures, faultinject, close semantics)
        # is shared between both lanes.
        self._native = None
        self._native_cast_pending = False
        if evloop.lane_enabled():
            mod = evloop.module()
            try:
                self._native = mod.attach(
                    sock.fileno(), self._native_deliver,
                    max(1, int(_config().evloop_ring_mb)) << 20)
            except OSError:
                self._native = None
        if self._native is None:
            self._writer = threading.Thread(target=self._write_loop,
                                            daemon=True,
                                            name=f"rpc-write-{name}")
            self._writer.start()
            self._reader = threading.Thread(
                target=self._read_loop, daemon=True,
                name=f"rpc-read-{name}")
            self._reader.start()

    # --- sending ---

    _SEND_HIGH_WATER_BYTES = 64 << 20  # queued BYTES; past this,
    # senders block (the backpressure the old synchronous sendall gave
    # for free — without it a wedged peer reading nothing while large
    # casts flow, e.g. pubsub fan-out of MB-sized payloads, grows the
    # queue until the process OOMs; a frame count would not bound that)

    def _peer_desc(self) -> str:
        """Descriptor the chaos plane's peer filters match against:
        connection name plus whatever identity registration attached."""
        info = self.peer_info
        parts = [self.name]
        cid = info.get("client_id")
        if cid:
            parts.append(cid)
        t = info.get("type")
        if t:
            parts.append(t)
        nid = info.get("node_agent_for")
        if nid:
            parts.append(f"node_agent_for:{nid}")
        return "|".join(parts)

    def _send(self, kind: str, msg_id: int, body: Any) -> None:
        if self._closed.is_set():
            raise ConnectionLost("connection closed")
        dup = False
        if faultinject.active() is not None:
            # Chaos plane (faultinject.py): a matching rule may delay
            # (slept here, backpressuring the sender like a slow link),
            # drop, duplicate, or reset this frame.
            try:
                drop, dup = faultinject.apply_send(self._peer_desc(), kind)
            except faultinject.FaultInjectedError as e:
                raise ConnectionLost(str(e)) from None
            if drop:
                return  # lost on the wire; recovery is the caller's
                # retry policy (calls) or at-least-once design (casts)
        data = (wirefmt.encode(kind, msg_id, body)
                if self.wire_binary else None)
        if data is None:  # cold kind / exotic body / un-negotiated peer
            data = pickle.dumps((kind, msg_id, body), protocol=5)
        frame = _HDR.pack(len(data)) + data
        # Counter writes are racy-but-monotonic ints (GIL-atomic enough
        # for a regression guard; exactness is not load-bearing).
        self.frames_sent += 1
        self.bytes_sent += len(frame)
        self.sent_kinds[kind] = self.sent_kinds.get(kind, 0) + 1
        if self._native is not None:
            # Native ring: blocks GIL-free past the high-water mark;
            # False means the lane already observed the peer gone.
            mod = evloop.module()
            ok = mod.send(self._native, frame)
            if dup:
                mod.send(self._native, frame)
            if not ok or self._closed.is_set():
                raise ConnectionLost("connection closed")
            return
        with self._sendq_lock:
            while (self._send_q_bytes > self._SEND_HIGH_WATER_BYTES
                   and not self._closed.is_set()):
                self._sendq_drained.wait(timeout=1.0)
            if self._closed.is_set():
                raise ConnectionLost("connection closed")
            self._send_q.append(frame)
            self._send_q_bytes += len(frame)
            if dup:  # injected duplication (at-least-once chaos)
                self._send_q.append(frame)
                self._send_q_bytes += len(frame)
        self._send_ev.set()
        if self._closed.is_set():
            # _shutdown raced the append: the writer may already have
            # exited, so this frame might never go out — surface it the
            # way the old synchronous path did.
            raise ConnectionLost("connection closed")

    def _write_loop(self) -> None:
        while True:
            self._send_ev.wait()
            self._send_ev.clear()
            while self._send_q:
                self._writer_idle.clear()
                # Coalesce everything queued into ONE sendall: under
                # backlog this amortizes the syscall and the thread
                # handoff across many messages.
                frames = []
                batch_bytes = 0
                while True:
                    try:
                        f = self._send_q.popleft()
                    except IndexError:
                        break
                    frames.append(f)
                    batch_bytes += len(f)
                try:
                    self._sock.sendall(b"".join(frames))
                except OSError:
                    # Peer gone on the SEND side (the reader may still
                    # be parked in recv): run the full teardown so
                    # pending calls fail fast and on_close dead-peer
                    # pruning fires, exactly like the old synchronous
                    # ConnectionLost.
                    with self._sendq_lock:
                        self._send_q.clear()
                        self._send_q_bytes = 0
                        self._sendq_drained.notify_all()
                    self._writer_idle.set()
                    self._shutdown()
                    return
                # Credit the watermark only after the bytes hit the
                # socket, so blocked senders stay coupled to actual
                # drain progress, not just queue hand-off.
                with self._sendq_lock:
                    self._send_q_bytes -= batch_bytes
                    self._sendq_drained.notify_all()
                if not self._send_q:
                    self._writer_idle.set()
            if self._closed.is_set() and not self._send_q:
                return

    CAST_BATCH_MAX = 512

    def cast_buffered(self, kind: str, body: dict | None = None) -> None:
        """Buffered one-way notification: coalesced with other buffered
        casts into one CAST_BATCH frame. Flushed by the next call()/
        cast() on this connection (ordering preserved), when the buffer
        reaches CAST_BATCH_MAX, or by the global ~1 ms flusher.

        Native lane: binary-encodable records hand their already-tagged
        payload bytes to the C coalescer (same adjacent-merge + batch
        semantics, flushed by the native ~1 ms flusher) and Python is
        done in one encode. Records the lane cannot carry — pickle-only
        kinds/bodies, an un-negotiated peer — and EVERY record while
        the chaos plane is armed take today's Python buffer, so
        faultinject.apply_send keeps seeing each flushed frame with its
        real kind. The two buffers never interleave out of order: each
        entry point drains the other buffer before switching."""
        if (self._native is not None and self.wire_binary
                and faultinject.active() is None):
            payload = wirefmt.cast_payload(wirefmt.encode(kind, 0,
                                                          body or {}))
            if payload is not None:
                if self._cast_buf:
                    self.flush_casts()  # ordering hand-off Python→C
                # Record census at buffer time (the C flusher's merged
                # frames fold in via _sync_native_counters).
                self.sent_kinds[kind] = self.sent_kinds.get(kind, 0) + 1
                self._native_cast_pending = True
                if not evloop.module().cast(
                        self._native, wirefmt.KIND_CODES[kind], payload):
                    raise ConnectionLost("connection closed")
                return
        if self._native is not None and self._native_cast_pending:
            # ordering hand-off C→Python before buffering the cold one
            self._native_cast_pending = False
            evloop.module().flush(self._native)
        with self._cast_lock:
            self._cast_buf.append((kind, body or {}))
            n = len(self._cast_buf)
        if n >= self.CAST_BATCH_MAX:
            self.flush_casts()
        elif n == 1:
            _cast_flusher.register(self)

    def _sync_native_counters(self) -> None:
        """Fold the C flusher's frame/byte counts into the Python
        counters (delta-and-reset, so folding is idempotent-safe from
        any caller: flush, close, metrics scrape)."""
        if self._native is None:
            return
        try:
            fr, by = evloop.module().take_counters(self._native)
        except Exception:
            return
        if fr:
            self.frames_sent += fr
            self.bytes_sent += by

    def take_native_acks(self) -> list:
        """Task ids whose direct_ack frames the native reader consumed
        (ack sink). Empty unless set_ack_sink(True) armed the sink."""
        if self._native is None:
            return []
        try:
            return evloop.module().take_acks(self._native)
        except Exception:
            return []

    def set_ack_sink(self, on: bool) -> None:
        """Owner-side fast path: when on, inbound top-level direct_ack
        casts are parsed and retained entirely in C (drained via
        take_native_acks) instead of waking Python per frame. direct_rej
        and batched acks still deliver normally. No-op without the
        native lane."""
        if self._native is None:
            return
        try:
            evloop.module().set_ack_sink(self._native, bool(on))
        except Exception:
            pass

    def flush_casts(self) -> None:
        if self._native is not None and self._native_cast_pending:
            # Synchronous barrier before calls/casts: the C flusher
            # merges + frames whatever is buffered NOW, preserving the
            # buffered-cast-before-later-call ordering contract.
            self._native_cast_pending = False
            evloop.module().flush(self._native)
            self._sync_native_counters()
        with self._flush_lock:
            with self._cast_lock:
                if not self._cast_buf:
                    return
                buf, self._cast_buf = self._cast_buf, []
            # Seal/ack coalescing (wirefmt.coalesce_casts): consecutive
            # same-kind records (delivery acks, seal batches) merge into
            # ONE frame with N records — flood traffic stops paying
            # per-record framing. Only adjacent records merge, so the
            # buffered order across kinds is preserved, and the merged
            # frame carries its REAL kind, so the chaos plane's per-kind
            # matching (faultinject.apply_send in _send) sees seal/ack
            # frames it previously only saw as opaque CAST_BATCHes.
            if _config().wire_coalesce:
                merged = wirefmt.coalesce_casts(buf)
            else:
                merged = [(k, b, 1) for k, b in buf]
            if len(merged) == 1:
                k, b, n = merged[0]
                if n > 1:
                    # Per-kind census counts RECORDS (rpc_counters must
                    # stay truthful under merging); _send adds the 1.
                    self.sent_kinds[k] = self.sent_kinds.get(k, 0) + n - 1
                self._send(k, 0, b)
            else:
                for k, _b, n in merged:
                    self.sent_kinds[k] = self.sent_kinds.get(k, 0) + n
                self._send(CAST_BATCH, 0,
                           [(k, b) for k, b, _n in merged])

    def call(self, kind: str, body: dict | None = None,
             timeout: float | None = None, retry=None) -> Any:
        """Request/response; raises RpcError on remote exception.

        ``retry`` (a retry.RetryPolicy) turns the call into a retried
        idempotent operation: each attempt is a FRESH request (new
        msg_id — a late reply to a superseded attempt is discarded by
        the pending-map pop), timeouts and transient resets back off
        per the policy, and the policy's deadline bounds the whole
        exchange. Only pass it for calls safe to execute at-least-once.
        With ``retry`` given, ``timeout`` caps one attempt, not the
        whole operation."""
        if retry is None:
            return self._call_once(kind, body, timeout)
        import time as _time

        deadline = (None if retry.deadline_s is None
                    else _time.monotonic() + retry.deadline_s)
        last: BaseException | None = None
        for attempt in range(1, retry.max_attempts + 1):
            budget = retry.attempt_timeout_s
            if timeout is not None:
                budget = timeout if budget is None else min(budget, timeout)
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                budget = remaining if budget is None else min(budget,
                                                              remaining)
            try:
                return self._call_once(kind, body, budget)
            except _FutTimeout as e:
                last = e
            except ConnectionLost as e:
                if self._closed.is_set():
                    raise  # socket is gone for good: resending here is
                    # hopeless — the caller owns re-dialing
                last = e  # injected/transient reset: retry
            if attempt < retry.max_attempts:
                _time.sleep(retry.delay(attempt))
        if last is None:
            last = _FutTimeout(f"call {kind!r}: retry deadline exhausted")
        raise last

    def _call_once(self, kind: str, body: dict | None,
                   timeout: float | None) -> Any:
        self.flush_casts()
        self.calls_sent += 1
        fut: Future = Future()
        with self._pending_lock:
            self._next_id += 1
            msg_id = self._next_id
            self._pending[msg_id] = fut
        try:
            self._send(kind, msg_id, body or {})
            return fut.result(timeout)
        finally:
            with self._pending_lock:
                self._pending.pop(msg_id, None)

    def cast(self, kind: str, body: dict | None = None) -> None:
        """One-way notification."""
        self.flush_casts()
        self._send(kind, 0, body or {})

    # --- receiving ---

    def _recv_exact(self, n: int) -> bytes | None:
        chunks = []
        while n:
            try:
                chunk = self._sock.recv(min(n, 1 << 20))
            except OSError:
                return None
            if not chunk:
                return None
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _native_deliver(self, batch) -> bool:
        """Inbound dispatch for the native lane: called from the C
        reader thread with a LIST of frames — each either an already-
        decoded ``(kind, msg_id, payload)`` tuple (binary hot frame) or
        raw frame bytes (pickle stream, exotic body, or anything the C
        decoder declined: Python replays the decode so there is exactly
        ONE source of error semantics). ``None`` means EOF. Returning
        False stops the C reader; mirrors _read_loop line for line."""
        if batch is None:
            self._shutdown()
            return False
        for item in batch:
            if type(item) is tuple:
                kind, msg_id, payload = item
            else:
                try:
                    if item and item[0] == wirefmt.WIRE_MAGIC:
                        kind, msg_id, payload = wirefmt.decode_frame(item)
                    else:
                        kind, msg_id, payload = pickle.loads(item)
                except Exception:
                    import sys

                    print(f"[rpc] {self.name}: closing on undecodable "
                          f"frame:\n{traceback.format_exc()}",
                          file=sys.stderr)
                    self._shutdown()
                    return False
            if faultinject.active() is not None and faultinject.apply_recv(
                    self._peer_desc(), kind):
                continue  # injected recv-side loss
            if kind == REPLY or kind == ERROR:
                with self._pending_lock:
                    fut = self._pending.pop(msg_id, None)
                if fut is not None:
                    if kind == ERROR:
                        fut.set_exception(RpcError(payload))
                    else:
                        fut.set_result(payload)
                continue
            self._dispatch(kind, msg_id, payload)
        return not self._closed.is_set()

    def _read_loop(self) -> None:
        while not self._closed.is_set():
            hdr = self._recv_exact(_HDR.size)
            if hdr is None:
                break
            body = self._recv_exact(_HDR.unpack(hdr)[0])
            if body is None:
                break
            try:
                if body and body[0] == wirefmt.WIRE_MAGIC:
                    kind, msg_id, payload = wirefmt.decode_frame(body)
                else:
                    kind, msg_id, payload = pickle.loads(body)
            except Exception:
                # Corrupt/undecodable frame (wirefmt raises the typed
                # WireDecodeError; a poisoned pickle raises its own):
                # frame sync on this stream cannot be trusted anymore —
                # close the connection (pending calls fail fast, the
                # peer re-dials) instead of killing the reader thread
                # with the pending map still armed (which would HANG
                # every outstanding call forever).
                import sys

                print(f"[rpc] {self.name}: closing on undecodable frame:"
                      f"\n{traceback.format_exc()}", file=sys.stderr)
                break
            if faultinject.active() is not None and faultinject.apply_recv(
                    self._peer_desc(), kind):
                continue  # injected recv-side loss
            if kind == REPLY or kind == ERROR:
                with self._pending_lock:
                    fut = self._pending.pop(msg_id, None)
                if fut is not None:
                    if kind == ERROR:
                        fut.set_exception(RpcError(payload))
                    else:
                        fut.set_result(payload)
                continue
            self._dispatch(kind, msg_id, payload)
        self._shutdown()

    def _finish_deferred(self, deferred: "DeferredReply",
                         msg_id: int) -> None:
        try:
            result = deferred._run()
            if msg_id:
                self._send(REPLY, msg_id, result)
        except ConnectionLost:
            pass
        except Exception:
            if msg_id:
                try:
                    self._send(ERROR, msg_id, traceback.format_exc())
                except ConnectionLost:
                    pass

    def _dispatch(self, kind: str, msg_id: int, payload: dict) -> None:
        if kind == CAST_BATCH:
            for k, b in payload:
                self._dispatch(k, 0, b)
            return
        try:
            result = self._handler(kind, payload, self) if self._handler else None
            if isinstance(result, DeferredReply):
                # Slow handler: finish on a dedicated thread so this
                # connection's reader keeps dispatching other messages.
                threading.Thread(
                    target=self._finish_deferred, args=(result, msg_id),
                    daemon=True, name="rpc-deferred").start()
                return
            if msg_id:
                self._send(REPLY, msg_id, result)
        except ConnectionLost:
            pass
        except Exception:
            if msg_id:
                try:
                    self._send(ERROR, msg_id, traceback.format_exc())
                except ConnectionLost:
                    pass
            else:
                # A failed cast has no reply channel — losing the error makes
                # protocol bugs invisible. Surface it loudly.
                import sys

                print(
                    f"[rpc] handler for cast {kind!r} raised:\n{traceback.format_exc()}",
                    file=sys.stderr,
                )

    def _shutdown(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        if self._native is not None:
            self._sync_native_counters()
            try:
                evloop.module().close(self._native)
            except Exception:
                pass
        self._send_ev.set()  # wake the writer so it can exit
        with self._sendq_lock:
            # Wake senders parked at the high-water mark: the queue
            # will never drain now, they must raise ConnectionLost.
            self._sendq_drained.notify_all()
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(ConnectionLost("connection closed"))
        try:
            self._sock.close()
        except OSError:
            pass
        if self._on_close:
            try:
                self._on_close(self)
            except Exception:
                pass

    def close(self) -> None:
        # Bounded drain: messages cast just before close (final
        # read_done/del_ref notifications) should still go out — both
        # the queued frames AND a batch the writer already popped and is
        # mid-sendall on (writer_idle covers that window).
        import time as _time

        try:
            self.flush_casts()
        except ConnectionLost:
            pass
        if self._native is not None:
            try:
                evloop.module().drain(self._native, 2.0)
            except Exception:
                pass
            self._sync_native_counters()
        else:
            deadline = _time.monotonic() + 2.0
            while ((self._send_q or not self._writer_idle.is_set())
                   and _time.monotonic() < deadline
                   and not self._closed.is_set()):
                _time.sleep(0.005)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._shutdown()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


class Server:
    """Accepts connections; each gets the shared handler."""

    def __init__(
        self,
        handler: Callable[[str, dict, Connection], Any],
        on_connect: Callable[[Connection], None] | None = None,
        on_close: Callable[[Connection], None] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self._handler = handler
        self._on_connect = on_connect
        self._on_close = on_close
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(512)
        self.address = self._sock.getsockname()
        self.connections: list[Connection] = []
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="rpc-accept")
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                break
            conn = Connection(sock, self._handler, self._remove, name=str(addr))
            with self._lock:
                self.connections.append(conn)
            if self._on_connect:
                self._on_connect(conn)

    def _remove(self, conn: Connection) -> None:
        with self._lock:
            if conn in self.connections:
                self.connections.remove(conn)
        if self._on_close:
            self._on_close(conn)

    def adopt_socket(self, sock: socket.socket,
                     first_frame: "bytes | None" = None,
                     adopt_meta: "dict | None" = None) -> Connection:
        """Adopt an already-accepted socket as if this server had
        accepted it — the sharded head's router accepts on the
        advertised address, reads ONE frame to pick a shard, then hands
        the fd over SCM_RIGHTS; the shard re-enters it here. The frame
        the router consumed is replayed through the normal dispatch
        path so the peer sees exactly one handler pass, and
        ``adopt_meta`` (pre-assigned client id, routed identity) rides
        on the connection for the registration handler. Safe against
        reordering because registration is a synchronous call: the peer
        sends nothing else until the replayed frame's reply arrives."""
        try:
            name = str(sock.getpeername())
        except OSError:
            name = "adopted"
        conn = Connection(sock, self._handler, self._remove, name=name)
        if adopt_meta:
            conn.adopt_meta = adopt_meta
        with self._lock:
            self.connections.append(conn)
        if self._on_connect:
            self._on_connect(conn)
        if first_frame:
            def _replay(frame=first_frame, conn=conn):
                try:
                    if frame and frame[0] == wirefmt.WIRE_MAGIC:
                        kind, msg_id, payload = wirefmt.decode_frame(frame)
                    else:
                        kind, msg_id, payload = pickle.loads(frame)
                except Exception:
                    conn.close()
                    return
                conn._dispatch(kind, msg_id, payload)

            threading.Thread(target=_replay, daemon=True,
                             name="rpc-adopt").start()
        return conn

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self.connections)
        for c in conns:
            c.close()


def connect(address: tuple[str, int], handler=None, on_close=None,
            name: str = "", retry=None) -> Connection:
    """Dial a peer. ``retry`` (a retry.RetryPolicy) backs off transient
    dial failures (connection refused mid-restart, injected resets)
    instead of failing on the first; the policy's deadline bounds the
    whole dial. The connect timeout itself comes from config
    (rpc_connect_timeout_s) instead of the old hardcoded 30 s."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

    def _dial(budget: "float | None") -> socket.socket:
        sock = socket.create_connection(
            address, timeout=budget or _cfg.rpc_connect_timeout_s)
        sock.settimeout(None)
        return sock

    if retry is None:
        sock = _dial(_cfg.rpc_connect_timeout_s)
    else:
        sock = retry.run(_dial, retry_on=(OSError,),
                         describe=f"connect {address}")
    return Connection(sock, handler, on_close, name=name)
