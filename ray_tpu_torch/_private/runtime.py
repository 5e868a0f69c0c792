"""Client-side core runtime: the in-process library of every driver/worker.

Counterpart of the reference's CoreWorker
(reference: src/ray/core_worker/core_worker.h:172 — task submission, object
put/get, ownership; Python binding _raylet.pyx:2974). Scoped down: ownership
bookkeeping lives in the head's ObjectDirectory; this side tracks owned refs
(GC → del_ref), resolves get/wait futures pushed back by the head, and reads
shm payloads zero-copy before copying out.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
import time
import uuid
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Sequence

import cloudpickle

from ray_tpu_torch._private import dataplane as _dp
from ray_tpu_torch._private import faultinject
from ray_tpu_torch._private import ids as ids_mod
from ray_tpu_torch._private import rpc, serialization
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.shm_store import ShmClient
from ray_tpu_torch._private.task_spec import ActorSpec, TaskSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    PendingCallsLimitError,
    RayTpuError,
    TaskError,
    TaskTimeoutError,
    WorkerCrashedError,
)

_ERROR_KINDS = {
    "worker_crashed": WorkerCrashedError,
    "actor_died": ActorDiedError,
    "task_error": RayTpuError,
    "object_lost": ObjectLostError,
    "task_timeout": TaskTimeoutError,
    "pending_calls_limit": PendingCallsLimitError,
}


# Owner-store sentinel: the result was too big to inline and lives in
# the head/agent store — resolve it through a head meta (or, when the
# slot carries a metadata-only seal's location record, straight from
# the holder node with zero head frames).
_REMOTE = object()

# "Not servable on this path" sentinel for the zero-copy p2p probe
# (None is a legitimate deserialized value).
_MISS = object()


class _ShmReadPin:
    """One zero-copy read's deferred release. Each out-of-band buffer is
    wrapped in a weakref-able uint8 array; the reconstructed user arrays
    hold those wrappers through their .base chains, so a finalizer per
    wrapper counts down exactly when the last aliasing array dies — at
    zero the store views are released and the head's read pin dropped.
    Buffers that pickle COPIES from (bytes/bytearray payloads) drop
    their wrapper at the first gc after loads, releasing promptly."""

    __slots__ = ("hex_id", "runtime", "outstanding", "lock", "views",
                 "released")

    def __init__(self, hex_id: str, runtime, views):
        self.hex_id = hex_id
        self.runtime = runtime
        self.outstanding = 0
        self.lock = threading.Lock()
        self.views = views
        self.released = False

    def track(self, n: int) -> None:
        self.outstanding = n

    def dec(self) -> None:
        with self.lock:
            self.outstanding -= 1
            if self.outstanding > 0 or self.released:
                return
            self.released = True
        self._release_views_and_pin()

    def release_now(self) -> None:
        """Immediate release (no-buffer and error paths)."""
        with self.lock:
            if self.released:
                return
            self.released = True
        self._release_views_and_pin()

    def _release_views_and_pin(self) -> None:
        for v in self.views:
            try:
                v.release()
            except BufferError:
                pass
        try:
            self.runtime.conn.cast("read_done", {"ids": [self.hex_id]})
        except Exception:
            pass  # connection gone: the head reaps pins with the client


class CoreRuntime:
    def __init__(
        self,
        address: tuple[str, int],
        client_type: str = "driver",
        worker_id: str | None = None,
        message_handler: Callable[[str, dict], Any] | None = None,
        force_remote: bool = False,
    ):
        self._waiters: dict[str, Future] = {}
        self._waiters_lock = threading.Lock()
        # Worker-installed hook invoked before a blocking get/wait (the
        # pipelined-task deadlock escape — see Worker._on_will_block).
        self._pre_block = None
        # Overload protection: head-signalled backpressure horizon
        # (monotonic). While in the future, submits block (default) or
        # fast-fail per admission_mode. Set by "backpressure" casts.
        self._backpressure_until = 0.0
        # Worker-installed hook for direct-plane cancellation pushed
        # over a peer connection ("cancel_direct").
        self._peer_cancel_handler = None
        self._message_handler = message_handler
        self._closed = False
        self.client_type = client_type
        self.address = address  # head (host, port) — job drivers reconnect here
        # --- owner plane (reference: core_worker.h:172 ownership — the
        # SUBMITTER of a task owns its results). Every runtime hosts a
        # tiny server; executors deliver inline results straight here
        # and borrowers/peers fetch values from the owner, so result
        # payloads never transit the head (it keeps a slim directory
        # entry only, for dependency wakeup and liveness).
        self._owned_store: dict[str, tuple] = {}
        self._owned_cond = threading.Condition()
        # Return ids of tasks this runtime submitted whose results have
        # not yet reached the owner plane. get() waits LOCALLY on these
        # — every outcome is delivered here (inline payload, "stored
        # big, ask the head" marker, or a head-pushed error seal), so
        # the head never serves the owner's own result lookups.
        self._expected_owned: "set[str]" = set()
        self._owned_waiters = 0  # getters in the local wait loop
        # Recently-freed owned ids: a seal can arrive AFTER the local
        # ref died (fire-and-forget submit) — without the tombstone the
        # payload would be orphaned in _owned_store forever.
        self._dead_owned: "set[str]" = set()
        self._dead_owned_fifo: "list[str]" = []
        self._owner_conns: dict[tuple, rpc.Connection] = {}
        self._owner_conns_lock = threading.Lock()
        try:
            self.owner_server: "rpc.Server | None" = rpc.Server(
                self._handle_peer, host="0.0.0.0")
        except OSError:
            self.owner_server = None
        self.owner_addr: "tuple[str, int] | None" = None
        self.conn = rpc.connect(address, handler=self._handle,
                                name=client_type, on_close=self._on_conn_lost)
        if self.owner_server is not None:
            # Advertise the interface this host reaches the head from —
            # remote workers connect back to it for result delivery.
            try:
                adv_ip = self.conn._sock.getsockname()[0]
            except OSError:
                adv_ip = "127.0.0.1"
            self.owner_addr = (adv_ip, self.owner_server.address[1])
        # Off-host clients (ray:// drivers, or forced-remote for tests)
        # skip the shm fast path; the head ships object payloads inline
        # over the connection.
        can_shm = not force_remote and os.environ.get("RAY_TPU_REMOTE") != "1"
        from ray_tpu_torch._private.retry import default_policy
        from ray_tpu_torch._private.task_spec import _specenc

        # Registration is idempotent on one connection (the head drops a
        # stale same-conn registration), so it rides the unified retry
        # policy — a dropped/delayed register frame under injected
        # faults backs off and resends instead of failing init.
        reg = self.conn.call(
            "register",
            {"client_type": client_type, "worker_id": worker_id,
             "pid": os.getpid(), "can_shm": can_shm,
             "owner_addr": self.owner_addr,
             "host": _dp.host_id(),
             "specenc": _specenc() is not None,
             "wire": self._wire_version()},
            timeout=GLOBAL_CONFIG.worker_register_timeout_s,
            retry=default_policy(),
        )
        # Compiled-spec negotiation: pack only when the head can unpack
        # (mixed hosts may lack the extension; Makefile skips it there).
        self._head_specenc = bool(reg.get("specenc"))
        # Binary wire negotiation: hot frames to the head go binary
        # only when it advertised the same wire version (wirefmt.py);
        # mixed-version peers keep pickle framing.
        self.conn.wire_binary = (
            reg.get("wire") == self._wire_version() != 0)
        self.client_id = reg["client_id"]
        self.node_id = reg["node_id"]
        self.session_dir = reg["session_dir"]
        # Sharded head (head_shards.py): which dispatch shard this
        # client landed on. 0/1 under a plain single-process head.
        self.head_shard = int(reg.get("shard", 0))
        self.head_shards = int(reg.get("head_shards", 1))
        if reg["shm_name"] is not None:
            try:
                self.shm = ShmClient(reg["shm_name"], reg["shm_capacity"])
            except FileNotFoundError:
                # Same-host assumption failed (container boundary, ...):
                # re-register as a remote client.
                reg = self.conn.call(
                    "register",
                    {"client_type": client_type, "worker_id": worker_id,
                     "pid": os.getpid(), "can_shm": False,
                     "owner_addr": self.owner_addr,
             "host": _dp.host_id(),
                     "specenc": _specenc() is not None,
                     "wire": self._wire_version()},
                    timeout=GLOBAL_CONFIG.worker_register_timeout_s,
                )
                self.client_id = reg["client_id"]
                self.shm = None
        else:
            self.shm = None
        # --- P2P object plane (reference: per-node plasma + chunked
        # pull, pull_manager.h:57): workers on agent-managed nodes store
        # large objects in the NODE's arena and other nodes pull chunks
        # straight from its transfer server — bytes never traverse the
        # head. RAY_TPU_AGENT_STORE=name:capacity:host:port.
        self.agent_shm = None
        self.agent_addr: tuple[str, int] | None = None
        self.agent_store_name: "str | None" = None
        self.agent_store_capacity = 0
        self.agent_bulk_port = 0
        self._agent_conn: rpc.Connection | None = None
        self._peer_conns: dict[tuple, rpc.Connection] = {}
        store_env = os.environ.get("RAY_TPU_AGENT_STORE")
        if store_env and client_type == "worker":
            try:
                # name:capacity:host:port[:bulk_port] — the trailing
                # bulk port (data plane) lets this worker seal
                # metadata-only results that name a pullable holder
                # address; absent with an older agent, results fall
                # back to head-meta resolution.
                parts = store_env.rsplit(":", 4)
                if len(parts) == 5 and parts[4].isdigit():
                    name, cap, host, port, bulk = parts
                else:
                    name, cap, host, port = store_env.rsplit(":", 3)
                    bulk = "0"
                self.agent_shm = ShmClient(name, int(cap))
                self.agent_addr = (host, int(port))
                self.agent_store_name = name
                self.agent_store_capacity = int(cap)
                self.agent_bulk_port = int(bulk)
            except (ValueError, FileNotFoundError):
                self.agent_shm = None
                self.agent_addr = None
        # --- zero-copy data plane (dataplane.py): colocated device-
        # result cache, host-mapped arena attachments for same-host
        # reads, and the transfer byte counters that ride rpc_report.
        from ray_tpu_torch._private import dataplane

        self._dataplane_on = dataplane.enabled()
        self._device_cache = None
        if self._dataplane_on:
            self._device_cache = dataplane.DeviceCache(
                GLOBAL_CONFIG.device_result_cache_entries,
                GLOBAL_CONFIG.device_result_cache_bytes)
        # Host-mapped arenas of OTHER nodes on this host (boot-id
        # match): store name -> ShmClient (None caches an attach
        # failure). RAY_TPU_REMOTE=1 simulates off-host placement, so
        # it disables host mapping too unless RAY_TPU_HOST_SHM=1
        # explicitly re-enables it (benchmarks measuring the colocated
        # fast path on simulated nodes).
        self._host_shms: dict = {}
        self._host_shm_ok = (
            self._dataplane_on and GLOBAL_CONFIG.data_plane_host_shm
            and (os.environ.get("RAY_TPU_REMOTE") != "1"
                 or os.environ.get("RAY_TPU_HOST_SHM") == "1"))
        self._fn_cache: dict[str, Any] = {}
        self._fn_ids: dict = {}  # id(fn) -> (weakref(fn), func_id)
        # Local borrow counts per object id (reference:
        # reference_count.h:72 borrower bookkeeping). The head learns
        # only the 0<->1 transitions; repeat deserializations of the
        # same id in this process stay local.
        #
        # GC discipline: ref releases arrive from __del__, which CPython
        # may run inside ANY allocation — including while this very
        # thread holds _borrows_lock or the connection's send lock. So
        # the __del__ paths only append to a lock-free deque (atomic,
        # never blocks); a flusher thread drains it, updates counts, and
        # casts batched del_ref/del_borrow. Borrow ADDS stay synchronous
        # (they are called from unpickling, never from __del__) because
        # their ordering against the covering pin's release matters.
        self._borrows: dict[str, int] = {}
        self._borrows_lock = threading.Lock()
        import collections as _collections

        self._release_queue: "_collections.deque[tuple[str, str]]" = (
            _collections.deque())
        # --- object census (objcensus.py; reference: the per-worker
        # reference table behind `ray memory`, reference_count.h:72):
        # every owned ref tracked with its creating callsite/kind/size;
        # a bounded per-callsite summary piggybacks on rpc_report.
        self._census = None
        self._callsite = None
        if GLOBAL_CONFIG.object_census_enabled:
            from ray_tpu_torch._private import objcensus

            self._census = objcensus.OwnerCensus(
                GLOBAL_CONFIG.object_census_max_entries)
            self._callsite = objcensus.callsite
        ids_mod.set_ref_removed_callback(self._on_ref_removed)
        ids_mod.set_borrow_callbacks(self._on_borrow_added,
                                     self._on_borrow_removed)
        # --- continuous profiling plane (profplane.py): every runtime
        # process samples its own threads on a duty cycle from boot;
        # window summaries piggyback on rpc_report below. Workers armed
        # themselves (role "worker") in worker.main before constructing
        # the runtime — arm() is idempotent, so this is a no-op there.
        from ray_tpu_torch._private import profplane

        profplane.arm(self.client_type or "driver", self.client_id)
        # --- direct-call plane (reference: direct_actor_transport.h +
        # the owner-side lease cache, normal_task_submitter.cc:29):
        # steady-state actor calls and lease-cached same-shape tasks go
        # owner→worker on peer connections; the head is demoted to
        # batched async bookkeeping. Workers execute tasks, so they host
        # the receiving half (Worker sets _peer_task_handler); every
        # runtime gets the submitting half.
        self._peer_task_handler = None
        self._direct = None
        if (GLOBAL_CONFIG.direct_call_enabled
                and self.owner_addr is not None):
            from ray_tpu_torch._private.direct import DirectPlane

            self._direct = DirectPlane(self)
        self._last_rpc_report = 0.0
        self._release_thread = threading.Thread(
            target=self._release_loop, daemon=True, name="ref-release")
        self._release_thread.start()

    def rpc_counter_snapshot(self) -> dict:
        """This process's dispatch-plane counters (the per-process half
        of ray_tpu_torch.util.metrics.rpc_counters, sans the runtime lookup)."""
        def _conn(c) -> dict:
            return {"frames_sent": c.frames_sent,
                    "calls_sent": c.calls_sent,
                    "sent_kinds": dict(c.sent_kinds)}

        with self._owner_conns_lock:
            peers = {f"{a[0]}:{a[1]}": _conn(c)
                     for a, c in self._owner_conns.items()}
        from ray_tpu_torch._private import dataplane
        from ray_tpu_torch._private.retry import breaker_snapshot

        return {"head": _conn(self.conn), "peers": peers,
                "direct": (self._direct.snapshot()
                           if self._direct is not None else {}),
                # Data-plane transfer accounting: payload bytes moved by
                # path (p2p/relay/local/zero_copy/inline/spill) and the
                # host-copy census. Rides the SAME amortized rpc_report
                # cast as the rest of this snapshot — zero new frames.
                "transfers": dataplane.counters(),
                # Unified retry plane: this process's per-target circuit
                # breakers (open/closed, consecutive failures, trip
                # times) — surfaced cluster-wide via rpc_report so
                # operators can see WHY traffic to a peer is shed.
                "breakers": breaker_snapshot()}

    def report_rpc_now(self) -> None:
        """Ship this process's counter snapshot (plus buffered chaos
        events) to the head. Called from the release loop on the
        rpc_report_interval_s cadence; tests call it directly."""
        from ray_tpu_torch._private import faultinject, traceplane

        body = {"client_id": self.client_id, "client_type": self.client_type,
                "counters": self.rpc_counter_snapshot()}
        chaos = faultinject.drain_events()
        if chaos:
            body["chaos_events"] = chaos
        # Trace-plane piggyback: buffered user/proxy/serve spans (and
        # the buffer's drop counter) ride the SAME amortized cast —
        # span() in a hot loop costs a deque append, never a frame.
        spans, dropped = traceplane.drain_spans()
        if spans:
            body["spans"] = spans
        if dropped:
            body["spans_dropped"] = dropped
        if self._census is not None:
            # Object census piggyback: the bounded per-callsite summary
            # rides the SAME amortized report cast — zero new per-call
            # head frames (guard: test_dispatch_fastpath's census test).
            body["census"] = self._census.summary(
                GLOBAL_CONFIG.object_census_report_groups,
                GLOBAL_CONFIG.object_census_sample_ids)
        # Profiling-plane piggyback: the continuous sampler's bounded
        # window summary rides the SAME amortized cast (zero new
        # per-call head frames; guard: test_dispatch_fastpath's
        # profiling test). None when no window has elapsed yet or the
        # RAY_TPU_PROFILING_ENABLED kill switch is off.
        from ray_tpu_torch._private import profplane

        prof = profplane.report_summary()
        if prof is not None:
            body["profile"] = prof
        if not self.conn.closed:
            self.conn.cast_buffered("rpc_report", body)

    # ------------------------------------------------------------------
    # inbound messages

    @staticmethod
    def _wire_version() -> int:
        """The binary wire version this runtime advertises (0 = binary
        framing disabled by config — peers negotiate down to pickle)."""
        from ray_tpu_torch._private import wirefmt

        return wirefmt.WIRE_VERSION if GLOBAL_CONFIG.wire_binary else 0

    def _handle(self, kind: str, body: dict, conn: rpc.Connection):
        if kind == "owned_freed":
            # The head freed directory entries this runtime owns: drop
            # the payloads and tombstone the ids (a late direct seal
            # must not orphan bytes in the store).
            for oid in body["ids"]:
                self._purge_owned(oid)
            return None
        if kind == "seal_objects":
            # Head-pushed seals (error results for retries-exhausted /
            # cancelled / crashed tasks): store locally so the owner-
            # local wait resolves; no notify — the head already knows.
            self._store_owned_and_notify(body["objects"], notify=False)
            return None
        if kind in ("objects_ready", "wait_ready", "pg_ready"):
            with self._waiters_lock:
                fut = self._waiters.pop(body["waiter_id"], None)
            if fut is not None and not fut.done():
                fut.set_result(body)
            elif kind == "objects_ready":
                # The get() already timed out: nobody will read these metas,
                # so release the read pins the head took in _meta_for.
                stale = [oid for oid, m in body["metas"].items()
                         if m[0] in ("shm", "p2p")]  # both are read-pinned
                if stale:
                    try:
                        self.conn.cast("read_done", {"ids": stale})
                    except rpc.ConnectionLost:
                        pass
            return None
        if kind == "backpressure":
            # Typed admission-control signal: the head shed (or is about
            # to shed) this owner's submissions. Blocking-submit parks
            # new submits until the horizon passes; fast-fail mode makes
            # them raise PendingCallsLimitError immediately.
            delay = max(0.05, float(body.get("retry_after_s", 1.0)))
            with self._owned_cond:
                self._backpressure_until = max(
                    self._backpressure_until, time.monotonic() + delay)
            return None
        if (self._direct is not None
                and kind in ("actor_direct_grant", "actor_direct_revoke",
                             "lease_grant", "lease_revoke")
                and self._direct.on_head_msg(kind, body)):
            return None
        if self._message_handler is not None:
            return self._message_handler(kind, body)
        return None

    def _on_conn_lost(self, _conn) -> None:
        """Head connection dropped (reference: GCS client reconnect after
        GCS failover). Pending waiters fail fast — their objects' head
        epoch is gone — and drivers retry the head address for a grace
        window, re-registering so NEW work proceeds against the restarted
        head. Workers override this hook (their connection is a lease:
        they exit)."""
        if self._closed:
            return
        with self._waiters_lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
        for fut in waiters:
            if not fut.done():
                fut.set_exception(
                    rpc.ConnectionLost("head connection lost"))
        if self.client_type == "driver":
            threading.Thread(target=self._reconnect_loop, daemon=True,
                             name="driver-reconnect").start()

    def _reconnect_loop(self) -> None:
        import time

        from ray_tpu_torch._private.retry import backoff_delays, default_policy

        delays = backoff_delays(default_policy())
        deadline = time.time() + GLOBAL_CONFIG.driver_reconnect_grace_s
        while not self._closed and time.time() < deadline:
            conn = None
            try:
                conn = rpc.connect(self.address, handler=self._handle,
                                   name=self.client_type,
                                   on_close=self._on_conn_lost)
                reg = conn.call(
                    "register",
                    {"client_type": self.client_type, "worker_id": None,
                     "pid": os.getpid(),
                     "can_shm": getattr(self, "shm", None) is not None,
                     "owner_addr": self.owner_addr,
             "host": _dp.host_id(),
                     "wire": self._wire_version()},
                    timeout=GLOBAL_CONFIG.worker_register_timeout_s,
                )
                if reg["shm_name"] is not None:
                    try:
                        # The restarted head has a NEW shm arena.
                        self.shm = ShmClient(reg["shm_name"],
                                             reg["shm_capacity"])
                    except FileNotFoundError:
                        # Same fallback as __init__: stay registered as a
                        # remote (inline-payload) client, or the head
                        # would keep shipping shm metas we cannot map.
                        self.shm = None
                        reg = conn.call(
                            "register",
                            {"client_type": self.client_type,
                             "worker_id": None, "pid": os.getpid(),
                             "can_shm": False,
                             "owner_addr": self.owner_addr,
             "host": _dp.host_id(),
                             "wire": self._wire_version()},
                            timeout=GLOBAL_CONFIG.worker_register_timeout_s,
                        )
                self.client_id = reg["client_id"]
                self.node_id = reg["node_id"]
                self.session_dir = reg["session_dir"]
                self.head_shard = int(reg.get("shard", 0))
                self.head_shards = int(reg.get("head_shards", 1))
                self._head_specenc = bool(reg.get("specenc"))
                conn.wire_binary = (
                    reg.get("wire") == self._wire_version() != 0)
                # The new head's KV may lack function blobs exported to
                # the old one (no snapshot, or crash inside the flush
                # window): drop the "already exported" cache so the next
                # submission re-publishes each function.
                self._fn_ids.clear()
                self.conn = conn
                if self._direct is not None:
                    # Grants from the old head (or a dead shard) are
                    # void: fall back to head routing until the new one
                    # re-grants (sharded head: the router may have
                    # landed us on a DIFFERENT shard).
                    self._direct.on_reconnect()
                print("ray_tpu_torch: driver re-registered with restarted head",
                      flush=True)
                return
            except Exception:
                if conn is not None:
                    # A half-open connection must not fire _on_conn_lost
                    # later and spawn a SECOND reconnect loop.
                    conn._on_close = None
                    try:
                        conn.close()
                    except Exception:
                        pass
                # Unified backoff (was a fixed 1 s poll): fast first
                # retries after a blip, capped exponential after.
                time.sleep(min(next(delays),
                               max(0.0, deadline - time.time())))

    def _new_waiter(self) -> tuple[str, Future]:
        waiter_id = uuid.uuid4().hex[:16]
        fut: Future = Future()
        with self._waiters_lock:
            self._waiters[waiter_id] = fut
        return waiter_id, fut

    def _on_ref_removed(self, hex_id: str) -> None:
        """__del__ path: enqueue only (see the GC discipline note)."""
        if self._closed:
            return
        self._release_queue.append(("owned", hex_id))

    def _on_borrow_added(self, hex_id: str) -> None:
        """A ref was deserialized in this process. Registration reaches
        the head on this connection BEFORE the task-done/read-done that
        releases the in-flight pin covering the deserialization (same
        ordered connection), so there is no free window. The cast stays
        under _borrows_lock so the flusher's del_borrow for the same id
        cannot misorder against it."""
        if self._closed:
            return
        with self._borrows_lock:
            n = self._borrows.get(hex_id, 0)
            self._borrows[hex_id] = n + 1
            if n == 0:
                try:
                    self.conn.cast("add_borrow", {"ids": [hex_id]})
                except rpc.ConnectionLost:
                    pass

    def _on_borrow_removed(self, hex_id: str) -> None:
        """__del__ path: enqueue only (see the GC discipline note)."""
        if self._closed:
            return
        self._release_queue.append(("borrow", hex_id))

    def _drain_releases(self) -> None:
        """Flusher body: batch queued releases into del_ref/del_borrow
        casts. Count updates and their casts share one _borrows_lock
        hold per batch, keeping per-id transition order consistent with
        concurrent synchronous adds."""
        while True:
            owned: list[str] = []
            borrows: list[str] = []
            with self._borrows_lock:
                for _ in range(256):
                    try:
                        kind, hex_id = self._release_queue.popleft()
                    except IndexError:
                        break
                    if kind == "owned":
                        # NOT purged from the owned store here: the head
                        # decides when the cluster is done with the
                        # object (in-flight tasks may still fetch the
                        # value from this store) and casts owned_freed.
                        owned.append(hex_id)
                        if self._device_cache is not None:
                            # The local ref died: the device array must
                            # not stay resident on its account.
                            self._device_cache.pop(hex_id)
                        if self._census is not None:
                            # The local ref died: the census tracks
                            # LIVE refs, so the record retires now.
                            self._census.release(hex_id)
                        continue
                    n = self._borrows.get(hex_id, 0) - 1
                    if n <= 0:
                        self._borrows.pop(hex_id, None)
                        borrows.append(hex_id)
                    else:
                        self._borrows[hex_id] = n
                if (owned or borrows) and not self.conn.closed:
                    try:
                        if owned:
                            self.conn.cast("del_ref", {"ids": owned})
                        if borrows:
                            self.conn.cast("del_borrow", {"ids": borrows})
                    except rpc.ConnectionLost:
                        pass
            if not owned and not borrows:
                return

    def _release_loop(self) -> None:
        """Idle-adaptive: a busy runtime drains every 50 ms, an idle one
        backs off to 2 s. A 20 Hz fixed tick looks free until a 2,000-
        actor swarm runs on one core — 2,000 processes x 20 wakeups/s of
        scheduler work saturated the box with zero useful work (found by
        the scale envelope's actor axis)."""
        import time as _time

        delay = 0.05
        while not self._closed:
            had_work = bool(self._release_queue)
            try:
                self._drain_releases()
            except Exception:
                pass
            aux = getattr(self, "_aux_flush", None)
            if aux is not None:
                try:
                    aux()
                except Exception:
                    pass
            if self._direct is not None:
                try:
                    # Direct-plane watchdog: expired leases, unacked /
                    # revoked direct calls re-routing through the head.
                    self._direct.tick()
                except Exception:
                    pass
            now = _time.monotonic()
            due = (now - self._last_rpc_report
                   >= GLOBAL_CONFIG.rpc_report_interval_s)
            if not due:
                # Early flush for buffered trace spans: a finished
                # request's spans must not wait out a full report
                # interval to become visible on the head (still
                # amortized — at most one extra report per second).
                from ray_tpu_torch._private import traceplane

                due = (now - self._last_rpc_report >= 1.0
                       and traceplane.pending_spans_age() > 1.0)
            if due:
                self._last_rpc_report = now
                try:
                    # Cluster-wide counter aggregation: this process's
                    # dispatch-plane census (and any buffered chaos
                    # events) rides ONE amortized buffered cast — the
                    # per-call head-frame count stays untouched.
                    self.report_rpc_now()
                except Exception:
                    pass
            delay = 0.05 if had_work else min(delay * 2, 2.0)
            _time.sleep(delay)

    # ------------------------------------------------------------------
    # owner plane (reference: core_worker.h:172 — the submitter owns its
    # task results; the in-process store holds them and peers resolve
    # values from the owner, the head being directory only)

    def _handle_peer(self, kind: str, body: dict, conn: rpc.Connection):
        if kind == "seal_objects":
            # Metadata-only seals name their holder by node + ports
            # only; the routable IP is the one fact the executor cannot
            # know better than we do — it is where this frame came from.
            peer_ip = None
            try:
                peer_ip = conn._sock.getpeername()[0]
            except (OSError, AttributeError):
                pass
            self._store_owned_and_notify(body["objects"], peer_ip=peer_ip)
            return None
        if kind == "direct_push":
            # Direct-call plane: an owner pushed a task straight to this
            # runtime's worker half (reference: direct task submission,
            # direct_actor_transport.h). Only task-executing runtimes
            # accept it; the error reply makes a mis-addressed push
            # visible instead of silently vanishing.
            h = self._peer_task_handler
            if h is None:
                raise rpc.RpcError(
                    f"runtime {self.client_id} does not execute tasks")
            return h(body, conn)
        if kind == "fetch_object":
            with self._owned_cond:
                v = self._owned_store.get(body["object_id"])
            if v is None or v[0] is _REMOTE:
                raise rpc.RpcError(
                    f"object {body['object_id']} not in owner store")
            return {"payload": v[0], "is_error": v[1]}
        if kind == "cancel_direct":
            # Direct-plane cancellation: the owner cancels a task it
            # pushed straight to this worker (queued in the executor,
            # not yet running). No-op on non-executing runtimes.
            h = self._peer_cancel_handler
            if h is not None:
                h(body)
            return None
        if kind == "whoami":
            # Peer identity check: a mis-advertised owner address (e.g.
            # loopback seen from another host) must not silently swallow
            # seals meant for a different runtime. Doubles as the wire
            # negotiation for peer connections — the dialer's version
            # rides the request, ours rides the reply, and each side
            # enables binary SENDING only on a version match (this
            # reply itself is always pickled, so no binary frame can
            # precede the handshake in either direction).
            if body.get("wire") == self._wire_version() != 0:
                conn.wire_binary = True
            return {"client_id": self.client_id,
                    "wire": self._wire_version()}
        raise rpc.RpcError(f"unknown peer message {kind!r}")

    def _store_owned_and_notify(self, objs: "list[dict]",
                                notify: bool = True,
                                peer_ip: "str | None" = None) -> None:
        """Store directly-delivered result payloads (or "stored big,
        ask the head" markers), then send the head its slim directory
        notification. Ordering is the invariant that makes owner
        residency safe: the head marks an entry SEALED only after the
        OWNER confirms holding the bytes, so 'head says sealed' always
        implies the value is fetchable. notify=False for seals PUSHED BY
        the head itself (error seals — it already knows)."""
        direct_oids: "frozenset | tuple" = ()
        if self._direct is not None:
            # Snapshot which of these ids were direct-dispatched BEFORE
            # the resolution hook pops their tracking entries.
            oids = [r["object_id"] for r in objs]
            direct_oids = self._direct.known_direct_oids(oids)
            # Direct-plane resolution hook: frees inflight-window slots,
            # drains owner-side pending queues, clears drain barriers.
            # BEFORE the store+notify below: a getter woken by this seal
            # may submit its next call immediately, and that call must
            # find the lease window slot already free — notify-first
            # made a sync submit loop spill to the head on the race.
            try:
                self._direct.on_resolved(oids)
            except Exception:
                pass
        if self._census is not None:
            for rec in objs:
                if not rec.get("remote"):
                    self._census.update_size(rec["object_id"],
                                             len(rec["payload"]))
                elif rec.get("loc"):
                    # Metadata-only seal: the size is IN the metadata —
                    # census sizes land without the payload ever being
                    # pulled, let alone deserialized.
                    self._census.update_size(rec["object_id"],
                                             int(rec["loc"].get("size", 0)))
        with self._owned_cond:
            for rec in objs:
                oid = rec["object_id"]
                self._expected_owned.discard(oid)
                if oid in self._dead_owned:
                    continue  # local ref already died: drop the payload
                if rec.get("remote"):
                    # Metadata-only seal: keep the holder location so
                    # get() pulls the payload straight from the holder
                    # node (head fallback on any miss). Never clobber a
                    # real payload already delivered (a retried task's
                    # head-routed attempt can race the first attempt's
                    # direct seal).
                    loc = rec.get("loc")
                    if loc is not None and peer_ip and not loc.get("ip"):
                        loc = dict(loc, ip=peer_ip)
                    self._owned_store.setdefault(oid, (_REMOTE, loc))
                else:
                    self._owned_store[oid] = (
                        rec["payload"], rec.get("is_error", False))
            if self._owned_waiters:
                self._owned_cond.notify_all()
        if not notify:
            return
        slim = [{"object_id": r["object_id"], "owner_id": self.client_id,
                 "size": len(r["payload"]),
                 "is_error": r.get("is_error", False),
                 # Direct-dispatched task results: the head may not have
                 # a directory entry yet (the batched task_started cast
                 # can lose the race with this seal) — tell it to create
                 # one instead of dropping the seal.
                 "direct": r["object_id"] in direct_oids,
                 "contained_ids": r.get("contained_ids") or []}
                for r in objs if not r.get("remote")]
        if not slim:
            return
        body = {"objects": slim}
        if GLOBAL_CONFIG.task_events_enabled:
            # Flight recorder: the owner now HOLDS these results — the
            # resolve stamp rides the confirmation the head needs anyway
            # (one float per batch, zero extra frames).
            body["t_resolve"] = time.time()
        # Local mode: the head runs in THIS process (driver == head
        # host) — confirm by direct call instead of a socket round trip
        # (one fewer message per task on the completion path).
        head = self._inproc_head()
        if head is not None:
            try:
                head._h_owner_sealed(body, None)
                return
            except Exception:
                pass
        try:
            self.conn.cast_buffered("owner_sealed", body)
        except rpc.ConnectionLost:
            pass

    def _inproc_head(self):
        """The head service object when it lives in this process (local
        clusters put it in the driver), else None."""
        try:
            from ray_tpu_torch._private import worker_context

            return worker_context.get_head()
        except Exception:
            return None

    def _purge_owned(self, hex_id: str) -> None:
        """The cluster is done with an owned object: drop its payload
        and tombstone the id so a late direct seal (still in flight from
        the executor) can't orphan bytes in the store."""
        if self._census is not None:
            self._census.release(hex_id)
        if self._device_cache is not None:
            self._device_cache.pop(hex_id)
        with self._owned_cond:
            self._owned_store.pop(hex_id, None)
            self._expected_owned.discard(hex_id)
            if hex_id not in self._dead_owned:
                self._dead_owned.add(hex_id)
                self._dead_owned_fifo.append(hex_id)
                if len(self._dead_owned_fifo) > 65536:
                    self._dead_owned.discard(self._dead_owned_fifo.pop(0))
            self._owned_cond.notify_all()
        if self._direct is not None:
            # A freed id resolves its direct-plane tracking too (the
            # window must not stay clogged by fire-and-forget results).
            try:
                self._direct.on_resolved([hex_id])
            except Exception:
                pass

    def _handle_direct_client(self, kind: str, body: dict,
                              conn: rpc.Connection):
        """Handler for messages a WORKER pushes back over an
        owner-initiated peer connection: direct-plane delivery acks and
        back-pressure rejections."""
        if kind in ("direct_ack", "direct_rej") and self._direct is not None:
            self._direct.on_worker_msg(kind, body)
        return None

    def _on_peer_conn_close(self, conn: rpc.Connection) -> None:
        """A peer connection died: prune the cache and tell the direct
        plane so routes/leases over it re-route through the head."""
        addr = getattr(conn, "_peer_addr", None)
        if addr is None:
            return
        with self._owner_conns_lock:
            if self._owner_conns.get(addr) is conn:
                self._owner_conns.pop(addr, None)
        if self._direct is not None and not self._closed:
            try:
                self._direct.on_peer_close(addr)
            except Exception:
                pass

    def _peer_owner_conn(self, addr: tuple,
                         expect_owner: "str | None" = None,
                         handler=None) -> rpc.Connection:
        from ray_tpu_torch._private.retry import (CircuitOpenError, breaker_for,
                                            default_policy)

        with self._owner_conns_lock:
            c = self._owner_conns.get(addr)
        if c is None or c.closed:
            # Per-owner circuit breaker (unified retry plane): once an
            # owner address has failed the threshold consecutively, stop
            # paying a dial+handshake timeout per caller — fail fast so
            # gets fall back to head routing / ObjectLostError within
            # milliseconds instead of convoying on a dead peer.
            breaker = breaker_for(f"owner:{addr[0]}:{addr[1]}")
            if not breaker.allow():
                raise rpc.RpcError(
                    f"owner address {addr} circuit open "
                    f"({breaker.threshold} consecutive failures)")
            try:
                c = rpc.connect(addr, name="owner-peer",
                                handler=handler or
                                self._handle_direct_client,
                                on_close=self._on_peer_conn_close)
                c._peer_addr = addr
            except OSError:
                breaker.record_failure()
                raise
            except RuntimeError as e:
                # pthread_create EAGAIN: the box hit a thread/pid limit
                # mid-dial (observed under a 2,000-actor swarm on a
                # 1-core container). The direct plane has a head-path
                # fallback by design — fail THIS dial like an
                # unreachable peer instead of crashing the submitter.
                breaker.record_failure()
                raise rpc.RpcError(f"owner dial {addr} failed: {e}") \
                    from None
            # Verify who answered: an advertised loopback address dialed
            # from another host reaches the WRONG process — one-way
            # seals would vanish silently. One RPC per (peer, addr). A
            # failed handshake is NOT cached as trusted: the connection
            # is dropped and the caller falls back to head routing.
            # Retried per the policy: an injected drop of the whoami
            # frame must not misclassify a healthy owner as dead.
            try:
                who = c.call("whoami", {"wire": self._wire_version()},
                             timeout=10,
                             retry=default_policy(deadline_s=10.0,
                                                  attempt_timeout_s=3.0))
                c.peer_info["owner_id"] = who.get("client_id")
                c.wire_binary = (
                    who.get("wire") == self._wire_version() != 0)
            except (rpc.RpcError, rpc.ConnectionLost, CircuitOpenError,
                    FutureTimeoutError):
                breaker.record_failure()
                try:
                    c.close()
                except Exception:
                    pass
                raise rpc.RpcError(
                    f"owner address {addr} failed identity check")
            breaker.record_success()
            with self._owner_conns_lock:
                self._owner_conns[addr] = c
        if (expect_owner is not None
                and c.peer_info.get("owner_id") != expect_owner):
            raise rpc.RpcError(
                f"owner address {addr} answered as "
                f"{c.peer_info.get('owner_id')}, expected {expect_owner}")
        # Native fast lane, owner side: let the C reader consume
        # top-level direct_ack casts (the per-call delivery-ack flood)
        # without waking Python; the direct plane drains them in bulk
        # (_drain_native_acks). Re-evaluated on every lookup so arming
        # the chaos plane mid-session routes acks back through Python,
        # where faultinject.apply_recv sees each frame. No-op on
        # pure-Python connections.
        c.set_ack_sink(faultinject.active() is None)
        return c

    def seal_to_owner(self, addr, bodies: "list[dict]",
                      expect_owner: "str | None" = None) -> bool:
        """Deliver inline task results directly to the owning runtime
        (buffered; the global cast flusher bounds latency to ~1 ms).
        Returns False when the owner is unreachable or the address
        answers as a different runtime — the caller falls back to
        routing the payloads through the head."""
        addr = tuple(addr)
        if self.owner_addr is not None and addr == tuple(self.owner_addr):
            # Executing our own submission: store + notify directly.
            self._store_owned_and_notify(bodies)
            return True
        try:
            conn = self._peer_owner_conn(addr, expect_owner=expect_owner)
            conn.cast_buffered("seal_objects", {"objects": bodies})
            return True
        except (OSError, rpc.RpcError, rpc.ConnectionLost):
            return False

    def _await_expected(self, waiting: "list[str]", local: dict,
                        missing: "list[str]", deadline, timeout,
                        ref_list, locs: "dict | None" = None) -> None:
        """_owned_cond held. Wait for expected result deliveries,
        moving arrivals into ``local`` (payloads) or ``missing`` (big-
        object markers / forgotten ids — resolved via head metas).
        Scans are coalesced to ~50/s for wide waits so a flood of
        per-task seal notifications can't make the rescan quadratic.
        A 5 s no-progress stall falls everything back to the head (the
        safety net for delivery holes, e.g. a head restart)."""
        import time as _time

        last_progress = last_scan = _time.monotonic()
        while waiting:
            remaining = (None if deadline is None
                         else deadline - _time.monotonic())
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(
                    f"get timed out after {timeout}s on {ref_list}")
            self._owned_cond.wait(
                min(0.25, remaining) if remaining is not None else 0.25)
            now = _time.monotonic()
            if len(waiting) > 64 and now - last_scan < 0.02:
                # Coalesce wakeups (rescan at most ~50x/s for wide
                # waits) — but sleep only the REMAINDER of the window,
                # never re-park on the condition: the notify this wake
                # consumed may have been the LAST seal batch (direct
                # dispatch delivers results in a few big bursts), and
                # a plain `continue` would strand the getter for the
                # full 0.25 s timeout after every burst.
                self._owned_cond.wait(max(0.001, 0.02 - (now - last_scan)))
                now = _time.monotonic()
            last_scan = now
            progressed, still = False, []
            for hex_id in waiting:
                v = self._owned_store.get(hex_id)
                if v is None:
                    if hex_id in self._expected_owned:
                        still.append(hex_id)
                    else:  # freed/forgotten: ask the head
                        missing.append(hex_id)
                        progressed = True
                elif v[0] is _REMOTE:
                    if locs is not None and v[1]:
                        locs[hex_id] = v[1]  # metadata seal: direct pull
                    else:
                        missing.append(hex_id)
                    progressed = True
                else:
                    local[hex_id] = v
                    progressed = True
            waiting[:] = still
            if progressed:
                last_progress = now
            elif now - last_progress > 5.0:
                missing.extend(waiting)  # stalled: safety net
                del waiting[:]

    def _await_owned_local(self, hex_id: str, deadline) -> "tuple | None":
        """Wait for an in-flight direct seal of an object this runtime
        owns. Returns the (payload, is_error) pair or None on timeout."""
        import time as _time

        with self._owned_cond:
            while True:
                v = self._owned_store.get(hex_id)
                if v is not None:
                    return v
                remaining = (None if deadline is None
                             else deadline - _time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._owned_cond.wait(min(remaining or 1.0, 1.0))

    # ------------------------------------------------------------------
    # objects

    def _agent(self) -> rpc.Connection:
        if self._agent_conn is None or self._agent_conn.closed:
            self._agent_conn = rpc.connect(self.agent_addr, name="store")
        return self._agent_conn

    def _put_p2p(self, object_id: str, header, buffers, size: int,
                 is_error: bool,
                 contained: "list[str] | None" = None) -> "int | None":
        """Store into this node's agent arena; register directory-only
        with the head. Returns the sealed arena offset, or None when
        the local store is full (the caller falls back to the inline
        path)."""
        try:
            offset = self._agent().call("alloc", {"size": size})["offset"]
        except rpc.RpcError as e:
            if "ObjectStoreFullError" in str(e):
                return None
            raise
        sealed = False
        try:
            view = self.agent_shm.view(offset, size)
            serialization.write_to(view, header, buffers)
            view.release()
            reply = self._agent().call("seal_local", {
                "object_id": object_id, "offset": offset, "size": size})
            # A concurrent seal of the same id (retry race) kept its
            # copy and freed ours — register the canonical offset.
            offset = reply.get("offset", offset)
            sealed = True
            self.conn.call("put_p2p", {
                "object_id": object_id, "node_id": self.node_id,
                "offset": offset, "size": size,
                "owner_id": self.client_id, "is_error": is_error,
                "contained_ids": contained or [],
            })
            return offset
        except rpc.ConnectionLost:
            # Ambiguous: the head may have APPLIED put_p2p before the
            # connection dropped, in which case the directory routes
            # readers here — freeing the sealed bytes would dangle that
            # entry (or serve recycled memory). Leave them; the arena
            # reclaims on agent restart.
            if not sealed:
                try:
                    self._agent().call("abort_alloc", {"offset": offset})
                except Exception:
                    pass
            raise
        except rpc.RpcError:
            # The head DEFINITIVELY rejected the registration (an error
            # REPLY arrived): no directory entry exists, so no reader
            # can be routed here — unseal and free, or the arena leaks
            # the bytes until agent restart.
            try:
                if not sealed:
                    self._agent().call("abort_alloc", {"offset": offset})
                else:
                    self._agent().call("abort_sealed",
                                       {"object_id": object_id})
            except Exception:
                pass
            raise
        except BaseException:
            # Anything else (KeyboardInterrupt mid-call, ...) is as
            # ambiguous as a dropped connection: never free sealed bytes
            # the directory might reference.
            if not sealed:
                try:
                    self._agent().call("abort_alloc", {"offset": offset})
                except Exception:
                    pass
            raise

    def _replicate_local(self, object_id: str, payload) -> None:
        """Cache a remotely-pulled payload in this node's agent store and
        register as a replica source (spanning-tree broadcast fan-out;
        reference: push_manager.h:32). Best-effort: any failure just
        means this node doesn't become a source."""
        try:
            # In-wave relay registration (delay 0 by default): the
            # sooner this copy is in the directory, the sooner later
            # pullers of the same object fan out across the tree
            # instead of convoying on the primary. A configured delay
            # defers the memcpy past a latency-sensitive window.
            if GLOBAL_CONFIG.bulk_replicate_delay_s > 0:
                import time as _time

                _time.sleep(GLOBAL_CONFIG.bulk_replicate_delay_s)
            size = len(payload)
            offset = self._agent().call("alloc", {"size": size})["offset"]
            try:
                view = self.agent_shm.view(offset, size)
                view[:] = payload
                view.release()
                sealed = self._agent().call("seal_local", {
                    "object_id": object_id, "offset": offset, "size": size})
                # A concurrent replicator won: the agent kept ITS copy
                # and freed ours — register the canonical offset.
                offset = sealed.get("offset", offset)
            except BaseException:
                try:
                    self._agent().call("abort_alloc", {"offset": offset})
                except Exception:
                    pass
                raise
            self.conn.cast("add_replica", {
                "object_id": object_id, "node_id": self.node_id,
                "offset": offset, "size": size})
        except Exception:
            pass

    def _pull_p2p(self, object_id: str, addr: tuple, size: int) -> bytes:
        """Bulk-plane pull: parallel raw-socket stripes, recv_into a
        single buffer (one copy end to end). The directory TAGS legacy
        rpc transfer addresses with a third element ("rpc") — the two
        protocols are never guessed at (a bulk frame misread as an rpc
        length would block the reader indefinitely)."""
        if len(addr) == 3 and addr[2] == "rpc":
            return self._pull_p2p_legacy(object_id, addr[:2], size)
        host, port = addr
        if not host:
            host = self.address[0]  # "" = the head host this client dialed
        from ray_tpu_torch._private import bulk_transfer
        from ray_tpu_torch._private.retry import default_policy

        # Per-stripe backoff under the unified policy (replaces the old
        # hand-rolled single re-try): transient resets / injected drops
        # re-pull the stripe; the retry scope upstream
        # (_read_p2p_retrying) re-resolves the meta on terminal failure.
        return bulk_transfer.pull_object(
            (host, port), object_id, size,
            streams=GLOBAL_CONFIG.bulk_streams,
            retry=default_policy())

    def _pull_p2p_legacy(self, object_id: str, addr: tuple,
                         size: int) -> bytes:
        """Chunked pull from the hosting node's agent (reference:
        pull_manager.h:57)."""
        key = tuple(addr)
        conn = self._peer_conns.get(key)
        if conn is None or conn.closed:
            conn = self._peer_conns[key] = rpc.connect(
                (addr[0], int(addr[1])), name="pull")
        from ray_tpu_torch._private.retry import default_policy

        chunk = GLOBAL_CONFIG.p2p_chunk_size
        buf = bytearray(size)
        pos = 0
        policy = default_policy(attempt_timeout_s=120.0,
                                deadline_s=None)
        while pos < size:
            reply = conn.call("pull", {"object_id": object_id,
                                       "start": pos,
                                       "length": min(chunk, size - pos)},
                              timeout=120, retry=policy)
            data = reply["data"]
            buf[pos:pos + len(data)] = data
            pos += len(data)
        return bytes(buf)

    def put(self, value: Any, *, _object_id: str | None = None, _is_error: bool = False) -> ObjectRef:
        object_id = _object_id or os.urandom(16).hex()
        # Refs serialized INSIDE the value become containment pins at the
        # directory: the stored object keeps its contained objects alive
        # until it is itself freed (reference: reference_count.h nested
        # refs "contained in owned object").
        with serialization.collect_refs() as collected:
            header, buffers = serialization.serialize(value)
        contained = sorted(set(collected))
        size = serialization.serialized_size(header, buffers)
        if self._census is not None and _object_id is None:
            # Census: owned put, attributed to the first user frame.
            # Kind mirrors the storage decision in _store_serialized.
            if (self.shm is None and self.agent_shm is not None
                    and size > GLOBAL_CONFIG.max_inline_object_size):
                kind = "p2p"
            elif (self.shm is None
                    or size <= GLOBAL_CONFIG.max_inline_object_size):
                kind = "inline"
            else:
                kind = "shm"
            self._census.record(object_id, kind, size, self._callsite())
        arr = None
        if (self._device_cache is not None and not _is_error
                and size >= GLOBAL_CONFIG.data_plane_min_bytes):
            from ray_tpu_torch._private import dataplane

            arr = dataplane.array_meta(value)
            if dataplane.device_resident(arr):
                # Colocated fast path: keep the device-resident array so
                # a same-process get() skips the host round trip.
                self._device_cache.put(object_id, value, size)
        self._store_serialized(object_id, header, buffers, size, contained,
                               _is_error, arr=arr)
        return ObjectRef(object_id, _owned=_object_id is None)

    def _inline_body(self, object_id, header, buffers, size, contained,
                     is_error) -> dict:
        payload = bytearray(size)
        serialization.write_to(memoryview(payload), header, buffers)
        return {
            "object_id": object_id,
            "payload": bytes(payload),
            "owner_id": self.client_id,
            "is_error": is_error,
            "contained_ids": contained,
        }

    def _store_serialized(self, object_id, header, buffers, size, contained,
                          _is_error, arr=None) -> "dict | None":
        """Store an already-serialized value: p2p arena, inline call, or
        shm create/seal — the storage decision shared by put() and the
        deferred task-result path. Returns the holder-location record
        for arena-resident payloads (the metadata-only seal the owner
        resolves getters from, zero head frames), else None (inline and
        head-arena objects resolve through head metas)."""
        if (self.shm is None and self.agent_shm is not None
                and size > GLOBAL_CONFIG.max_inline_object_size):
            offset = self._put_p2p(object_id, header, buffers, size,
                                   _is_error, contained)
            if offset is not None:
                if (not self._dataplane_on
                        or size < GLOBAL_CONFIG.data_plane_min_bytes):
                    return None
                from ray_tpu_torch._private import dataplane

                return {"node": self.node_id, "off": offset, "size": size,
                        "bulk_port": self.agent_bulk_port or None,
                        "xfer_port": (self.agent_addr[1]
                                      if self.agent_addr else None),
                        "store": self.agent_store_name,
                        "cap": self.agent_store_capacity,
                        "host": dataplane.host_id(),
                        "is_error": _is_error, "arr": arr}
        if self.shm is None or size <= GLOBAL_CONFIG.max_inline_object_size:
            self.conn.call(
                "put_inline",
                self._inline_body(object_id, header, buffers, size,
                                  contained, _is_error),
            )
        else:
            try:
                reply = self.conn.call(
                    "create_object",
                    {"object_id": object_id, "size": size, "owner_id": self.client_id},
                )
            except rpc.RpcError as e:
                if "ObjectStoreFullError" in str(e):
                    from ray_tpu_torch.exceptions import ObjectStoreFullError

                    raise ObjectStoreFullError(
                        f"cannot store {size}-byte object: object store full "
                        f"(even after spilling)"
                    ) from None
                raise
            view = self.shm.view(reply["offset"], size)
            serialization.write_to(view, header, buffers)
            view.release()
            self.conn.call("seal_object",
                           {"object_id": object_id, "is_error": _is_error,
                            "contained_ids": contained})

    def put_deferred(self, value: Any, object_id: str,
                     is_error: bool = False) -> "dict | None":
        """Inline-store body for piggybacking on the task_finished cast
        (the completion path is the control plane's hottest message:
        result + completion in ONE cast replaces a blocking put_inline
        round trip per task). Values too big to inline are stored
        through the normal path HERE (serialized exactly once); arena-
        resident payloads return a metadata-only marker carrying the
        holder location (the owner resolves getters straight from this
        node), plain big values return None (head-meta resolution)."""
        if (type(value) in self._SCALAR_TYPES
                and not serialization.custom_reducers):
            # Scalar result: provably no ObjectRefs / device arrays —
            # skip the ref-collecting Python-class pickler (was ~70 us
            # per nop-task result, the worker's hottest line).
            header, buffers, contained = (
                pickle.dumps(value, protocol=5), [], [])
        else:
            with serialization.collect_refs() as collected:
                header, buffers = serialization.serialize(value)
            contained = sorted(set(collected))
        size = serialization.serialized_size(header, buffers)
        if size > GLOBAL_CONFIG.max_inline_object_size:
            arr = None
            if (self._device_cache is not None and not is_error
                    and size >= GLOBAL_CONFIG.data_plane_min_bytes):
                from ray_tpu_torch._private import dataplane

                arr = dataplane.array_meta(value)
                if dataplane.device_resident(arr):
                    self._device_cache.put(object_id, value, size)
            loc = self._store_serialized(object_id, header, buffers, size,
                                         contained, is_error, arr=arr)
            if loc is not None:
                return {"object_id": object_id, "remote": True, "loc": loc}
            return None
        return self._inline_body(object_id, header, buffers, size, contained,
                                 is_error)

    def get(self, refs: ObjectRef | Sequence[ObjectRef], timeout: float | None = None) -> Any:
        import time as _time

        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        if not ref_list:
            return [] if not single else None
        id_list = [r.hex() for r in ref_list]
        if self._census is not None:
            # Leak detector input: these refs were awaited (a sealed-
            # but-never-fetched object past the TTL is a suspect).
            self._census.mark_awaited(id_list)
        deadline = None if timeout is None else _time.monotonic() + timeout
        # Phase 0 — colocated device fast path: results produced in THIS
        # process keep a copy of their CUDA tensor in the bounded device
        # cache; a colocated get() returns a device-side copy of it —
        # no device→host→device round trip.
        device_hits: dict[str, Any] = {}
        if self._device_cache is not None:
            for hex_id in id_list:
                v = self._device_cache.get(hex_id)
                if v is not None:
                    device_hits[hex_id] = v
            if len(device_hits) == len(id_list):
                vals = [device_hits[h] for h in id_list]
                return vals[0] if single else vals
        # Phase 1 — owner plane (reference: in-process store,
        # core_worker.h:172). Results this runtime owns are DELIVERED
        # here by executors: resolve present ones locally and wait
        # locally for expected ones. Every outcome reaches this store
        # (inline payload, big-object marker, head-pushed error seal),
        # so the head serves none of the owner's own result lookups; a
        # stall probe falls back to the head as the safety net for
        # delivery holes (e.g. a head restart that lost owner state).
        local: dict[str, tuple] = {}
        missing: list[str] = []
        unblock = None
        if self._pre_block is not None:
            try:
                unblock = self._pre_block()
            except Exception:
                pass
        locs: dict[str, dict] = {}
        try:
            with self._owned_cond:
                waiting: list[str] = []
                for hex_id in id_list:
                    if hex_id in device_hits:
                        continue
                    v = self._owned_store.get(hex_id)
                    if v is not None and v[0] is not _REMOTE:
                        local[hex_id] = v
                    elif v is not None:
                        if v[1]:
                            # Metadata-only seal: the holder location
                            # came with the seal — pull peer-to-peer,
                            # zero head frames (below, off this lock).
                            locs[hex_id] = v[1]
                        else:
                            missing.append(hex_id)  # big: head meta
                    elif hex_id in self._expected_owned:
                        waiting.append(hex_id)
                    else:
                        missing.append(hex_id)
                if waiting:
                    self._owned_waiters += 1
                    try:
                        self._await_expected(waiting, local, missing,
                                             deadline, timeout, ref_list,
                                             locs)
                    finally:
                        self._owned_waiters -= 1
            # Phase 1b — direct pulls for metadata-only seals (off the
            # condition lock: these hit the network). Any failure falls
            # back to the head meta path, which re-resolves against the
            # directory (surviving replica, spill copy, or a typed
            # provenance-carrying loss).
            for hex_id, loc in locs.items():
                try:
                    got = self._value_from_loc(hex_id, loc)
                except Exception:  # noqa: BLE001 — head path is fallback
                    got = None
                if got is None:
                    missing.append(hex_id)
                else:
                    local[hex_id] = got
            # Phase 2 — head metas for everything else.
            metas: dict = {}
            if missing:
                remaining = (None if deadline is None
                             else max(0.0, deadline - _time.monotonic()))
                waiter_id, fut = self._new_waiter()
                self.conn.cast("get_meta",
                               {"waiter_id": waiter_id, "ids": missing})
                try:
                    body = fut.result(remaining)
                except FutureTimeoutError:
                    self.conn.cast("cancel_wait", {"waiter_id": waiter_id})
                    raise GetTimeoutError(f"get timed out after {timeout}s on {ref_list}") from None
                finally:
                    with self._waiters_lock:
                        self._waiters.pop(waiter_id, None)
                metas = body["metas"]
        finally:
            if unblock is not None:
                unblock()
        values = []
        read_ids = []
        visited = 0
        try:
            for hex_id in id_list:
                if hex_id in device_hits:
                    values.append(device_hits[hex_id])
                elif hex_id in local:
                    values.append(self._deserialize(*local[hex_id]))
                else:
                    values.append(self._value_from_meta(
                        hex_id, metas[hex_id], read_ids, deadline))
                visited += 1
        finally:
            # The head pinned EVERY shm/p2p meta up front; if resolution
            # raised mid-batch (e.g. a stored task error), the unvisited
            # metas' pins must still be released or their objects leak.
            for hex_id in id_list[visited + 1:]:
                if (hex_id not in local and hex_id not in device_hits
                        and metas.get(hex_id, ())[:1]
                        and metas[hex_id][0] in ("shm", "p2p")):
                    read_ids.append(hex_id)
            if read_ids:
                self.conn.cast("read_done", {"ids": read_ids})
        return values[0] if single else values

    def _value_from_meta(self, hex_id: str, meta: tuple,
                         read_ids: list, deadline=None) -> Any:
        """Resolve one object meta to its value. ``read_ids`` collects
        ids whose head-side read pin must be released (the caller casts
        read_done)."""
        if meta[0] == "inline":
            return self._deserialize(meta[1], meta[2])
        if meta[0] == "owner":
            # ("owner", host, port, is_error, owner_id): the value lives
            # in the owning runtime's in-process store. Resolve locally
            # when this runtime IS the owner (the direct seal is at most
            # a flush interval behind the head's directory update), else
            # pull from the owner peer (identity-verified).
            _, host, port, is_error = meta[:4]
            owner_id = meta[4] if len(meta) > 4 else None
            if (self.owner_addr is not None
                    and (host, port) == tuple(self.owner_addr)):
                v = self._await_owned_local(hex_id, deadline)
                if v is None:
                    raise GetTimeoutError(
                        f"get timed out awaiting owned object {hex_id}")
                return self._deserialize(*v)
            from ray_tpu_torch._private.retry import default_policy

            try:
                # Idempotent read: retried per the unified policy, so an
                # injected drop/delay costs one backoff, not the object.
                r = self._peer_owner_conn(
                    (host, port), expect_owner=owner_id).call(
                    "fetch_object", {"object_id": hex_id}, timeout=60,
                    retry=default_policy())
            except (OSError, rpc.RpcError, rpc.ConnectionLost,
                    FutureTimeoutError):
                # The owner may have moved the value (e.g. a retried
                # task's head-routed attempt replaced its store entry
                # with a marker): re-resolve through the head once
                # before declaring it lost with its owner (reference:
                # OwnerDiedError semantics).
                fresh = self._reresolve_meta(hex_id)
                if fresh is not None and fresh[0] != "owner":
                    return self._value_from_meta(hex_id, fresh, read_ids,
                                                 deadline)
                raise ObjectLostError(
                    f"object {hex_id}: owner at {host}:{port} is gone",
                    object_id=hex_id, owner_id=owner_id,
                ) from None
            return self._deserialize(r["payload"], r["is_error"])
        if meta[0] == "shm":
            _, offset, size, is_error = meta
            view = self.shm.view(offset, size)
            if is_error or not GLOBAL_CONFIG.zero_copy_get:
                read_ids.append(hex_id)
                try:
                    return self._deserialize(bytes(view), is_error)
                finally:
                    view.release()
            # Zero-copy read (reference: plasma's read-only mmap'd numpy
            # views): arrays alias the store buffer through a READ-ONLY
            # view; the head-side read pin is held until every aliasing
            # array is gone (deferred release, _ShmReadPin), so spilling
            # or eviction can never pull the mapping out from under live
            # arrays. NOT appended to read_ids — the pin owns release.
            return self._read_shm_zero_copy(hex_id, view)
        if meta[0] == "p2p":
            value = self._p2p_zero_copy(hex_id, meta)
            if value is not _MISS:
                # Aliasing view straight out of a host-mapped arena:
                # the _ShmReadPin owns the read pin (released when the
                # last aliasing array dies) — NOT appended to read_ids.
                return value
            read_ids.append(hex_id)  # p2p metas are read-pinned too
            return self._read_p2p_retrying(hex_id, meta, read_ids)
        raise ObjectLostError(meta[1])

    def _host_arena(self, store: "str | None", capacity: int,
                    host: "str | None"):
        """Map another node's arena when it shares this host (boot-id
        match): logical nodes on one TPU host share physical RAM, so a
        'remote' payload is a memoryview away. Returns a cached
        ShmClient or None (off-host, unmappable, or disabled)."""
        if not self._host_shm_ok or not store or not host:
            return None
        from ray_tpu_torch._private import dataplane

        if host != dataplane.host_id():
            return None
        client = self._host_shms.get(store)
        if client is None and store not in self._host_shms:
            try:
                client = ShmClient(store, int(capacity))
            except (OSError, ValueError):
                client = None  # cache the failure: no retry per read
            self._host_shms[store] = client
        return client

    def _locate_on_agent(self, conn, object_id: str):
        """One cheap transfer-plane round trip: (offset, size) if the
        object is still resident in that agent's arena, else None."""
        try:
            r = conn.call("locate", {"object_id": object_id}, timeout=30)
        except (rpc.RpcError, rpc.ConnectionLost, OSError,
                FutureTimeoutError):
            return None
        return (r["offset"], r["size"]) if r.get("offset") is not None \
            else None

    def _read_validated(self, arena, conn, object_id: str, size: int):
        """Copy an object out of a host-mapped arena with the
        locate/read/locate handshake: direct reads carry no head pin,
        so the holder could spill or free the region mid-read — two
        matching locates bracket the copy (ids never re-seal at a
        different offset within an agent lifetime, so unchanged means
        the bytes are the object's). None on any mismatch; the caller
        falls back to a pulled or head-resolved copy."""
        loc1 = self._locate_on_agent(conn, object_id)
        if loc1 is None or loc1[1] != size:
            return None
        view = arena.view(loc1[0], size)
        try:
            payload = bytes(view)
        except (ValueError, IndexError):
            return None
        finally:
            view.release()
        if self._locate_on_agent(conn, object_id) != loc1:
            return None
        return payload

    def _agent_xfer_conn(self, addr: tuple):
        """Cached transfer-plane connection to a (possibly remote-node,
        same-host) agent."""
        key = (addr[0], int(addr[1]))
        conn = self._peer_conns.get(key)
        if conn is None or conn.closed:
            conn = self._peer_conns[key] = rpc.connect(key, name="xfer")
        return conn

    def _value_from_loc(self, hex_id: str, loc: dict):
        """Resolve a metadata-only seal straight from its holder — the
        zero-head-frames read path. Returns (payload, is_error, arr)
        for _deserialize, or None when the holder cannot serve (the
        caller falls back to a head meta, which re-resolves against
        replicas / spill copies / lineage). Direct reads are unpinned,
        so every shared-memory shortcut runs the validated-read
        handshake instead of trusting a stale offset."""
        from ray_tpu_torch._private import dataplane

        size = int(loc.get("size") or 0)
        is_error = bool(loc.get("is_error"))
        arr = loc.get("arr")
        if size <= 0:
            return None
        # Same node: this process maps the holder arena already.
        if (loc.get("node") == self.node_id and self.agent_shm is not None
                and self.agent_addr is not None):
            try:
                payload = self._read_validated(
                    self.agent_shm, self._agent(), hex_id, size)
            except (rpc.ConnectionLost, OSError):
                payload = None
            if payload is not None:
                dataplane.record("local", size)
                return payload, is_error, arr
        # Same host, different node: map the holder's arena file.
        ip, xfer = loc.get("ip"), loc.get("xfer_port")
        arena = self._host_arena(loc.get("store"), loc.get("cap") or 0,
                                 loc.get("host"))
        if arena is not None and ip and xfer:
            try:
                payload = self._read_validated(
                    arena, self._agent_xfer_conn((ip, xfer)), hex_id, size)
            except (rpc.ConnectionLost, OSError):
                payload = None
            if payload is not None:
                dataplane.record("local", size)
                return payload, is_error, arr
        # Cross-host: striped bulk pull from the holder node.
        port = int(loc.get("bulk_port") or 0)
        if not ip or not port:
            return None
        try:
            payload = self._pull_p2p(hex_id, (ip, port), size)
        except Exception:  # noqa: BLE001 — head path is the fallback
            return None
        dataplane.record("p2p", size)
        self._maybe_replicate(hex_id, payload, size, is_error,
                              loc.get("node"))
        return payload, is_error, arr

    def _p2p_zero_copy(self, hex_id: str, meta: tuple):
        """Zero-copy resolution of a read-pinned p2p meta when the
        holder arena is mappable from this process (same node, or same
        host via boot-id match). Safe without validation: the meta
        carries a head read pin, and both frees and head-driven spill
        skip pinned entries — the _ShmReadPin holds that pin until the
        last aliasing array dies. Returns _MISS when unmappable (the
        caller pulls a copy instead)."""
        from ray_tpu_torch._private import dataplane

        _, object_id, node_id, addr, offset, size, is_error = meta[:7]
        extra = meta[7] if len(meta) > 7 else None
        if (not self._dataplane_on or is_error
                or not GLOBAL_CONFIG.zero_copy_get):
            return _MISS
        if node_id == self.node_id and self.agent_shm is not None:
            arena = self.agent_shm
        else:
            arena = None
            if extra:
                arena = self._host_arena(extra.get("store"),
                                         extra.get("cap") or 0,
                                         extra.get("host"))
        if arena is None:
            return _MISS
        try:
            view = arena.view(offset, size)
        except (ValueError, IndexError):
            return _MISS
        dataplane.record("zero_copy", size, copies=0)
        return self._read_shm_zero_copy(hex_id, view)

    def _reresolve_meta(self, hex_id: str) -> "tuple | None":
        """One synchronous head round trip for a fresh meta (fallback
        path for stale owner/p2p metas). None on timeout."""
        waiter_id, fut = self._new_waiter()
        self.conn.cast("get_meta", {"waiter_id": waiter_id,
                                    "ids": [hex_id]})
        try:
            body = fut.result(30)
        except FutureTimeoutError:
            self.conn.cast("cancel_wait", {"waiter_id": waiter_id})
            return None
        finally:
            with self._waiters_lock:
                self._waiters.pop(waiter_id, None)
        return body["metas"][hex_id]

    def _read_p2p_retrying(self, hex_id: str, meta: tuple,
                           read_ids: list, attempts: int = 4) -> Any:
        """A pull can race the hosting node's death; the head marks the
        entry LOST and lineage re-executes the producer (reference:
        object_recovery_manager.h:43), so on failure re-resolve the meta
        through the head instead of surfacing a hard error. Only the
        TRANSPORT is retried — a stored user error deserializes (and
        raises) exactly once, outside the retry scope."""
        import time as _time

        for i in range(attempts):
            try:
                payload, is_error = self._fetch_p2p_bytes(meta)
            except (rpc.ConnectionLost, rpc.RpcError, ObjectLostError,
                    OSError):
                if i == attempts - 1:
                    raise
                _time.sleep(0.5 * (i + 1))
                waiter_id, fut = self._new_waiter()
                self.conn.cast("get_meta",
                               {"waiter_id": waiter_id, "ids": [hex_id]})
                try:
                    body = fut.result(30)
                except FutureTimeoutError:
                    # Leave no orphan waiter: a late reply would carry a
                    # fresh read pin nobody releases.
                    self.conn.cast("cancel_wait", {"waiter_id": waiter_id})
                    raise
                finally:
                    with self._waiters_lock:
                        self._waiters.pop(waiter_id, None)
                fresh = body["metas"][hex_id]
                if fresh[0] != "p2p":
                    # Reconstructed into the head store (or errored):
                    # resolve through the generic path.
                    return self._value_from_meta(hex_id, fresh, read_ids)
                read_ids.append(hex_id)  # new pin from the fresh meta
                meta = fresh
            else:
                return self._deserialize(payload, is_error)

    def get_async(self, ref: ObjectRef) -> Future:
        # Owner-local fast path (same as get()); _REMOTE markers mean
        # "stored big, resolve via head meta" — fall through.
        if self._census is not None:
            self._census.mark_awaited((ref.hex(),))
        if self._device_cache is not None:
            cached = self._device_cache.get(ref.hex())
            if cached is not None:
                result = Future()
                result.set_result(cached)
                return result
        v = self._owned_store.get(ref.hex())
        if v is not None and v[0] is _REMOTE:
            v = None
        if v is not None:
            result = Future()
            try:
                result.set_result(self._deserialize(*v))
            except Exception as e:  # noqa: BLE001 — stored task error
                result.set_exception(e)
            return result
        waiter_id, fut = self._new_waiter()
        result: Future = Future()

        def _done(f: Future):
            try:
                body = f.result()
                meta = body["metas"][ref.hex()]
                if meta[0] == "inline":
                    result.set_result(self._deserialize(meta[1], meta[2]))
                elif meta[0] == "shm":
                    view = self.shm.view(meta[1], meta[2])
                    try:
                        result.set_result(self._deserialize(bytes(view), meta[3]))
                    finally:
                        view.release()
                        self.conn.cast("read_done", {"ids": [ref.hex()]})
                elif meta[0] in ("p2p", "owner"):
                    # Network pull: never on the connection's dispatch
                    # thread (it would stall every other incoming head
                    # message for the transfer duration).
                    def _pull():
                        # _value_from_meta appends the pinned id itself
                        # for p2p metas (pre-seeding it here too used to
                        # double-release the pin); owner metas are not
                        # pinned on the head.
                        read_ids: list = []
                        try:
                            result.set_result(self._value_from_meta(
                                ref.hex(), meta, read_ids))
                        except Exception as e:  # noqa: BLE001
                            result.set_exception(e)
                        finally:
                            if read_ids:
                                try:
                                    self.conn.cast("read_done",
                                                   {"ids": read_ids})
                                except rpc.ConnectionLost:
                                    pass

                    threading.Thread(target=_pull, daemon=True,
                                     name="p2p-pull").start()
                else:
                    result.set_exception(ObjectLostError(meta[1]))
            except Exception as e:  # noqa: BLE001
                result.set_exception(e)

        fut.add_done_callback(_done)
        self.conn.cast("get_meta", {"waiter_id": waiter_id, "ids": [ref.hex()]})
        return result

    def _fetch_p2p_bytes(self, meta: tuple) -> tuple:
        """Transport half of a p2p read: ("p2p", object_id, node_id,
        (ip, port), offset, size, is_error[, extra]) -> (payload,
        is_error). Same-node readers copy out of the mapped agent
        arena; same-host readers (extra carries the holder's store
        name + host id) map the holder arena directly; everyone else
        pulls striped chunks from the hosting node's bulk server."""
        from ray_tpu_torch._private import dataplane

        _, object_id, node_id, addr, offset, size, is_error = meta[:7]
        extra = meta[7] if len(meta) > 7 else None
        if node_id == self.node_id and self.agent_shm is not None:
            view = self.agent_shm.view(offset, size)
            try:
                dataplane.record("local", size)
                return bytes(view), is_error
            finally:
                view.release()
        if extra:
            # Host-colocated copy read: the meta's read pin makes the
            # (offset, size) stable, so a direct arena copy is safe.
            arena = self._host_arena(extra.get("store"),
                                     extra.get("cap") or 0,
                                     extra.get("host"))
            if arena is not None:
                try:
                    view = arena.view(offset, size)
                    try:
                        dataplane.record("local", size)
                        return bytes(view), is_error
                    finally:
                        view.release()
                except (ValueError, IndexError):
                    pass  # implausible offset: fall through to a pull
        if addr is None:
            raise ObjectLostError(
                f"object {object_id} lives on node {node_id} with no "
                f"reachable transfer server",
                object_id=object_id, node_id=node_id)
        payload = self._pull_p2p(object_id, addr, size)
        dataplane.record(
            "relay" if extra and extra.get("relay") else "p2p", size)
        if node_id != self.node_id:
            self._maybe_replicate(object_id, payload, size, is_error,
                                  node_id)
        return payload, is_error

    def _maybe_replicate(self, object_id: str, payload, size: int,
                         is_error: bool, source_node) -> None:
        """Relay-tree fan-out: a completed reader registers its copy as
        a pull source (off the get path — the caller never waits on the
        cache write)."""
        if (self.agent_shm is None or is_error
                or source_node == self.node_id
                or size < GLOBAL_CONFIG.bulk_replicate_min):
            return
        threading.Thread(target=self._replicate_local,
                         args=(object_id, payload), daemon=True,
                         name="p2p-replicate").start()

    def _read_shm_zero_copy(self, hex_id: str, view) -> Any:
        """Deserialize directly out of the store mapping; see
        _ShmReadPin for the lifetime machinery."""
        import weakref

        ro = view.toreadonly()
        pin = _ShmReadPin(hex_id, self, (ro, view))
        wrappers = []

        def wrap(mv):
            # Lazy numpy: reached only for out-of-band buffers (tensor
            # payloads); pure-Python objects never import it.
            import numpy as _np

            holder = _np.frombuffer(mv, dtype=_np.uint8)
            wrappers.append(holder)
            return holder

        try:
            value = serialization.loads_from(ro, wrap_buffer=wrap)
        except BaseException:
            wrappers.clear()
            pin.release_now()
            raise
        if not wrappers:
            # No out-of-band buffers: nothing aliases the store.
            pin.release_now()
            return value
        pin.track(len(wrappers))
        for holder in wrappers:
            weakref.finalize(holder, pin.dec)
        return value

    def _deserialize(self, payload: bytes, is_error: bool,
                     arr: "dict | None" = None) -> Any:
        value = serialization.loads(payload)
        if not is_error and arr is not None:
            # Device-aware cross-node path: the seal metadata says the
            # producer returned a device array — rematerialize from the
            # zero-copy host view (dtype/shape ride the array itself;
            # sharding is advisory).
            from ray_tpu_torch._private import dataplane

            value = dataplane.rematerialize(value, arr)
        if is_error:
            if isinstance(value, dict) and "__rtpu_error__" in value:
                exc_cls = _ERROR_KINDS.get(value["__rtpu_error__"], RayTpuError)
                if exc_cls is ObjectLostError:
                    # Head-sealed losses carry provenance (which object,
                    # which node's death lost it, who owned it).
                    prov = value.get("provenance") or {}
                    raise ObjectLostError(
                        value["message"],
                        object_id=prov.get("object_id"),
                        node_id=prov.get("node_id"),
                        owner_id=prov.get("owner_id"))
                raise exc_cls(value["message"])
            if isinstance(value, BaseException):
                raise value
            raise RayTpuError(str(value))
        return value

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int = 1,
        timeout: float | None = None,
    ) -> tuple[list[ObjectRef], list[ObjectRef]]:
        id_list = [r.hex() for r in refs]
        by_id = {r.hex(): r for r in refs}
        unblock = None
        if self._pre_block is not None:
            try:
                unblock = self._pre_block()
            except Exception:
                pass
        waiter_id, fut = self._new_waiter()
        self.conn.cast(
            "wait", {"waiter_id": waiter_id, "ids": id_list, "num_returns": num_returns}
        )
        try:
            body = fut.result(timeout)
            ready_ids = body["ready"]
        except FutureTimeoutError:
            self.conn.cast("cancel_wait", {"waiter_id": waiter_id})
            ready_ids = self.conn.call("wait_check", {"ids": id_list})["ready"]
        finally:
            if unblock is not None:
                unblock()
        ready_set = set(ready_ids[:num_returns])
        ready = [by_id[i] for i in id_list if i in ready_set]
        not_ready = [by_id[i] for i in id_list if i not in ready_set]
        return ready, not_ready

    def wait_async(self, refs: Sequence[ObjectRef],
                   num_returns: int = 1) -> Future:
        """Non-blocking wait: a concurrent Future resolving to the list
        of ready ObjectRefs once >= num_returns are sealed (the head
        pushes wait_ready — no polling, no thread parked per waiter).
        Powers the async serve path."""
        id_list = [r.hex() for r in refs]
        by_id = {r.hex(): r for r in refs}
        waiter_id, fut = self._new_waiter()
        result: Future = Future()

        def _done(f: Future):
            try:
                ready_set = set(f.result()["ready"])
                result.set_result(
                    [by_id[i] for i in id_list if i in ready_set])
            except Exception as e:  # noqa: BLE001
                result.set_exception(e)

        fut.add_done_callback(_done)
        self.conn.cast("wait", {"waiter_id": waiter_id, "ids": id_list,
                                "num_returns": num_returns})
        return result

    def free(self, refs: Sequence[ObjectRef], force: bool = False) -> None:
        self.conn.call("free_objects", {"ids": [r.hex() for r in refs], "force": force})

    # ------------------------------------------------------------------
    # functions

    def register_function(self, fn: Any) -> str:
        # The id-keyed fast path must not outlive fn: a GC'd function's
        # address can be reused by a brand-new function, which would then
        # resolve to the WRONG func_id (observed with functions
        # deserialized in a loop, e.g. workflow step replay). A weakref
        # both validates identity and evicts the entry on collection —
        # no pinning, no unbounded growth.
        import weakref

        cached = self._fn_ids.get(id(fn))
        if cached is not None and cached[0]() is fn:
            return cached[1]
        blob = serialization.dumps_scoped(fn)
        func_id = "fn:" + hashlib.sha256(blob).hexdigest()[:32]
        self.conn.call("kv_put", {"ns": "__functions__", "key": func_id, "value": blob, "overwrite": False})
        try:
            key = id(fn)
            ref = weakref.ref(fn, lambda _, k=key: self._fn_ids.pop(k, None))
            self._fn_ids[key] = (ref, func_id)
        except TypeError:
            pass  # not weakref-able: skip the fast path; content hash dedups
        self._fn_cache[func_id] = fn
        return func_id

    def get_function(self, func_id: str) -> Any:
        fn = self._fn_cache.get(func_id)
        if fn is None:
            if func_id.startswith("path:"):
                # Cross-language invocation (reference:
                # cross_language.python_function — Java/C++ frontends
                # name Python functions by import path instead of
                # shipping pickled bytes): "path:module.sub:attr".
                import importlib

                mod_name, _, attr = func_id[5:].partition(":")
                if not mod_name or not attr:
                    raise RayTpuError(
                        f"malformed cross-language function id {func_id!r}"
                        f" (want 'path:module:attr')")
                obj = importlib.import_module(mod_name)
                for part in attr.split("."):
                    obj = getattr(obj, part)
                fn = getattr(obj, "_fn", obj)  # unwrap @remote
                self._fn_cache[func_id] = fn
                return fn
            reply = self.conn.call("kv_get", {"ns": "__functions__", "key": func_id})
            if reply["value"] is None:
                raise RayTpuError(f"function {func_id} not found in KV")
            fn = cloudpickle.loads(reply["value"])
            self._fn_cache[func_id] = fn
        return fn

    # ------------------------------------------------------------------
    # tasks / actors

    # Exact-type scalars: args made only of these cannot contain an
    # ObjectRef at any depth, so the ref-collecting (Python-class)
    # pickler pass is provably unnecessary — the C pickler runs ~10x
    # faster on the small-arg tasks that dominate flood workloads.
    _SCALAR_TYPES = frozenset({int, float, str, bytes, bool, type(None)})

    @staticmethod
    def pack_args(args: tuple,
                  kwargs: dict) -> tuple[bytes, list[str], list[str]]:
        """Returns (payload, deps, borrowed): deps are TOP-LEVEL refs
        (resolved + awaited before dispatch, reference semantics);
        borrowed are refs nested inside containers — passed as-is but
        pinned for the task's flight (reference: reference_count.h
        serialized-ref borrows)."""
        scalars = CoreRuntime._SCALAR_TYPES
        if (not kwargs and not serialization.custom_reducers
                and all(type(a) in scalars for a in args)):
            return pickle.dumps((args, {}), protocol=5), [], []
        deps = [
            a.hex() for a in list(args) + list(kwargs.values())
            if isinstance(a, ObjectRef)
        ]
        with serialization.collect_refs() as collected:
            packed = serialization.dumps_scoped((args, kwargs))
        borrowed = sorted(set(collected) - set(deps))
        return packed, deps, borrowed

    def _register_expected(self, spec: TaskSpec) -> None:
        """Owner plane active: get() on these return ids waits locally —
        every outcome (payload, big-object marker, error push) is
        delivered to this runtime."""
        if self.owner_addr is None or spec.streaming:
            return
        with self._owned_cond:
            for oid in spec.return_ids:
                self._expected_owned.add(oid)
        if self._census is not None:
            # Census: task returns this runtime will own, attributed to
            # the .remote() callsite (size stamps when the seal lands).
            self._census.record_many(spec.return_ids, "return",
                                     self._callsite())

    def seal_local_error(self, return_ids, message: str,
                         kind: str = "task_error") -> None:
        """Seal a typed error for owned return ids WITHOUT a round trip:
        stored straight into the owner store (local gets resolve now)
        and confirmed head-ward through the normal owner_sealed path so
        cross-client waiters and the directory stay consistent. Used by
        the owner-side overload plane (deadline sheds, direct-queue
        cancellation) — the error exists before the head ever saw the
        task."""
        payload = serialization.dumps(
            {"__rtpu_error__": kind, "message": message})
        self._store_owned_and_notify(
            [{"object_id": oid, "payload": payload, "is_error": True}
             for oid in return_ids])

    def admission_pending(self) -> int:
        """Results this owner has submitted for but not yet received —
        the owner-side half of the pending-task budget."""
        return len(self._expected_owned)

    def _admission_gate(self, spec: TaskSpec) -> None:
        """Owner-side admission control, applied BEFORE a submission
        leaves this process: past the per-owner pending budget (or
        while the head signals backpressure), block until the backlog
        drains (default) or raise PendingCallsLimitError
        (admission_mode="fail"). The head enforces the same budgets as
        the authoritative backstop; gating here turns its typed signal
        into submit-side flow control instead of failed tasks."""
        if self.owner_addr is None:
            return  # no owner plane: the head's backstop gate governs
        limit = int(GLOBAL_CONFIG.admission_max_pending_per_owner)
        over = limit > 0 and len(self._expected_owned) >= limit
        import time as _time

        now = _time.monotonic()
        pressured = now < self._backpressure_until
        if not over and not pressured:
            return
        why = (f"owner pending budget exhausted "
               f"({len(self._expected_owned)}/{limit} results outstanding)"
               if over else "head signalled backpressure")
        if GLOBAL_CONFIG.admission_mode == "fail":
            raise PendingCallsLimitError(
                f"submission of {spec.name} rejected: {why} "
                f"(admission_mode=fail)")
        # Blocking-submit: park until under the resume watermark (90% of
        # the budget — resubmitting at exactly limit-1 would thrash) and
        # past any backpressure horizon.
        deadline = now + max(0.1, GLOBAL_CONFIG.admission_block_timeout_s)
        resume = max(1, int(limit * 0.9)) if limit > 0 else 0
        with self._owned_cond:
            self._owned_waiters += 1
            try:
                while True:
                    now = _time.monotonic()
                    ok = limit <= 0 or len(self._expected_owned) < resume
                    if ok and now >= self._backpressure_until:
                        return
                    if now >= deadline:
                        raise PendingCallsLimitError(
                            f"submission of {spec.name} still over budget "
                            f"after blocking "
                            f"{GLOBAL_CONFIG.admission_block_timeout_s:.0f}s"
                            f": {why}")
                    wait_s = min(0.25, deadline - now)
                    if now < self._backpressure_until:
                        wait_s = min(wait_s,
                                     max(0.01,
                                         self._backpressure_until - now))
                    self._owned_cond.wait(wait_s)
            finally:
                self._owned_waiters -= 1

    @staticmethod
    def _stamp_trace(spec: TaskSpec) -> None:
        """Request tracing: copy the ambient (trace_id, parent_span_id,
        sampled) context onto the spec — it rides the compiled encoding
        as an optional trailing field (task_spec._trailing), so traced
        submissions cross every dispatch path with zero extra frames
        and traceless payloads stay byte-identical."""
        if not GLOBAL_CONFIG.trace_enabled:
            return
        from ray_tpu_torch._private import worker_context

        tc = worker_context.get_trace_context()
        if tc is not None:
            spec.trace_ctx = tuple(tc)

    def _spec_body(self, spec: TaskSpec) -> dict:
        """Compiled spec encoding when both ends support it
        (task_spec.pack_spec; negotiated at register). The packed bytes
        cache on the spec (pack_spec_cached), so a direct-plane
        spillback that already packed for a lease push reuses them
        here verbatim instead of re-encoding."""
        if getattr(self, "_head_specenc", False):
            from ray_tpu_torch._private.task_spec import pack_spec_cached

            packed = pack_spec_cached(spec)
            if packed is not None:
                return {"spec_bin": packed}
        return {"spec": spec}

    def submit_task(self, spec: TaskSpec) -> None:
        self._admission_gate(spec)
        # Results come straight back to this runtime's owner plane.
        spec.owner_addr = self.owner_addr
        self._register_expected(spec)
        if GLOBAL_CONFIG.task_events_enabled:
            # Flight recorder (events.py): the owner-side submit stamp.
            # Lives on the spec's scratch slot while in this process;
            # each wire hop carries it in the message's "evt" field.
            spec._evt = {"submit": time.time()}
        self._stamp_trace(spec)
        if self._direct is not None:
            # Lease-cached fast path (reference: the owner-side lease
            # cache, normal_task_submitter.cc:29): same-shape tasks ride
            # a granted worker lease owner→worker, zero head frames.
            if self._direct.submit_task(spec):
                return
            body = self._spec_body(spec)
            if spec._evt is not None:
                body["evt"] = dict(spec._evt)
            want = self._direct.lease_want(spec)
            if want is not None:
                # Piggyback the lease request on the head submit: the
                # head grants once it places this task on a leasable
                # worker, and subsequent same-shape tasks go direct.
                body["lease_key"] = want
            self.conn.cast_buffered("submit_task", body)
            return
        # Buffered: a submission burst ships as one CAST_BATCH frame.
        # Ordering vs a following get/wait is preserved because every
        # call()/cast() on the connection flushes the buffer first.
        body = self._spec_body(spec)
        if spec._evt is not None:
            body["evt"] = dict(spec._evt)
        self.conn.cast_buffered("submit_task", body)

    def submit_actor_task(self, spec: TaskSpec) -> None:
        self._admission_gate(spec)
        spec.owner_addr = self.owner_addr
        self._register_expected(spec)
        if GLOBAL_CONFIG.task_events_enabled:
            spec._evt = {"submit": time.time()}
        self._stamp_trace(spec)
        # Direct fast path: once the head has granted this owner the
        # actor's worker address, calls pipeline owner→worker (peer
        # connection FIFO + owner-side window) without a head hop.
        if self._direct is not None and self._direct.submit_actor(spec):
            return
        body = self._spec_body(spec)
        if spec._evt is not None:
            body["evt"] = dict(spec._evt)
        self.conn.cast_buffered("submit_actor_task", body)

    def create_actor(self, spec: ActorSpec) -> None:
        self.conn.call("create_actor", {"spec": spec})

    # ------------------------------------------------------------------

    def kv_put(self, key: str, value: bytes, ns: str = "", overwrite: bool = True) -> bool:
        return self.conn.call("kv_put", {"ns": ns, "key": key, "value": value, "overwrite": overwrite})["added"]

    def kv_get(self, key: str, ns: str = "") -> bytes | None:
        return self.conn.call("kv_get", {"ns": ns, "key": key})["value"]

    def kv_del(self, key: str, ns: str = "") -> bool:
        return self.conn.call("kv_del", {"ns": ns, "key": key})["deleted"]

    def kv_keys(self, prefix: str = "", ns: str = "") -> list[str]:
        return self.conn.call("kv_keys", {"ns": ns, "prefix": prefix})["keys"]

    def close(self) -> None:
        self._closed = True
        if self._direct is not None:
            try:
                self._direct.close()
            except Exception:
                pass
        ids_mod.set_ref_removed_callback(None)
        ids_mod.set_borrow_callbacks(None, None)
        if self.owner_server is not None:
            self.owner_server.stop()
        with self._owner_conns_lock:
            peers = list(self._owner_conns.values())
            self._owner_conns.clear()
        for c in peers:
            try:
                c.close()
            except Exception:
                pass
        self.conn.close()
        if self.shm is not None:
            self.shm.close()
