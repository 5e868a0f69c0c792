"""Owner-side direct-call plane: owner→worker dispatch off the head.

Counterpart of the reference's core-worker "direct call" architecture
(reference: src/ray/core_worker/transport/direct_actor_transport.h and
the owner-side lease cache in
core_worker/transport/normal_task_submitter.cc:29 — the SUBMITTER owns
its tasks and talks to leased workers directly; the GCS is a directory,
not a router). Before this plane, every actor method call and every
normal task rode the head: submit cast → head lock → queue → dispatch
thread → worker push. The head is now demoted to ASYNC bookkeeping on
the steady-state path:

  actor calls   owner ──direct_push──▶ actor's worker   (peer conn)
                owner ──task_started──▶ head            (buffered cast)
                worker ──seal_objects──▶ owner          (owner plane)
                worker ──task_finished──▶ head          (buffered cast)

  normal tasks  same, once the head has granted this owner a time/count
                bounded WORKER LEASE for the task's shape key
                (task_spec.shape_key); cache miss, window-full, lease
                expiry, TPU demand, or any explicit scheduling strategy
                falls back to the head path unchanged.

Invariants:
  * Ordering (actor calls): per handle, calls execute in submission
    order. Within the direct mode that is the peer connection's FIFO;
    across mode switches a DRAIN BARRIER applies — the owner only
    flips head→direct when no head-routed call is outstanding, and
    only re-enters direct after a spillback once every direct call has
    resolved, so the two streams never interleave at the worker.
  * Back-pressure: at most ``direct_window`` unresolved direct calls
    per actor route — beyond it calls queue OWNER-side (ordering).
    Normal tasks use per-lease windows of ``lease_window`` (default 1:
    a slow task must never serialize others behind it) across a POOL
    of leased workers; past the pool's idle capacity they spill to the
    head, which dispatches in parallel and grows the pool. The worker
    enforces its own ``direct_worker_inflight_max`` as a safety valve
    and rejects past it (direct_rej → head path).
  * Failure: direct connections ride the chaos plane (faultinject at
    the rpc layer, per-owner circuit breaker + identity check on
    dial). Delivery is acked (direct_ack); an unacked call past
    ``direct_resubmit_timeout_s``, a dead peer connection, or a head
    revoke cast re-routes outstanding calls through the head's
    existing restart/requeue machinery (direct_recover — deduped
    head-side by task state, so head-known in-flight work is never
    double-requeued).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.task_spec import (TaskSpec, pack_spec_cached,
                                        shape_key)


class _ActorRoute:
    __slots__ = ("actor_id", "addr", "worker_id", "gpu_ids", "specenc",
                 "mode", "pending", "tasks", "head_oids", "last_info_req",
                 "out_of_order", "send_lock")

    def __init__(self, actor_id: str):
        self.actor_id = actor_id
        self.addr: "tuple | None" = None     # worker owner-plane addr
        self.worker_id: "str | None" = None
        self.gpu_ids: list = []
        self.specenc = False                 # worker unpacks compiled specs
        self.mode = "head"                   # "head" | "direct"
        # task_id -> [spec, remaining return-oid set, t_submit, acked]
        self.tasks: dict[str, list] = {}
        self.pending: deque = deque()        # not-yet-pushed, in order
        self.head_oids: set = set()          # drain barrier (head-routed)
        self.last_info_req = 0.0
        self.out_of_order = False
        # Serializes pop+push so a submitter thread and a resolver
        # thread can never reorder two calls onto the wire.
        self.send_lock = threading.Lock()


class _Lease:
    """One leased worker for one task shape. ``window`` bounds OWNER-
    side inflight per lease — default 1: a normal task never queues
    behind another on a leased worker (a slow task must not serialize
    a quick one; the head's own pipelining still applies on its path).
    Parallelism comes from the POOL: the head grants additional leases
    as same-shape spillover lands on other leasable workers, and the
    owner round-robins across them."""

    __slots__ = ("key", "addr", "worker_id", "specenc", "deadline",
                 "calls_left", "window", "inflight", "cool_until")

    def __init__(self, key, addr, worker_id, specenc, ttl, calls, window):
        self.key = key
        self.addr = tuple(addr)
        self.worker_id = worker_id
        self.specenc = specenc
        self.deadline = time.monotonic() + ttl
        self.calls_left = calls
        self.window = max(1, window)
        self.inflight = 0
        # Set on a direct_rej bounce (worker busy with head-pushed
        # work): round-robin skips this lease until the stamp passes so
        # a burst doesn't ping-pong every task off the same worker.
        self.cool_until = 0.0

    def usable(self) -> bool:
        return self.calls_left > 0 and time.monotonic() < self.deadline


class DirectPlane:
    """One per CoreRuntime. All state under ``self.lock``; pushes and
    head calls happen OUTSIDE it (they may dial / block on sockets)."""

    def __init__(self, rt):
        self.rt = rt
        self.lock = threading.Lock()
        self.routes: dict[str, _ActorRoute] = {}
        # Shape key -> pool of leased workers (round-robined; the head
        # grants a new lease whenever same-shape spillover lands on
        # another leasable worker, so the pool tracks real parallelism).
        self.lease_pools: dict[tuple, list] = {}
        # task_id -> [spec, remaining-oid set, t_submit, acked, lease]
        # for every direct-dispatched NORMAL task (flat across pools).
        self.lease_tasks: dict[str, list] = {}
        # return oid -> (kind, route-or-lease key, task_id);
        # kind: "actor" (direct), "ahead" (head-routed, drain barrier),
        # "lease" (direct normal task).
        self.by_oid: dict[str, tuple] = {}
        self.window = max(1, int(GLOBAL_CONFIG.direct_window))
        self._lease_wants: dict[tuple, float] = {}
        self._rr = 0
        # Counters surfaced through ray_tpu_torch.util.metrics.rpc_counters.
        self.stats = {"direct_actor_calls": 0, "direct_lease_tasks": 0,
                      "spillbacks": 0, "recovered": 0,
                      # Overload plane: deadline-expired calls shed from
                      # the owner-side queues, and direct cancellations.
                      "shed_owner_queue": 0, "cancelled_owner_queue": 0}

    # ------------------------------------------------------------------
    # submission fast paths (called from CoreRuntime.submit_*)

    def submit_actor(self, spec: TaskSpec) -> bool:
        """True = dispatched on the direct plane (or queued for it)."""
        if spec.streaming:
            # Streaming items seal through the head store, so the local
            # resolution hook never fires for them — head path.
            return False
        with self.lock:
            r = self.routes.get(spec.actor_id)
            if r is None:
                r = self.routes[spec.actor_id] = _ActorRoute(spec.actor_id)
            if r.mode != "direct" or r.addr is None or r.out_of_order:
                # Head path; track outstanding ids for the drain barrier
                # and (re-)ask the head for a direct grant.
                for oid in spec.return_ids:
                    r.head_oids.add(oid)
                    self.by_oid[oid] = ("ahead", spec.actor_id, spec.task_id)
                self._maybe_request_info_locked(r)
                return False
            self._track_locked(r.tasks, "actor", spec.actor_id, spec)
            r.pending.append(spec)         # all pushes flow through here
        self._drain_route(r)
        return True

    def _drain_route(self, r: _ActorRoute) -> None:
        """Pop+push queued calls while the inflight window has room.
        The per-route send lock makes pop-to-wire atomic across the
        submitter and resolver threads — ordered actors rely on it.
        Deadline-expired calls are shed at pop (typed TaskTimeoutError
        sealed locally) instead of burning the window."""
        with r.send_lock:
            while True:
                expired = None
                with self.lock:
                    if (r.mode != "direct" or r.addr is None
                            or not r.pending
                            or (len(r.tasks) - len(r.pending)
                                >= self.window)):
                        return
                    spec = r.pending.popleft()
                    if spec.deadline and time.time() > spec.deadline:
                        r.tasks.pop(spec.task_id, None)
                        self.stats["shed_owner_queue"] += 1
                        expired = spec
                    else:
                        addr, wid = r.addr, r.worker_id
                        chips, enc = r.gpu_ids, r.specenc
                if expired is not None:
                    self._seal_shed(expired)
                    continue
                self._push(addr, wid, spec, chips, enc, kind="actor")

    def _seal_shed(self, spec: TaskSpec) -> None:
        """Seal a TaskTimeoutError for a deadline-expired call shed
        owner-side (never sent anywhere). Outside self.lock — sealing
        re-enters the plane through on_resolved."""
        try:
            self.rt.seal_local_error(
                spec.return_ids,
                f"TaskTimeoutError: task {spec.name} exceeded its "
                f"deadline while queued owner-side (shed before dispatch)",
                kind="task_timeout")
        except Exception:
            pass

    @staticmethod
    def _lease_eligible(spec: TaskSpec) -> bool:
        return (spec.scheduling_strategy is None and not spec.streaming
                and float((spec.resources or {}).get("GPU", 0)) <= 0)

    def submit_task(self, spec: TaskSpec) -> bool:
        """True = dispatched directly on a cached worker lease. Picks
        an IDLE lease from the shape's pool (round-robin): a normal
        task never queues owner-side behind another — a slow task on
        one leased worker must not serialize quick ones, so anything
        beyond the pool's idle capacity spills back to the head (which
        dispatches in parallel and grows the pool with fresh grants)."""
        if not self._lease_eligible(spec):
            return False
        if spec.deps and any(d in self.rt._expected_owned
                             for d in spec.deps):
            # A dep THIS owner is still awaiting would make the leased
            # worker block in arg resolution — binding the lease (window
            # 1) to a wait of unknown length, invisible to deadline
            # shedding. The head parks it in dep_blocked instead and
            # dispatches on the seal (event-driven, no worker held).
            return False
        key = shape_key(spec)
        with self.lock:
            pool = self.lease_pools.get(key)
            if not pool:
                return False
            for lease in [l for l in pool if not l.usable()]:
                self._remove_lease_locked(lease, ret=True)
            if not pool:
                return False
            self._rr += 1
            n = len(pool)
            now = time.monotonic()
            lease = next(
                (pool[(self._rr + i) % n] for i in range(n)
                 if pool[(self._rr + i) % n].inflight
                 < pool[(self._rr + i) % n].window
                 and pool[(self._rr + i) % n].cool_until <= now), None)
            if lease is None:
                self.stats["spillbacks"] += 1
                return False               # pool busy: head path
            lease.calls_left -= 1
            lease.inflight += 1
            self.lease_tasks[spec.task_id] = [
                spec, set(spec.return_ids), time.monotonic(), False,
                lease]
            for oid in spec.return_ids:
                self.by_oid[oid] = ("lease", key, spec.task_id)
            addr, wid, enc = lease.addr, lease.worker_id, lease.specenc
        if self.rt._census is not None:
            self.rt._census.mark_direct(spec.return_ids)
        self._push(addr, wid, spec, [], enc, kind="lease")
        return True

    def lease_want(self, spec: TaskSpec) -> "tuple | None":
        """Shape key to request a lease for (rides the head submit), or
        None when the task is ineligible / the want is throttled. Also
        asked while a pool EXISTS but ran out of idle capacity — the
        head then leases the worker this spillover task lands on,
        growing the pool to the shape's real parallelism."""
        if not self._lease_eligible(spec):
            return None
        key = shape_key(spec)
        with self.lock:
            # Throttle: one outstanding request per shape per second —
            # a submission burst must not ask for a lease on every task
            # (the head dedups too, but the bytes are pure waste).
            now = time.monotonic()
            if now - self._lease_wants.get(key, 0.0) < 1.0:
                return None
            self._lease_wants[key] = now
        return key

    def _track_locked(self, table: dict, kind: str, route_key, spec) -> None:
        table[spec.task_id] = [spec, set(spec.return_ids),
                               time.monotonic(), False]
        for oid in spec.return_ids:
            self.by_oid[oid] = (kind, route_key, spec.task_id)
        if self.rt._census is not None:
            # Object census: these returns rode the direct plane (the
            # `ray-tpu memory` kind column shows return+direct).
            self.rt._census.mark_direct(spec.return_ids)

    def _maybe_request_info_locked(self, r: _ActorRoute) -> None:
        now = time.monotonic()
        if r.addr is not None or now - r.last_info_req < 0.2:
            return
        r.last_info_req = now
        try:
            self.rt.conn.cast_buffered("actor_direct_info",
                                       {"actor_id": r.actor_id})
        except rpc.ConnectionLost:
            pass

    # ------------------------------------------------------------------
    # wire

    def _spec_body(self, spec: TaskSpec, specenc: bool) -> dict:
        """Compiled-encoding body. The packed bytes stay CACHED on the
        spec (pack_spec_cached): one push used to pack twice (the push
        itself + the task_started bookkeeping cast re-packed because
        the cache was dropped after first use), and recovery paths —
        retry, re-push after a direct_rej bounce, spillback through
        direct_recover — re-encoded from scratch. Owner-side specs are
        dropped when their task resolves, so the small cached copy
        can't accumulate."""
        if specenc:
            packed = pack_spec_cached(spec)
            if packed is not None:
                return {"spec_bin": packed}
        return {"spec": spec}

    def _push(self, addr, worker_id, spec, gpu_ids, specenc,
              kind: str) -> None:
        """Ship one spec to the worker's peer server, plus the buffered
        task_started bookkeeping cast to the head. Failures mark the
        task for immediate recovery (the watchdog re-routes it)."""
        body = self._spec_body(spec, specenc)
        if gpu_ids:
            body["gpu_ids"] = gpu_ids
        evt = None
        if spec._evt is not None:
            # Flight recorder: the direct-plane push stamp rides the
            # push itself AND the buffered task_started bookkeeping (so
            # the head's event table sees in-flight direct tasks too) —
            # zero new frames, two floats on frames that already flow.
            # The spec's own stamp dict is reused as the wire payload
            # (not copied): the spec is owner-resident and nothing
            # mutates its stamps after this push.
            evt = spec._evt
            evt["push"] = time.time()
            body["evt"] = evt
        try:
            conn = self.rt._peer_owner_conn(
                tuple(addr), expect_owner=worker_id,
                handler=self.rt._handle_direct_client)
            conn.cast_buffered("direct_push", body)
            self.stats["direct_actor_calls" if kind == "actor"
                       else "direct_lease_tasks"] += 1
        except (OSError, rpc.RpcError, rpc.ConnectionLost):
            self._expire_task(spec.task_id)
        # Async bookkeeping: the head learns the task exists (directory
        # entries, task table, dep pins, inflight registration for its
        # own death-recovery machinery) OFF the latency path.
        started = self._spec_body(spec, self.rt._head_specenc)
        started["worker_id"] = worker_id
        started["direct"] = kind
        if evt is not None:
            started["evt"] = evt
        try:
            self.rt.conn.cast_buffered("task_started", started)
        except rpc.ConnectionLost:
            pass

    def _expire_task(self, task_id: str) -> None:
        with self.lock:
            for table in self._tables():
                rec = table.get(task_id)
                if rec is not None:
                    rec[2] = 0.0            # watchdog recovers it now
                    return

    def _tables(self):
        for r in self.routes.values():
            yield r.tasks
        yield self.lease_tasks

    # ------------------------------------------------------------------
    # inbound: head control casts + worker acks

    def on_head_msg(self, kind: str, body: dict) -> bool:
        if kind == "actor_direct_grant":
            with self.lock:
                r = self.routes.get(body["actor_id"])
                if r is None:
                    r = self.routes[body["actor_id"]] = _ActorRoute(
                        body["actor_id"])
                r.addr = tuple(body["addr"])
                r.worker_id = body["worker_id"]
                r.gpu_ids = list(body.get("gpu_ids") or ())
                r.specenc = bool(body.get("specenc"))
                r.out_of_order = bool(body.get("out_of_order"))
                self._maybe_enter_direct_locked(r)
            return True
        if kind == "actor_direct_revoke":
            with self.lock:
                r = self.routes.get(body["actor_id"])
                if r is not None:
                    r.addr = None
                    r.worker_id = None
                    r.mode = "head"
                    # In-flight AND queued calls all re-route through
                    # the head on the next watchdog tick, in seq order.
                    for rec in r.tasks.values():
                        rec[2] = 0.0
            return True
        if kind == "lease_grant":
            key = tuple(tuple(k) if isinstance(k, list) else k
                        for k in body["key"])
            with self.lock:
                pool = self.lease_pools.setdefault(key, [])
                if not any(l.worker_id == body["worker_id"]
                           for l in pool):
                    pool.append(_Lease(
                        key, body["addr"], body["worker_id"],
                        bool(body.get("specenc")),
                        float(body.get("ttl_s",
                                       GLOBAL_CONFIG.lease_ttl_s)),
                        int(body.get("max_calls",
                                     GLOBAL_CONFIG.lease_max_calls)),
                        int(body.get("window") or 1)))
                self._lease_wants.pop(key, None)
            return True
        if kind == "lease_revoke":
            with self.lock:
                for pool in list(self.lease_pools.values()):
                    for lease in [l for l in pool
                                  if l.worker_id == body.get("worker_id")]:
                        self._remove_lease_locked(lease, ret=False)
            return True
        return False

    def on_worker_msg(self, kind: str, body: dict) -> None:
        if kind == "direct_ack":
            with self.lock:
                for tid in body.get("task_ids") or ():
                    for table in self._tables():
                        rec = table.get(tid)
                        if rec is not None:
                            rec[3] = True
                            break
        elif kind == "direct_rej":
            # Worker-side back-pressure / retirement: spill to the head.
            self.stats["spillbacks"] += 1
            tid = body.get("task_id", "")
            item = None
            with self.lock:
                rec = self.lease_tasks.pop(tid, None)
                if rec is not None:
                    lease = rec[4]
                    if lease is not None:
                        lease.inflight = max(0, lease.inflight - 1)
                        lease.cool_until = time.monotonic() + 0.25
                    for oid in rec[1]:
                        self.by_oid.pop(oid, None)
                    item = (rec[0], lease.worker_id if lease else None)
            if item is not None:
                # A bounced lease task re-routes NOW, off this reader
                # thread — the watchdog's idle backoff (up to 2 s) is
                # too slow for a task its caller may be blocked on.
                threading.Thread(target=self._send_recover,
                                 args=([item],), daemon=True,
                                 name="lease-rej-recover").start()
            else:
                # Actor-route call: the watchdog re-routes it (and
                # everything queued behind it) in seq order.
                self._expire_task(tid)

    def on_reconnect(self) -> None:
        """The driver re-registered with a new/restarted head — possibly
        a DIFFERENT dispatch shard of a sharded head (head_shards.py).
        Every grant the old head issued is void there: drop all routes
        back to head mode and all leases without lease_return (the old
        head is gone; the new one never issued them). In-flight calls
        re-route through the new head on the next watchdog tick with the
        usual seq-order/dedup machinery."""
        with self.lock:
            for r in self.routes.values():
                r.addr = None
                r.worker_id = None
                r.mode = "head"
                for rec in r.tasks.values():
                    rec[2] = 0.0
            for pool in list(self.lease_pools.values()):
                for lease in list(pool):
                    self._remove_lease_locked(lease, ret=False)
            self._lease_wants.clear()

    def on_peer_close(self, addr: tuple) -> None:
        """A direct connection died: every route/lease over it re-routes
        through the head (picked up by the next watchdog tick)."""
        addr = tuple(addr)
        with self.lock:
            for r in self.routes.values():
                if r.addr == addr:
                    r.addr = None
                    r.worker_id = None
                    r.mode = "head"
                    for rec in r.tasks.values():
                        rec[2] = 0.0
            for pool in list(self.lease_pools.values()):
                for lease in [l for l in pool if l.addr == addr]:
                    self._remove_lease_locked(lease, ret=False)

    def _remove_lease_locked(self, lease: _Lease, ret: bool) -> None:
        pool = self.lease_pools.get(lease.key)
        if pool is not None and lease in pool:
            pool.remove(lease)
            if not pool:
                self.lease_pools.pop(lease.key, None)
        if ret:
            try:
                self.rt.conn.cast_buffered(
                    "lease_return", {"worker_id": lease.worker_id})
            except rpc.ConnectionLost:
                pass
        if not ret:
            # Worker dead/revoked: UNACKED tasks re-route through the
            # head now (their pushes may have died in a socket buffer).
            # Acked tasks stay — a retiring worker still drains them,
            # and a dead worker's head-registered inflight is requeued
            # by the head's own death machinery (recovery dedups).
            for rec in self.lease_tasks.values():
                if rec[4] is lease and not rec[3]:
                    rec[2] = 0.0

    # ------------------------------------------------------------------
    # resolution + drain

    def known_direct_oids(self, oids) -> frozenset:
        """Subset of ``oids`` that belong to DIRECT-dispatched tasks
        (actor or lease) — their head entries may not exist yet, so the
        owner_sealed bodies carry a create flag for them."""
        with self.lock:
            return frozenset(
                oid for oid in oids
                if self.by_oid.get(oid, ("",))[0] in ("actor", "lease"))

    def on_resolved(self, oids) -> None:
        """Called by the runtime whenever owned return ids resolve
        (seal delivered, error pushed, or freed): frees window slots,
        drains the owner-side pending queue, and clears drain barriers."""
        drain = []
        with self.lock:
            touched: set = set()
            for oid in oids:
                info = self.by_oid.pop(oid, None)
                if info is None:
                    continue
                kind, route_key, task_id = info
                if kind == "ahead":
                    r = self.routes.get(route_key)
                    if r is not None:
                        r.head_oids.discard(oid)
                        touched.add(route_key)
                    continue
                if kind == "lease":
                    rec = self.lease_tasks.get(task_id)
                    if rec is None:
                        continue
                    rec[1].discard(oid)
                    if not rec[1]:
                        self.lease_tasks.pop(task_id, None)
                        lease = rec[4]
                        if lease is not None:
                            lease.inflight = max(0, lease.inflight - 1)
                    continue
                r = self.routes.get(route_key)
                table = r.tasks if r is not None else None
                touched.add(route_key)
                if table is None:
                    continue
                rec = table.get(task_id)
                if rec is None:
                    continue
                rec[1].discard(oid)
                if not rec[1]:
                    table.pop(task_id, None)
            for actor_id in touched:
                r = self.routes.get(actor_id)
                if r is None:
                    continue
                self._maybe_enter_direct_locked(r)
                if r.pending:
                    drain.append(r)
        for r in drain:
            self._drain_route(r)

    def _maybe_enter_direct_locked(self, r: _ActorRoute) -> None:
        """Drain barrier: direct mode only with a grant in hand and no
        head-routed call outstanding (ordering across the switch)."""
        if (r.mode == "head" and r.addr is not None and not r.head_oids
                and not r.out_of_order and not r.tasks):
            r.mode = "direct"

    # ------------------------------------------------------------------
    # watchdog (driven from the runtime's release loop)

    def cancel_local(self, target_id: str) -> "str | None":
        """Owner-side half of ray_tpu_torch.cancel for direct-plane tasks the
        head cannot see: a call queued owner-side in the direct window
        is removed and sealed with the standard cancellation error
        ("cancelled"); a call already pushed owner→worker is signalled
        over the peer connection ("signalled" — the worker drops it at
        pickup, exactly like the head's cancel cast). None = this plane
        does not know the task (head path owns it). ``target_id``
        matches a task id or any of its return ids (the public
        cancel(ref) passes the ref)."""
        cancelled = None
        signal_addr = None
        task_id = None
        with self.lock:
            info = self.by_oid.get(target_id)
            for r in self.routes.values():
                spec = next(
                    (s for s in r.pending
                     if s.task_id == target_id
                     or target_id in s.return_ids), None)
                if spec is not None:
                    r.pending.remove(spec)
                    r.tasks.pop(spec.task_id, None)
                    self.stats["cancelled_owner_queue"] += 1
                    cancelled = spec
                    break
            if cancelled is None and info is not None:
                kind, route_key, task_id = info
                if kind == "actor":
                    r = self.routes.get(route_key)
                    if (r is not None and r.addr is not None
                            and task_id in r.tasks):
                        signal_addr = r.addr
                elif kind == "lease":
                    rec = self.lease_tasks.get(task_id)
                    if rec is not None and rec[4] is not None:
                        signal_addr = rec[4].addr
        if cancelled is not None:
            try:
                self.rt.seal_local_error(
                    cancelled.return_ids,
                    "TaskCancelledError: cancelled before execution")
            except Exception:
                pass
            return "cancelled"
        if signal_addr is not None:
            try:
                conn = self.rt._peer_owner_conn(tuple(signal_addr))
                conn.cast("cancel_direct", {"task_id": task_id})
                return "signalled"
            except (OSError, rpc.RpcError, rpc.ConnectionLost):
                return None  # peer gone: head-side recovery owns it
        return None

    def _drain_native_acks(self) -> None:
        """Fold delivery acks the native readers consumed in C (ack
        sink, rpc.Connection.set_ack_sink) into the same bookkeeping
        the Python path uses. Bulk drain: one Python pass per watchdog
        tick / route_load instead of one wakeup per ack frame."""
        rt = self.rt
        lock = getattr(rt, "_owner_conns_lock", None)
        if lock is None:
            return
        with lock:
            conns = list(rt._owner_conns.values())
        for c in conns:
            tids = c.take_native_acks()
            if tids:
                self.on_worker_msg("direct_ack", {"task_ids": tids})

    def tick(self) -> None:
        self._drain_native_acks()
        timeout = GLOBAL_CONFIG.direct_resubmit_timeout_s
        now = time.monotonic()
        recover: list = []
        shed: list = []
        wall = time.time()
        with self.lock:
            # Overload plane: deadline-expired calls still parked in the
            # owner-side direct queues are shed here (pop-time checks in
            # _drain_route cover the hot path; this sweep catches calls
            # a full window keeps parked).
            for r in self.routes.values():
                if not r.pending:
                    continue
                expired = [s for s in r.pending
                           if s.deadline and wall > s.deadline]
                for s in expired:
                    r.pending.remove(s)
                    r.tasks.pop(s.task_id, None)
                    self.stats["shed_owner_queue"] += 1
                    shed.append(s)
        for s in shed:
            self._seal_shed(s)
        with self.lock:
            for r in self.routes.values():
                pending_ids = {s.task_id for s in r.pending}
                late = [tid for tid, rec in r.tasks.items()
                        if tid not in pending_ids
                        and (rec[2] == 0.0
                             or (not rec[3] and now - rec[2] > timeout))]
                if not late and (r.mode == "direct" or not r.pending):
                    continue
                # Re-route late in-flight calls — and EVERYTHING queued
                # behind them (ordering: queued calls must not overtake
                # re-routed ones) — through the head, in seq order.
                wid = r.worker_id
                late_specs = sorted((r.tasks.pop(tid)[0] for tid in late),
                                    key=lambda s: s.seq_no)
                for spec in late_specs:
                    for oid in spec.return_ids:
                        r.head_oids.add(oid)
                        self.by_oid[oid] = ("ahead", r.actor_id,
                                            spec.task_id)
                    recover.append((spec, wid))
                for s in r.pending:
                    r.tasks.pop(s.task_id, None)
                    for oid in s.return_ids:
                        r.head_oids.add(oid)
                        self.by_oid[oid] = ("ahead", r.actor_id, s.task_id)
                    recover.append((s, wid))
                r.pending.clear()
                r.mode = "head"
            for pool in list(self.lease_pools.values()):
                for lease in [l for l in pool if not l.usable()]:
                    self._remove_lease_locked(lease, ret=True)
            late = [tid for tid, rec in self.lease_tasks.items()
                    if (rec[2] == 0.0
                        or (not rec[3] and now - rec[2] > timeout))]
            for tid in late:
                rec = self.lease_tasks.pop(tid)
                if rec[4] is not None:
                    rec[4].inflight = max(0, rec[4].inflight - 1)
                for oid in rec[1]:
                    self.by_oid.pop(oid, None)
                recover.append((rec[0],
                                rec[4].worker_id if rec[4] else None))
        if recover:
            self._send_recover(recover)

    def _send_recover(self, items) -> None:
        """Hand re-routed specs back to the head (call, retried): the
        head dedups by task state so work it already requeued through
        its own death handling is never double-submitted."""
        from ray_tpu_torch._private.retry import default_policy

        specs = []
        for spec, worker_id in items:
            body = self._spec_body(spec, self.rt._head_specenc)
            body["worker_id"] = worker_id
            specs.append(body)
        self.stats["recovered"] += len(specs)
        try:
            self.rt.conn.call("direct_recover", {"specs": specs},
                              timeout=30, retry=default_policy())
        except Exception:
            # Head unreachable right now: re-arm the watchdog so the
            # specs are retried instead of lost (leaseless zombie
            # records; recovery re-attempts on later ticks).
            with self.lock:
                for spec, _w in items:
                    remaining = {oid for oid in spec.return_ids
                                 if self.by_oid.get(oid)}
                    self.lease_tasks[spec.task_id] = [
                        spec, remaining, 0.0, False, None]

    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        with self.lock:
            return {
                **self.stats,
                "actor_routes_direct": sum(
                    1 for r in self.routes.values() if r.mode == "direct"),
                "leases": sum(len(p) for p in self.lease_pools.values()),
                "outstanding": sum(len(t) for t in self._tables()),
            }

    def route_load(self, actor_id: str) -> dict:
        """Owner-side load view of one actor route, for load-aware
        routing (serve DeploymentHandle): ``outstanding`` calls not yet
        resolved, ``unacked`` of those pushed but not delivery-acked,
        and ``queued`` parked owner-side behind the direct window. A
        dead or wedged replica shows up as growing ``unacked`` within
        one ack RTT — long before health probes or the resubmit
        watchdog fire — so routers can deprioritize it immediately."""
        self._drain_native_acks()
        with self.lock:
            r = self.routes.get(actor_id)
            if r is None:
                return {"outstanding": 0, "unacked": 0, "queued": 0,
                        "mode": "head"}
            pending_ids = {s.task_id for s in r.pending}
            unacked = sum(1 for tid, rec in r.tasks.items()
                          if tid not in pending_ids and not rec[3])
            return {"outstanding": len(r.tasks), "unacked": unacked,
                    "queued": len(r.pending), "mode": r.mode}

    def close(self) -> None:
        with self.lock:
            for pool in list(self.lease_pools.values()):
                for lease in list(pool):
                    self._remove_lease_locked(lease, ret=True)
