"""Flight-recorder task event plane: lifecycle phases, the head's
bounded event table, clock alignment, and phase-latency histograms.

Counterpart of the reference's TaskEventBuffer + GcsTaskManager pair
(reference: src/ray/core_worker/task_event_buffer.h:225 — workers batch
task status/profile events onto existing flushes; gcs_task_manager.h:159
— the GCS keeps a bounded ring of them for `ray timeline` and the state
API). Here every hop of a task's life stamps a monotonic wall-clock
phase onto the EXISTING control-plane messages (submit body, direct
push, push_task, task_started, task_finished, owner_sealed) so the
direct-call plane's zero-per-call-head-frames property survives
instrumentation: no new frames, only a few floats riding frames that
already flow.

Phases (PHASE_ORDER) and the clock that stamped each (PHASE_DOMAIN):

  submit      owner   runtime.submit_task / submit_actor_task
  enqueue     head    head received the submission (head-routed path)
  dispatch    head    head pushed the spec to a worker
  push        owner   owner pushed the spec directly (direct plane)
  recv        worker  the push landed on the executing process
  exec_start  worker  user code started
  exec_end    worker  user code returned
  seal        worker  results handed to the owner plane / head
  resolve     owner   the owner confirmed holding the results

Cross-node alignment: timestamps are each host's time.time(). The head
keeps per-node clock offsets (node_clock - head_clock), estimated
NTP-style over the agent heartbeat loop (node_agent._heartbeat_loop ->
_h_clock_sync), and align_phases() maps every stamp onto the head's
clock so spans line up across machines in one trace.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

PHASE_ORDER = ("submit", "enqueue", "dispatch", "push", "recv",
               "exec_start", "exec_end", "seal", "resolve")

# Which process's clock stamped each phase: "owner" = the submitting
# runtime, "head" = the head service, "worker" = the executing worker
# (whose clock is its node's clock — same machine as its agent).
PHASE_DOMAIN = {
    "submit": "owner", "push": "owner", "resolve": "owner",
    "enqueue": "head", "dispatch": "head",
    "recv": "worker", "exec_start": "worker", "exec_end": "worker",
    "seal": "worker",
}

# (start_phase, end_phase, label): the named sub-spans timeline() renders
# per task. Adjacent stamps only; absent phases skip their segment, so a
# head-routed task shows queue/dispatch and a direct task shows
# submit->push instead — ≥5 segments either way on a complete record.
PHASE_SEGMENTS = (
    ("submit", "enqueue", "submit"),
    ("submit", "push", "submit"),
    ("enqueue", "dispatch", "queue"),
    ("dispatch", "recv", "dispatch"),
    ("push", "recv", "dispatch"),
    ("recv", "exec_start", "dequeue"),
    ("exec_start", "exec_end", "exec"),
    ("exec_end", "seal", "seal"),
    ("seal", "resolve", "resolve"),
)


def align_phases(event: dict, offsets: "dict | None",
                 head_node_id: "str | None" = None) -> dict:
    """Map one lifecycle event's phase stamps onto the HEAD's clock.

    ``offsets`` is {node_id: node_clock - head_clock} (the head's table,
    estimated from agent heartbeat probes); a node without an estimate —
    including the head node itself and drivers co-located with it —
    aligns with offset 0. Worker-domain phases use the executing node's
    offset, owner-domain phases the owner node's; head-domain phases are
    already on the head clock."""
    offsets = offsets or {}
    node = event.get("node_id")
    owner_node = event.get("owner_node_id")
    out = {}
    for phase, ts in (event.get("phases") or {}).items():
        if not isinstance(ts, (int, float)):
            continue
        domain = PHASE_DOMAIN.get(phase, "worker")
        if domain == "worker":
            nid = node
        elif domain == "owner":
            nid = owner_node
        else:
            nid = head_node_id
        off = offsets.get(nid, 0.0) if nid else 0.0
        out[phase] = ts - off
    return out


# Latency buckets tuned for control-plane hops (sub-ms) through exec
# (seconds) — the reference's default latency boundaries are too coarse
# at the bottom for dispatch-path phases.
_PHASE_BOUNDARIES = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class PhaseHistogram:
    """Minimal head-side histogram (the head can't use util.metrics —
    those push TO the head). Same exposition shape as user Histograms."""

    __slots__ = ("boundaries", "buckets", "sum", "count")

    def __init__(self, boundaries=_PHASE_BOUNDARIES):
        self.boundaries = list(boundaries)
        self.buckets = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if value < 0:
            value = 0.0  # residual skew after alignment: clamp, don't drop
        self.buckets[bisect.bisect_left(self.boundaries, value)] += 1
        self.sum += value
        self.count += 1

    def to_dict(self) -> dict:
        return {"boundaries": list(self.boundaries),
                "buckets": list(self.buckets),
                "sum": self.sum, "count": self.count}


def phase_latencies(phases: dict) -> dict:
    """Derive the named phase latencies from one event's stamps:
    queue_wait (head queueing, or owner-side submit->push on the direct
    plane), dispatch (wire + worker pickup), exec, and result_transfer
    (seal -> owner resolve). Missing stamps skip their metric."""
    out = {}
    submit = phases.get("submit")
    enqueue = phases.get("enqueue")
    dispatch = phases.get("dispatch")
    push = phases.get("push")
    recv = phases.get("recv")
    if enqueue is not None and dispatch is not None:
        out["queue_wait"] = dispatch - enqueue
    elif submit is not None and push is not None:
        out["queue_wait"] = push - submit
    sent = dispatch if dispatch is not None else push
    if sent is not None and recv is not None:
        out["dispatch"] = recv - sent
    if (phases.get("exec_start") is not None
            and phases.get("exec_end") is not None):
        out["exec"] = phases["exec_end"] - phases["exec_start"]
    resolve = phases.get("resolve")
    done = phases.get("seal", phases.get("exec_end"))
    if resolve is not None and done is not None:
        out["result_transfer"] = resolve - done
    return out


class EventTable:
    """Bounded head-side event store (reference: gcs_task_manager.h:159
    bounded task-event ring).

    Three event shapes share the ring, discriminated by content:
      * lifecycle events — carry "phases" + "task_id"; merged in place
        (task_started registers a partial record, task_finished
        completes it, owner_sealed adds "resolve"), indexed by task id.
      * user spans (util.tracing) and profile/oom events — appended.
      * chaos instants (faultinject) — appended, "event": "chaos".

    Deque-compatible (append/extend/iter/len) so existing callers —
    memory_monitor's oom_kill events, the task_events handlers — work
    unchanged. Thread-safe on its own lock (leaf; callers may or may
    not hold the head lock)."""

    def __init__(self, maxlen: int):
        self.maxlen = max(1, int(maxlen))
        self._events: deque = deque()
        self._by_task: dict[str, dict] = {}
        self._oid_task: dict[str, str] = {}
        self._oid_fifo: deque = deque()
        # Persistent (bounded) object -> producing-task index for the
        # object plane's lineage cross-link: _oid_task above is POPPED
        # when the owner confirms the seal (resolve attribution), but
        # `ray-tpu memory` drill-downs need "which task produced this
        # object" for the object's whole life.
        self._oid_producer: dict[str, str] = {}
        self._oid_producer_fifo: deque = deque()
        # Owner confirmations that arrived BEFORE the worker's report
        # registered the oid (direct tasks report to the head over a
        # socket; a local-mode owner confirms in-process and can win
        # that race) — parked here so register_oids claims the stamp.
        self._pending_resolve: dict[str, float] = {}
        self._pending_resolve_fifo: deque = deque()
        self._lock = threading.Lock()
        self.phase_hists: dict[str, PhaseHistogram] = {}

    # -- deque-compatible surface --------------------------------------

    def append(self, event: dict) -> None:
        self.extend((event,))

    def extend(self, events) -> None:
        with self._lock:
            for ev in events:
                if isinstance(ev, dict) and "phases" in ev \
                        and ev.get("task_id"):
                    self._merge_locked(ev)
                else:
                    self._append_locked(ev)

    def __iter__(self):
        with self._lock:
            return iter(list(self._events))

    def __len__(self) -> int:
        return len(self._events)

    # -- lifecycle merging ---------------------------------------------

    def merge(self, event: dict) -> None:
        """Merge one lifecycle event (must carry task_id + phases)."""
        with self._lock:
            self._merge_locked(event)

    def _merge_locked(self, event: dict) -> None:
        cur = self._by_task.get(event["task_id"])
        if cur is None:
            self._by_task[event["task_id"]] = event
            self._append_locked(event)
            cur = event
        else:
            phases = cur.setdefault("phases", {})
            for k, v in (event.get("phases") or {}).items():
                phases.setdefault(k, v)
            for k, v in event.items():
                if k != "phases" and v is not None:
                    cur.setdefault(k, v)
                    if k in ("start", "end", "failed", "worker_id",
                             "node_id", "pid"):
                        cur[k] = v  # completion fields: latest wins
        # Execution completed: fold this task's derived latencies into
        # the phase histograms exactly once (exec_end is stamped by the
        # one task_finished that carries the full worker-side record).
        if "exec_end" in (event.get("phases") or {}):
            self._observe_locked(cur)

    def _observe_locked(self, event: dict) -> None:
        for name, dt in phase_latencies(event.get("phases") or {}).items():
            h = self.phase_hists.get(name)
            if h is None:
                h = self.phase_hists[name] = PhaseHistogram()
            h.observe(dt)

    def _append_locked(self, event) -> None:
        self._events.append(event)
        while len(self._events) > self.maxlen:
            old = self._events.popleft()
            if isinstance(old, dict) and old.get("task_id"):
                if self._by_task.get(old["task_id"]) is old:
                    del self._by_task[old["task_id"]]

    # -- resolve attribution -------------------------------------------

    def register_oids(self, task_id: str, oids) -> None:
        """Remember which return ids belong to which task so the owner's
        seal confirmation (owner_sealed) can stamp the resolve phase."""
        with self._lock:
            for oid in oids or ():
                if oid not in self._oid_task:
                    self._oid_task[oid] = task_id
                    self._oid_fifo.append(oid)
                if oid not in self._oid_producer:
                    self._oid_producer[oid] = task_id
                    self._oid_producer_fifo.append(oid)
                ts = self._pending_resolve.pop(oid, None)
                if ts is not None:
                    self._oid_task.pop(oid, None)
                    self._resolve_locked(task_id, ts)
            while len(self._oid_fifo) > self.maxlen:
                self._oid_task.pop(self._oid_fifo.popleft(), None)
            while len(self._oid_producer_fifo) > self.maxlen:
                self._oid_producer.pop(
                    self._oid_producer_fifo.popleft(), None)

    def producer_task(self, oid: str) -> "str | None":
        """The task id whose return this object is, if still indexed
        (bounded FIFO — floods evict oldest first)."""
        with self._lock:
            return self._oid_producer.get(oid)

    def task_record(self, task_id: str) -> "dict | None":
        """A copy of one task's merged lifecycle event (phases, worker,
        node, name) — the flight-recorder half of an object drill-down."""
        with self._lock:
            ev = self._by_task.get(task_id)
            if ev is None:
                return None
            out = dict(ev)
            out["phases"] = dict(ev.get("phases") or {})
            return out

    def resolve(self, oids, ts: float) -> None:
        """The owner confirmed holding these results: stamp the resolve
        phase (first confirmation wins) and fold result-transfer latency
        into the histograms. Creates a placeholder record when the
        confirmation beats the worker's task_finished."""
        with self._lock:
            for oid in oids or ():
                task_id = self._oid_task.pop(oid, None)
                if task_id is None:
                    self._pending_resolve[oid] = ts
                    self._pending_resolve_fifo.append(oid)
                    while len(self._pending_resolve_fifo) > self.maxlen:
                        self._pending_resolve.pop(
                            self._pending_resolve_fifo.popleft(), None)
                    continue
                self._resolve_locked(task_id, ts)

    def _resolve_locked(self, task_id: str, ts: float) -> None:
        ev = self._by_task.get(task_id)
        if ev is None:
            ev = {"task_id": task_id, "phases": {}}
            self._by_task[task_id] = ev
            self._append_locked(ev)
        phases = ev.setdefault("phases", {})
        if "resolve" not in phases:
            phases["resolve"] = ts
            done = phases.get("seal", phases.get("exec_end"))
            if done is not None:
                h = self.phase_hists.get("result_transfer")
                if h is None:
                    h = self.phase_hists["result_transfer"] = \
                        PhaseHistogram()
                h.observe(ts - done)

    # -- snapshots -------------------------------------------------------

    def by_worker(self, worker_id: str, limit: int = 5,
                  scan_cap: int = 2000) -> list:
        """The last few lifecycle events of ONE worker — the crash
        plane's flight-recorder cross-link: what the dead worker's
        timeline looked like right up to the death. Scans from the
        newest end and gives up after ``scan_cap`` entries: this runs
        on the death path, which must never walk a 100k-event ring
        under the table lock."""
        out: list = []
        with self._lock:
            scanned = 0
            for e in reversed(self._events):
                scanned += 1
                if scanned > scan_cap or len(out) >= limit:
                    break
                if isinstance(e, dict) and "phases" in e \
                        and e.get("worker_id") == worker_id:
                    ev = dict(e)
                    ev["phases"] = dict(e.get("phases") or {})
                    out.append(ev)
        out.reverse()
        return out

    def snapshot(self, limit: int = 10000, task_ids=None) -> list:
        with self._lock:
            events = list(self._events)
        if task_ids is not None:
            wanted = set(task_ids)
            events = [e for e in events
                      if isinstance(e, dict) and e.get("task_id") in wanted]
        return events[-limit:]

    def hist_snapshot(self) -> dict:
        with self._lock:
            return {name: h.to_dict()
                    for name, h in self.phase_hists.items()}


def now() -> float:
    """Single stamping clock (wall time: cross-process comparability;
    monotonicity across hosts is restored by align_phases)."""
    return time.time()
