"""Request-scoped distributed tracing: causal trace trees.

Counterpart of the reference's task-events + OpenTelemetry context
propagation (reference: python/ray/util/tracing/tracing_helper.py —
trace context injected into task metadata and re-extracted in the
worker; dashboard/modules/job's per-request ids). Here the context is
three values — ``(trace_id, parent_span_id, sampled)`` — minted at the
serve proxy (``X-Request-Id`` in, ``X-Trace-Id`` echoed out) or by a
``tracing.span``, carried on every ``TaskSpec`` as an optional trailing
field of the compiled encoding, and inherited by nested ``.remote()``
calls via the ambient contextvar in ``worker_context``. A task's own
span id IS its task id, so lifecycle events (which already ride the
``task_finished`` cast) become trace spans for free; user/proxy/serve
spans buffer here and flush on the amortized ``rpc_report`` cast —
zero new per-call head frames on any path.

Two halves:

* **owner/worker half** — id minting, the bounded span buffer with a
  dropped counter (a ``span()`` in a hot loop must not flood the head),
  drained by ``CoreRuntime.report_rpc_now``.

* **head half** — ``TraceTable``: a bounded table of causal trees with
  tail-based retention. Slow / error / shed traces and a uniform 1-in-N
  sample keep full span detail; everything else folds into counts when
  the table overflows. Read by ``util.state.get_trace/list_traces``,
  the ``ray-tpu trace`` CLI, and the dashboard ``/api/traces`` view.
"""

from __future__ import annotations

import random
import re
import threading
import time
import uuid
from collections import OrderedDict, deque

from ray_tpu_torch._private.config import GLOBAL_CONFIG

# ---------------------------------------------------------------- ids


def new_trace_id() -> str:
    return uuid.uuid4().hex

def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


_REQ_ID_OK = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")


def mint_trace(request_id: "str | None" = None) -> "tuple | None":
    """Proxy-side mint: adopt a well-formed inbound ``X-Request-Id`` as
    the trace id (so callers correlate their own ids end to end), else
    generate one. Returns ``(trace_id, root_span_id, sampled)`` or None
    when the trace plane is disabled."""
    if not GLOBAL_CONFIG.trace_enabled:
        return None
    if request_id and _REQ_ID_OK.match(request_id):
        tid = request_id
    else:
        tid = new_trace_id()
    rate = GLOBAL_CONFIG.trace_sample_rate
    sampled = 1 if rate >= 1.0 or random.random() < rate else 0
    return (tid, new_span_id(), sampled)


# ------------------------------------------------- owner-side buffer
#
# util.tracing spans (and proxy/serve spans) land here and ride the
# next amortized rpc_report cast — never a per-span frame.

_buf_lock = threading.Lock()
_span_buf: deque = deque()
_spans_dropped = 0
_oldest_ts = 0.0


def buffer_span(span: dict) -> None:
    global _spans_dropped, _oldest_ts
    with _buf_lock:
        if len(_span_buf) >= GLOBAL_CONFIG.trace_span_buffer_max:
            _spans_dropped += 1
            return
        if not _span_buf:
            _oldest_ts = time.time()
        _span_buf.append(span)


def drain_spans() -> "tuple[list, int]":
    """Take everything buffered (spans, dropped-since-last-drain)."""
    global _spans_dropped
    with _buf_lock:
        spans = list(_span_buf)
        _span_buf.clear()
        dropped, _spans_dropped = _spans_dropped, 0
    return spans, dropped


def pending_spans_age() -> float:
    """Seconds the oldest buffered span has waited (0 when empty) —
    lets the release loop flush a report early instead of holding a
    finished request's spans for a full report interval."""
    with _buf_lock:
        if not _span_buf:
            return 0.0
        return time.time() - _oldest_ts


# ------------------------------------------------------ head table


class _Trace:
    __slots__ = ("trace_id", "spans", "first_start", "last_end",
                 "error", "shed", "slow", "uniform_keep",
                 "spans_dropped", "root_name", "status")

    def __init__(self, trace_id: str, uniform_keep: bool):
        self.trace_id = trace_id
        self.spans: list[dict] = []
        self.first_start = 0.0
        self.last_end = 0.0
        self.error = False
        self.shed = False
        self.slow = False
        self.uniform_keep = uniform_keep
        self.spans_dropped = 0
        self.root_name = ""
        self.status = None  # HTTP status stamped by the proxy span

    @property
    def exemplar(self) -> bool:
        return self.error or self.shed or self.slow

    def summary(self) -> dict:
        row = {
            "trace_id": self.trace_id,
            "spans": len(self.spans),
            "start": self.first_start,
            "duration_s": max(0.0, self.last_end - self.first_start),
            "error": self.error,
            "shed": self.shed,
            "slow": self.slow,
            "root": self.root_name,
        }
        if self.status is not None:
            row["status"] = self.status
        if self.spans_dropped:
            row["spans_dropped"] = self.spans_dropped
        return row


class TraceTable:
    """Bounded causal-trace store with tail-based retention."""

    def __init__(self, config=None):
        self.config = config or GLOBAL_CONFIG
        self._traces: "OrderedDict[str, _Trace]" = OrderedDict()
        self._lock = threading.Lock()
        self._seq = 0
        self.folded = {"count": 0, "errors": 0, "shed": 0, "slow": 0,
                       "spans": 0}
        self.spans_dropped_reported = 0  # owner-side drops, via reports

    # -- intake --------------------------------------------------------

    def intake(self, events: "list | None") -> None:
        """Feed control-plane events (task lifecycle events riding
        task_finished, user/proxy/serve span records riding
        rpc_report/task_events): anything carrying a trace_id becomes a
        span in its trace; everything else is ignored."""
        if not events:
            return
        for ev in events:
            if isinstance(ev, dict) and ev.get("trace_id"):
                self.add_span(ev)

    def add_span(self, ev: dict) -> None:
        span = {
            "span_id": ev.get("span_id") or new_span_id(),
            "parent_span_id": ev.get("parent_span_id") or "",
            "name": ev.get("name") or "span",
            "kind": ev.get("kind")
                    or ("task" if ev.get("phases") is not None
                        else "span"),
            "start": float(ev.get("start") or 0.0),
            "end": float(ev.get("end") or 0.0),
            "failed": bool(ev.get("failed")),
        }
        for k in ("task_id", "worker_id", "actor_id", "node_id", "pid",
                  "phases", "attributes", "status"):
            if ev.get(k) is not None:
                span[k] = ev[k]
        with self._lock:
            tr = self._traces.get(ev["trace_id"])
            if tr is None:
                self._seq += 1
                nth = self.config.trace_uniform_keep_nth
                tr = _Trace(ev["trace_id"],
                            uniform_keep=(nth > 0
                                          and self._seq % nth == 0))
                self._traces[ev["trace_id"]] = tr
            if len(tr.spans) >= self.config.trace_max_spans:
                tr.spans_dropped += 1
            else:
                tr.spans.append(span)
            self._absorb(tr, span)
            if len(self._traces) > self.config.trace_table_max:
                self._fold_one()

    def _absorb(self, tr: _Trace, span: dict) -> None:
        if not tr.first_start or (span["start"]
                                  and span["start"] < tr.first_start):
            tr.first_start = span["start"]
        tr.last_end = max(tr.last_end, span["end"])
        if span["failed"]:
            tr.error = True
        attrs = span.get("attributes") or {}
        status = span.get("status") or attrs.get("status")
        if status is not None:
            try:
                tr.status = int(status)
                if tr.status in (503, 408):
                    tr.shed = True
            except (TypeError, ValueError):
                pass
        if attrs.get("shed") or "TaskTimeoutError" in str(
                attrs.get("error", "")):
            tr.shed = True
        if not span["parent_span_id"]:
            tr.root_name = span["name"]
            dur = span["end"] - span["start"]
            if dur > self.config.trace_slow_threshold_s:
                tr.slow = True

    def _fold_one(self) -> None:
        """lock held. Tail-based retention: fold the oldest trace that
        is neither an exemplar nor a uniform-sample keeper into the
        aggregate counters; fall back to uniform keepers, then (bounded
        table above all) to exemplars."""
        victim = None
        for tier in (lambda t: not t.exemplar and not t.uniform_keep,
                     lambda t: not t.exemplar,
                     lambda t: True):
            for tid, tr in self._traces.items():
                if tier(tr):
                    victim = tid
                    break
            if victim is not None:
                break
        tr = self._traces.pop(victim)
        self.folded["count"] += 1
        self.folded["spans"] += len(tr.spans)
        if tr.error:
            self.folded["errors"] += 1
        if tr.shed:
            self.folded["shed"] += 1
        if tr.slow:
            self.folded["slow"] += 1

    def note_dropped(self, n: int) -> None:
        """Owner-side span-buffer drops piggybacked on rpc_report."""
        if n:
            with self._lock:
                self.spans_dropped_reported += n

    # -- reads ---------------------------------------------------------

    def get(self, trace_id: str) -> "dict | None":
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return None
            out = tr.summary()
            out["spans_detail"] = [dict(s) for s in tr.spans]
            return out

    def list(self, limit: int = 100, exemplars_only: bool = False
             ) -> list:
        with self._lock:
            rows = [tr.summary() for tr in self._traces.values()
                    if tr.exemplar or not exemplars_only]
        rows.sort(key=lambda r: r["start"], reverse=True)
        return rows[:max(1, int(limit))]

    def exemplar_for(self, *, shed: bool = False, slow: bool = False,
                     error: bool = False) -> "str | None":
        """Most recent exemplar trace id matching a flag — annotates
        the serve p99/shed gauges with a concrete drill-down handle."""
        with self._lock:
            for tr in reversed(self._traces.values()):
                if ((shed and tr.shed) or (slow and tr.slow)
                        or (error and tr.error)):
                    return tr.trace_id
        return None

    def stats(self) -> dict:
        with self._lock:
            ex = sum(1 for t in self._traces.values() if t.exemplar)
            ids = {}
            for kind in ("slow", "shed", "error"):
                for tr in reversed(self._traces.values()):
                    if getattr(tr, kind):
                        ids[kind] = tr.trace_id
                        break
            return {
                "retained": len(self._traces),
                "exemplars": ex,
                "uniform_kept": sum(1 for t in self._traces.values()
                                    if t.uniform_keep and not t.exemplar),
                "folded": dict(self.folded),
                "spans_dropped_owner_side": self.spans_dropped_reported,
                # Most recent exemplar per flag: the metric exposition
                # annotates the serve p99/shed series with these, so a
                # gauge spike comes with a drill-down trace id.
                "exemplar_ids": ids,
            }
