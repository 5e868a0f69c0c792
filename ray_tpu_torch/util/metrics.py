"""User-defined metrics: Counter / Gauge / Histogram.

Counterpart of the reference's ray.util.metrics (util/metrics.py —
Counter :163, Gauge :216, Histogram :294, exported via the per-node
Prometheus agent). Here metrics are pushed to the head's metric table
keyed by (name, reporter, tags) and aggregated on read; `get_metrics_report`
/ `prometheus_text` are the scrape surface."""

from __future__ import annotations

import bisect
import os
import threading
import time
import uuid
from typing import Any, Optional, Sequence

from ray_tpu_torch._private.worker_context import global_runtime

_FLUSH_INTERVAL_S = 1.0


class _MetricBase:
    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] | None = None):
        if not name:
            raise ValueError("metric name must be non-empty")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: dict[str, str] = {}
        self._values: dict[tuple, Any] = {}
        self._lock = threading.Lock()
        self._last_flush = 0.0
        # Per-instance series id: a re-created metric object (reused
        # worker, new task) contributes a NEW series instead of
        # overwriting the previous instance's accumulated value.
        self._instance_id = uuid.uuid4().hex[:8]

    def set_default_tags(self, tags: dict[str, str]) -> "_MetricBase":
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[dict]) -> tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"undeclared tag keys {sorted(extra)} for {self.name}")
        return tuple((k, merged.get(k, "")) for k in self.tag_keys)

    def _flush(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_flush < _FLUSH_INTERVAL_S:
            return
        self._last_flush = now
        try:
            rt = global_runtime()
        except Exception:
            return  # not connected; metrics are best-effort
        with self._lock:
            payload = {}
            for tags, value in self._values.items():
                if isinstance(value, dict):
                    # Snapshot mutable state (histograms) under the lock —
                    # conn.cast serializes after release and must not race
                    # concurrent observe() mutations.
                    value = {
                        k: (list(v) if isinstance(v, list) else v)
                        for k, v in value.items()
                    }
                key = f"{self.name}|{rt.client_id}|{self._instance_id}|{dict(tags)}"
                payload[key] = {
                    "name": self.name,
                    "type": self.TYPE,
                    "description": self.description,
                    "tags": dict(tags),
                    "value": value,
                    "reporter": f"{rt.client_id}/{self._instance_id}",
                    "ts": time.time(),
                }
        try:
            rt.conn.cast("report_metrics", {"metrics": payload})
        except Exception:
            pass


class Counter(_MetricBase):
    """Monotonic counter (reference: util/metrics.py:163)."""

    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() requires value >= 0")
        key = self._tag_tuple(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value
        self._flush()


class Gauge(_MetricBase):
    """Point-in-time value (reference: util/metrics.py:216)."""

    TYPE = "gauge"

    def set(self, value: float, tags: dict | None = None) -> None:
        with self._lock:
            self._values[self._tag_tuple(tags)] = float(value)
        self._flush()


class Histogram(_MetricBase):
    """Bucketed observations (reference: util/metrics.py:294)."""

    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] | None = None,
                 tag_keys: Sequence[str] | None = None):
        super().__init__(name, description, tag_keys)
        if not boundaries:
            boundaries = [0.001, 0.01, 0.1, 1.0, 10.0, 100.0]
        self.boundaries = sorted(float(b) for b in boundaries)

    def observe(self, value: float, tags: dict | None = None) -> None:
        key = self._tag_tuple(tags)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = {
                    "buckets": [0] * (len(self.boundaries) + 1),
                    "sum": 0.0,
                    "count": 0,
                    "boundaries": self.boundaries,
                }
                self._values[key] = state
            idx = bisect.bisect_left(self.boundaries, value)
            state["buckets"][idx] += 1
            state["sum"] += value
            state["count"] += 1
        self._flush()


def flush_all_of(*metrics: _MetricBase) -> None:
    for m in metrics:
        m._flush(force=True)


def get_metrics_report() -> dict[str, dict]:
    """All reported metric points, aggregated across reporters: counters
    and histograms sum; gauges keep the latest per reporter-tagset."""
    raw = global_runtime().conn.call("get_metrics", {})["metrics"]
    agg: dict[str, dict] = {}
    for point in raw.values():
        name = point["name"]
        tags = tuple(sorted(point["tags"].items()))
        entry = agg.setdefault(name, {"type": point["type"], "series": {}})
        series = entry["series"]
        if point["type"] == "counter":
            series[tags] = series.get(tags, 0.0) + point["value"]
        elif point["type"] == "histogram":
            cur = series.get(tags)
            if cur is None:
                series[tags] = {k: (list(v) if isinstance(v, list) else v)
                                for k, v in point["value"].items()}
            else:
                cur["sum"] += point["value"]["sum"]
                cur["count"] += point["value"]["count"]
                cur["buckets"] = [a + b for a, b in zip(cur["buckets"], point["value"]["buckets"])]
        else:  # gauge: one series per (reporter, tags); latest write wins
            series[(("__reporter__", point["reporter"]),) + tags] = point["value"]
    return agg


def _timestamp_suffix(now_ms: "int | None" = None) -> str:
    """Optional millisecond sample timestamps on gauge lines
    (exposition-format spec: ``name{labels} value [timestamp_ms]``),
    OFF by default — turned on via RAY_TPU_METRICS_TIMESTAMPS so
    scrape-time vs sample-time skew becomes visible. Counters stay
    bare: their value IS cumulative, the scrape time is the honest
    sample time."""
    if os.environ.get("RAY_TPU_METRICS_TIMESTAMPS", "0").lower() \
            not in ("1", "true", "yes", "on"):
        return ""
    return f" {now_ms if now_ms is not None else int(time.time() * 1000)}"


def _escape_label_value(value) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote, and newline must be escaped or the sample line is invalid
    (and silently corrupts every later line of the scrape)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def runtime_stats_text() -> str:
    """Core runtime metric exposition (reference: the C++ DEFINE_stats
    set — tasks/actors/objects — exported through the metrics agent),
    plus the flight-recorder phase-latency histograms (queue wait /
    dispatch / exec / result transfer)."""
    try:
        snap = global_runtime().conn.call("runtime_stats", {}, timeout=10)
    except Exception:
        return ""
    lines = []
    ts_suffix = _timestamp_suffix()
    for name, value in snap.get("counters", {}).items():
        full = f"ray_tpu_{name}_total"
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full} {value}")
    for name, value in snap.get("gauges", {}).items():
        full = f"ray_tpu_{name}"
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {value}{ts_suffix}")
    for name, h in snap.get("histograms", {}).items():
        full = f"ray_tpu_phase_{name}_seconds"
        lines.append(f"# TYPE {full} histogram")
        for b, c in zip(list(h["boundaries"]) + [float("inf")],
                        _cumulative(h["buckets"])):
            lines.append(f'{full}_bucket{{le="{b}"}} {c}')
        lines.append(f"{full}_sum {h['sum']}")
        lines.append(f"{full}_count {h['count']}")
    # Crash-forensics plane: classified worker deaths by reason
    # (reference analogue: the worker-death metrics keyed by
    # WorkerExitType in the GCS).
    deaths = snap.get("worker_deaths") or {}
    if deaths:
        lines.append("# TYPE ray_tpu_worker_deaths_total counter")
        for reason in sorted(deaths):
            lines.append(
                f'ray_tpu_worker_deaths_total'
                f'{{reason="{_escape_label_value(reason)}"}} '
                f"{deaths[reason]}")
    # Overload-protection plane: deadline sheds by queue hop. The
    # admission counter rides the generic counters block above
    # (ray_tpu_admission_rejected_total) and the pressure gauge the
    # gauges block (ray_tpu_mem_pressured_nodes).
    tracing = snap.get("tracing") or {}
    exemplar_ids = tracing.get("exemplar_ids") or {}
    shed = snap.get("tasks_shed") or {}
    if shed:
        # OpenMetrics-style exemplar suffix: a shed spike comes with a
        # retained trace id to drill into (`ray-tpu trace <id>`).
        ex = (f' # {{trace_id="{exemplar_ids["shed"]}"}} 1'
              if exemplar_ids.get("shed") else "")
        lines.append("# TYPE ray_tpu_tasks_shed_total counter")
        for where in sorted(shed):
            lines.append(
                f'ray_tpu_tasks_shed_total'
                f'{{where="{_escape_label_value(where)}"}} '
                f'{shed[where]}{ex}')
    # Request-tracing plane: retention/fold/drop gauges, plus one info
    # series per exemplar kind so the serve p99 dashboards can link
    # "slow right now" to a concrete retained trace.
    if tracing:
        for key, metric in (("retained", "ray_tpu_traces_retained"),
                            ("exemplars", "ray_tpu_traces_exemplars")):
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {tracing.get(key, 0)}")
        folded = tracing.get("folded") or {}
        lines.append("# TYPE ray_tpu_traces_folded_total counter")
        lines.append(f"ray_tpu_traces_folded_total {folded.get('count', 0)}")
        lines.append("# TYPE ray_tpu_trace_spans_dropped_total counter")
        lines.append(f"ray_tpu_trace_spans_dropped_total "
                     f"{tracing.get('spans_dropped_owner_side', 0)}")
        if exemplar_ids:
            lines.append("# TYPE ray_tpu_trace_exemplar_info gauge")
            for kind in sorted(exemplar_ids):
                lines.append(
                    f'ray_tpu_trace_exemplar_info'
                    f'{{kind="{_escape_label_value(kind)}",'
                    f'trace_id="{_escape_label_value(exemplar_ids[kind])}"'
                    f'}} 1')
    # Unified retry plane: open circuit breakers in the head process
    # (per-client breakers ride the rpc clients snapshots).
    breakers = snap.get("breakers") or {}
    if breakers:
        lines.append("# TYPE ray_tpu_rpc_breaker_open gauge")
        for target in sorted(breakers):
            lines.append(
                f'ray_tpu_rpc_breaker_open'
                f'{{target="{_escape_label_value(target)}"}} '
                f"{1 if breakers[target].get('open') else 0}")
    # Object-plane observability: store bytes by node/state, live refs
    # by census kind, top callsites by live bytes, and the leak
    # detector's suspect count.
    objects = snap.get("objects") or {}
    by_node_state = objects.get("by_node_state") or {}
    if by_node_state:
        lines.append("# TYPE ray_tpu_object_store_bytes gauge")
        for node in sorted(by_node_state):
            for state in sorted(by_node_state[node]):
                lines.append(
                    f'ray_tpu_object_store_bytes'
                    f'{{node="{_escape_label_value(node)}",'
                    f'state="{_escape_label_value(state)}"}} '
                    f"{by_node_state[node][state]}")
    live_by_kind = objects.get("live_by_kind") or {}
    if live_by_kind:
        lines.append("# TYPE ray_tpu_objects_live gauge")
        for kind in sorted(live_by_kind):
            lines.append(
                f'ray_tpu_objects_live'
                f'{{kind="{_escape_label_value(kind)}"}} '
                f"{live_by_kind[kind]}")
    top_cs = objects.get("top_callsite_bytes") or {}
    if top_cs:
        lines.append("# TYPE ray_tpu_object_callsite_bytes gauge")
        for site in sorted(top_cs):
            lines.append(
                f'ray_tpu_object_callsite_bytes'
                f'{{callsite="{_escape_label_value(site)}"}} '
                f"{top_cs[site]}")
    if "leak_suspects" in objects:
        lines.append("# TYPE ray_tpu_object_leak_suspects gauge")
        lines.append(
            f"ray_tpu_object_leak_suspects {objects['leak_suspects']}")
    # Zero-copy data plane: payload bytes moved by transfer path
    # (p2p primary pulls, relay pulls, host-local arena reads,
    # zero-copy aliasing views, inline control-plane payloads, spill
    # restores) and the host-side copy census behind the one-copy
    # structural guard.
    transfers = snap.get("transfers") or {}
    xfer_bytes = transfers.get("bytes") or {}
    if xfer_bytes:
        lines.append("# TYPE ray_tpu_object_bytes_transferred_total"
                     " counter")
        for path in sorted(xfer_bytes):
            lines.append(
                f'ray_tpu_object_bytes_transferred_total'
                f'{{path="{_escape_label_value(path)}"}} '
                f"{xfer_bytes[path]}")
    xfer_copies = transfers.get("host_copies") or {}
    if xfer_copies:
        lines.append("# TYPE ray_tpu_object_host_copies_total counter")
        for path in sorted(xfer_copies):
            lines.append(
                f'ray_tpu_object_host_copies_total'
                f'{{path="{_escape_label_value(path)}"}} '
                f"{xfer_copies[path]}")
    # Continuous profiling plane: cluster profile table occupancy and
    # churn, plus per-(role, frame) self-time hits — the top-N leaf
    # frames per role, bounded by the head's top-N fold so the frame
    # label cardinality stays fixed regardless of code shape.
    profiling = snap.get("profiling") or {}
    if profiling:
        lines.append("# TYPE ray_tpu_profile_windows gauge")
        lines.append(f"ray_tpu_profile_windows "
                     f"{profiling.get('windows', 0)}")
        lines.append("# TYPE ray_tpu_profile_pinned_windows gauge")
        lines.append(f"ray_tpu_profile_pinned_windows "
                     f"{profiling.get('pinned', 0)}")
        for key, metric in (
                ("windows_total", "ray_tpu_profile_windows_total"),
                ("dropped_windows",
                 "ray_tpu_profile_windows_dropped_total"),
                ("samples_total", "ray_tpu_profile_samples_total"),
                ("gil_exemplars",
                 "ray_tpu_profile_gil_exemplars_total")):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {profiling.get(key, 0)}")
        self_time = profiling.get("self_time") or {}
        if self_time:
            lines.append("# TYPE ray_tpu_profile_self_hits gauge")
            for role in sorted(self_time):
                for frame in sorted(self_time[role]):
                    lines.append(
                        f'ray_tpu_profile_self_hits'
                        f'{{role="{_escape_label_value(role)}",'
                        f'frame="{_escape_label_value(frame)}"}} '
                        f"{self_time[role][frame]}")
    # Telemetry history + SLO alerting plane self-metrics: store
    # occupancy (series/points), the (other series) fold counter, and
    # the firing-alert gauge by severity — the plane watching the
    # cluster must itself be watchable, or a melted store goes
    # unnoticed until an alert silently fails to fire.
    telemetry = snap.get("telemetry") or {}
    if telemetry:
        lines.append("# TYPE ray_tpu_tsdb_series gauge")
        lines.append(f"ray_tpu_tsdb_series "
                     f"{telemetry.get('series', 0)}{ts_suffix}")
        lines.append("# TYPE ray_tpu_tsdb_points gauge")
        lines.append(f"ray_tpu_tsdb_points "
                     f"{telemetry.get('points', 0)}{ts_suffix}")
        lines.append("# TYPE ray_tpu_tsdb_dropped_total counter")
        lines.append(f"ray_tpu_tsdb_dropped_total "
                     f"{telemetry.get('dropped_total', 0)}")
    alerts = snap.get("alerts") or {}
    if alerts:
        from ray_tpu_torch._private.alertplane import SEVERITIES

        by_sev = alerts.get("firing_by_severity") or {}
        lines.append("# TYPE ray_tpu_alerts_firing gauge")
        for sev in SEVERITIES:
            lines.append(
                f'ray_tpu_alerts_firing'
                f'{{severity="{_escape_label_value(sev)}"}} '
                f"{by_sev.get(sev, 0)}{ts_suffix}")
        for key, metric in (
                ("fired_total", "ray_tpu_alerts_fired_total"),
                ("resolved_total", "ray_tpu_alerts_resolved_total")):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {alerts.get(key, 0)}")
    # Cluster-wide head frame census (the zero-per-call-head-frames
    # property, scrapeable): total frames every reporting process has
    # sent the head.
    rpc = snap.get("rpc") or {}
    if rpc.get("total_head_frames") is not None:
        lines.append("# TYPE ray_tpu_rpc_head_frames_total counter")
        lines.append(
            f"ray_tpu_rpc_head_frames_total {rpc['total_head_frames']}")
    return "\n".join(lines) + ("\n" if lines else "")


def prometheus_text() -> str:
    """Prometheus exposition format (the per-node MetricsAgent surface,
    reference: _private/metrics_agent.py:492). Core runtime metrics
    first, then user-defined Counter/Gauge/Histogram series."""
    lines = [runtime_stats_text().rstrip("\n")]
    lines = [ln for ln in lines if ln]
    ts_suffix = _timestamp_suffix()
    for name, entry in get_metrics_report().items():
        lines.append(f"# TYPE {name} {entry['type']}")
        for tags, value in entry["series"].items():
            # "__reporter__" (gauge per-reporter series) renders as a
            # reporter label so duplicate-named samples stay distinct.
            pairs = [("reporter", v) if k == "__reporter__" else (k, v)
                     for k, v in tags]
            label_body = ",".join(
                f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
            label = "{" + label_body + "}" if label_body else ""
            if entry["type"] == "histogram":
                for b, c in zip(value["boundaries"] + [float("inf")],
                                _cumulative(value["buckets"])):
                    le = f'le="{b}"'
                    bucket_label = "{" + (label_body + "," if label_body else "") + le + "}"
                    lines.append(f"{name}_bucket{bucket_label} {c}")
                lines.append(f"{name}_sum{label} {value['sum']}")
                lines.append(f"{name}_count{label} {value['count']}")
            else:
                suffix = ts_suffix if entry["type"] == "gauge" else ""
                lines.append(f"{name}{label} {value}{suffix}")
    return "\n".join(lines) + "\n"


def _cumulative(buckets: list[int]) -> list[int]:
    out, total = [], 0
    for b in buckets:
        total += b
        out.append(total)
    return out


def rpc_counters() -> dict:
    """Dispatch-plane RPC counters for THIS process (cheap ints kept on
    every rpc.Connection): per-kind message census and frame counts for
    the head connection and every peer (direct-call) connection, plus
    the direct plane's own dispatch counters. The frame-count
    regression guard (tests/test_dispatch_fastpath.py) is built on
    these — steady-state direct dispatch must add ZERO per-call frames
    on the head connection."""
    rt = global_runtime()

    def _conn(c) -> dict:
        sync = getattr(c, "_sync_native_counters", None)
        if sync is not None:
            sync()  # fold native-lane flusher frames before reading
        return {"frames_sent": c.frames_sent, "calls_sent": c.calls_sent,
                "sent_kinds": dict(c.sent_kinds)}

    with rt._owner_conns_lock:
        peers = {f"{a[0]}:{a[1]}": _conn(c)
                 for a, c in rt._owner_conns.items()}
    direct = rt._direct.snapshot() if rt._direct is not None else {}
    return {"head": _conn(rt.conn), "peers": peers, "direct": direct}


def cluster_rpc_counters() -> dict:
    """CLUSTER-wide rpc counters: every runtime's snapshot as last
    reported to the head (workers/drivers piggyback on the amortized
    rpc_report cast, node agents on their heartbeats). The whole-cluster
    complement of rpc_counters() — lets the zero-head-frames property of
    the direct plane be checked for every process, not just this one.
    Shape: {"clients": {client_id: snapshot}, "total_head_frames": int,
    "clock_offsets": {node_id: seconds}}."""
    snap = global_runtime().conn.call("runtime_stats", {}, timeout=10)
    return snap.get("rpc") or {"clients": {}, "total_head_frames": 0}
