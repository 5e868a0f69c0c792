"""State API: cluster introspection (port of ray_tpu/util/state.py: host
code over the port's head).

Counterpart of the reference's ray.util.state (util/state/api.py —
list_actors :784, list_tasks :1011, summarize_tasks :1368), backed by the
head's task/actor/object/worker tables instead of GCS task events."""

from __future__ import annotations

import time
from collections import Counter

from ray_tpu_torch._private.worker_context import global_runtime


def _call(method: str, body: dict | None = None) -> dict:
    return global_runtime().conn.call(method, body or {})


def _filtered(rows: list[dict], filters) -> list[dict]:
    """filters: list of (key, predicate '=' or '!=', value) tuples."""
    if not filters:
        return rows
    out = []
    for r in rows:
        ok = True
        for key, op, value in filters:
            have = r.get(key)
            if op == "=":
                ok = ok and str(have) == str(value)
            elif op == "!=":
                ok = ok and str(have) != str(value)
            else:
                raise ValueError(f"unsupported filter op {op!r}")
        if ok:
            out.append(r)
    return out


def list_tasks(*, filters=None, limit: int = 1000) -> list[dict]:
    # A state equality filter is pushed down to the head (hot path for
    # autoscaler/dashboard polls); remaining filters apply client-side
    # over the full table window so matches outside the last `limit`
    # rows aren't silently missed.
    filters = list(filters or [])
    body: dict = {}
    for f in list(filters):
        # Equality filters on indexed/point keys push down to the head
        # (hot path for autoscaler/dashboard polls and drill-downs).
        if f[1] == "=" and f[0] in ("state", "task_id", "worker_id"):
            body[f[0]] = f[2]
            filters.remove(f)
    # Only filters that remain CLIENT-side force a full-table fetch.
    body["limit"] = limit if not filters else 1_000_000
    rows = _call("list_tasks", body)["tasks"]
    return _filtered([dict(r) for r in rows], filters)[:limit]


def list_actors(*, filters=None, limit: int = 1000) -> list[dict]:
    # An actor_id equality filter is a point lookup — pushed down to the
    # head (mirrors the task_id pushdown in list_tasks) so drill-downs
    # never ship the whole actor table.
    filters = list(filters or [])
    body: dict = {}
    for f in list(filters):
        if f[1] == "=" and f[0] == "actor_id":
            body["actor_id"] = f[2]
            filters.remove(f)
    rows = _call("list_actors", body)["actors"]
    return _filtered(rows, filters)[:limit]


def list_objects(*, filters=None, limit: int = 1000) -> list[dict]:
    # An object_id equality filter is a point lookup — pushed down to
    # the head (mirrors the task_id/actor_id pushdowns above) so
    # drill-downs never transfer the whole object table.
    filters = list(filters or [])
    body: dict = {}
    for f in list(filters):
        if f[1] == "=" and f[0] == "object_id":
            body["object_id"] = f[2]
            filters.remove(f)
    body["limit"] = limit if not filters else 1_000_000
    rows = _call("list_objects", body)["objects"]
    return _filtered(rows, filters)[:limit]


def get_object(object_id: str) -> "dict | None":
    """One object's full record + lineage chain (``obj ← task ← args ←
    …``) and the producing task's flight-recorder phases — the
    `ray-tpu memory <object_id>` drill-down. Point lookup pushed down
    to the head."""
    reply = _call("get_object", {"object_id": object_id})
    return reply.get("object")


def list_workers(*, filters=None, limit: int = 1000) -> list[dict]:
    rows = _call("list_workers")["workers"]
    return _filtered(rows, filters)[:limit]


def list_nodes(*, filters=None, limit: int = 1000) -> list[dict]:
    rows = _call("get_nodes")["nodes"]
    return _filtered(rows, filters)[:limit]


def list_placement_groups(*, filters=None, limit: int = 1000) -> list[dict]:
    """Reference: util/state list_placement_groups."""
    rows = _call("list_placement_groups")["placement_groups"]
    return _filtered(rows, filters)[:limit]


def list_jobs(*, filters=None, limit: int = 1000) -> list[dict]:
    """Submitted jobs (reference: util/state list_jobs / JobSubmissionClient
    list_jobs)."""
    from ray_tpu_torch import job_submission

    rows = [dict(j) for j in job_submission.list_jobs()]
    return _filtered(rows, filters)[:limit]


def get_task(task_id: str) -> "dict | None":
    """One task's record (reference: util/state/api.py get_task).
    Point lookup pushed down to the head — never ships the table."""
    rows = _call("list_tasks", {"task_id": task_id, "limit": 1})["tasks"]
    return dict(rows[0]) if rows else None


def get_actor(actor_id: str) -> "dict | None":
    """One actor's record (reference: util/state/api.py get_actor).
    Point lookup pushed down to the head — never ships the table."""
    rows = _call("list_actors", {"actor_id": actor_id})["actors"]
    return dict(rows[0]) if rows else None


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def summarize_tasks() -> dict:
    """Counts by (name, state) — reference: util/state/api.py:1368 —
    plus per-phase latency breakdowns (p50/p95 of queue wait, dispatch,
    exec, result transfer) derived from the flight-recorder lifecycle
    events, clock-aligned across nodes."""
    from ray_tpu_torch._private.events import phase_latencies

    by_name: dict[str, Counter] = {}
    for t in list_tasks(limit=100000):
        by_name.setdefault(t["name"], Counter())[t["state"]] += 1
    # Phase latencies per task name from the head's event table.
    lat_by_name: dict[str, dict[str, list]] = {}
    data = get_timeline_data()
    for ev in data["events"]:
        if not isinstance(ev, dict) or "phases" not in ev \
                or not ev.get("name"):
            continue
        aligned = _aligned(ev, data)
        bucket = lat_by_name.setdefault(ev["name"], {})
        for phase, dt in phase_latencies(aligned).items():
            bucket.setdefault(phase, []).append(max(0.0, dt))
        # Executor-thread CPU seconds (worker-stamped): exec_cpu far
        # below exec reads as a GIL-starved or IO/lock-blocked task —
        # visible here instead of the old stderr timing prints.
        if isinstance(ev.get("cpu_time"), (int, float)):
            bucket.setdefault("exec_cpu", []).append(
                max(0.0, ev["cpu_time"]))
    out = {}
    for name, states in by_name.items():
        entry = {"state_counts": dict(states),
                 "total": sum(states.values())}
        lats = lat_by_name.get(name)
        if lats:
            entry["phase_latency_s"] = {
                phase: {"p50": _percentile(sorted(vals), 0.50),
                        "p95": _percentile(sorted(vals), 0.95),
                        "count": len(vals)}
                for phase, vals in lats.items()}
        out[name] = entry
    return out


def summarize_actors() -> dict:
    states = Counter(a["state"] for a in list_actors(limit=100000))
    return {"state_counts": dict(states), "total": sum(states.values())}


def summarize_objects() -> dict:
    """Counts + bytes by state (reference: util/state summarize_objects),
    plus per-callsite and per-node groupings from the object census
    (head-merged owner reports; see memory_summary for the raw feed)."""
    objs = list_objects(limit=100000)
    states = Counter(o["state"] for o in objs)
    size_by_state: dict[str, int] = Counter()
    for o in objs:
        size_by_state[o["state"]] += int(o.get("size", 0) or 0)
    mem = memory_summary()
    return {
        "state_counts": dict(states),
        "bytes_by_state": dict(size_by_state),
        "total": len(objs),
        "total_bytes": sum(size_by_state.values()),
        # Callsite-attributed live refs (owner censuses, merged across
        # clients by the head) and directory bytes per node.
        "by_callsite": mem.get("groups") or {},
        "by_node": mem.get("by_node") or {},
    }


def object_store_stats() -> dict:
    """Shm-store stats incl. the pin/fragmentation breakdown
    (pinned vs reclaimable sealed bytes, eviction-candidate count,
    fragmented free space) that explains memory-pressure decisions."""
    return _call("store_stats")


def memory_summary() -> dict:
    """The `ray-tpu memory` feed (reference: `ray memory` /
    internal_api.py memory_summary): owner censuses merged by callsite
    (count/bytes/kinds/unawaited per creating callsite), directory
    bytes by node and state, store stats, per-client census health,
    and the leak detector's current suspects with trend data."""
    return _call("memory_summary")


def list_logs(*, node_id: "str | None" = None) -> list[dict]:
    """Worker log index (reference: util/state list_logs). With a
    node_id the head forwards to that node's agent, so every node's
    logs are listable from the driver."""
    body = {"node_id": node_id} if node_id else {}
    return _call("log_index", body)["logs"]


def get_log(name: str, *, tail: int = 500, max_bytes: int = 64 * 1024,
            node_id: "str | None" = None) -> list[str]:
    """Tail one worker log (reference: util/state get_log), locally or
    on a remote node via its agent."""
    body = {"name": name, "max_bytes": max_bytes}
    if node_id:
        body["node_id"] = node_id
    reply = _call("log_tail", body)
    return reply["lines"][-tail:] if tail > 0 else []


def get_trace(trace_id: str) -> "dict | None":
    """One causal trace tree: summary plus full span detail
    (`ray-tpu trace <id>` backs onto this)."""
    return _call("get_trace", {"trace_id": trace_id})["trace"]


def list_traces(*, limit: int = 100,
                exemplars_only: bool = False) -> list[dict]:
    """Retained trace summaries, newest first. Tail-based retention:
    slow/error/shed exemplars and a uniform 1-in-N sample keep full
    detail; folded traces appear only in runtime_stats counters."""
    return _call("list_traces", {
        "limit": limit, "exemplars_only": exemplars_only})["traces"]


def health_summary() -> dict:
    """Operator health view (`ray-tpu health` backs onto this): overload
    state (pending budgets, deadline sheds, admission rejections,
    memory-pressured nodes) and the unified retry plane's circuit
    breakers — the head process's own plus every reporting client's, so
    "why is traffic to that peer being shed" has one answer surface."""
    snap = _call("runtime_stats")
    clients = (snap.get("rpc") or {}).get("clients") or {}
    client_breakers = {
        cid: {t: b for t, b in (c.get("breakers") or {}).items()}
        for cid, c in clients.items() if c.get("breakers")}
    open_breakers = {}
    for scope, table in [("head", snap.get("breakers") or {})] + [
            (cid, t) for cid, t in client_breakers.items()]:
        for target, b in table.items():
            if b.get("open") or b.get("trip_count"):
                open_breakers.setdefault(scope, {})[target] = b
    gauges = snap.get("gauges") or {}
    return {
        "gauges": gauges,
        "counters": snap.get("counters") or {},
        "tasks_shed": snap.get("tasks_shed") or {},
        "pressured_nodes": snap.get("pressured_nodes") or {},
        "worker_deaths": snap.get("worker_deaths") or {},
        # Breakers that are open now or have tripped before, per
        # process ("head" = the head process itself).
        "breakers": open_breakers,
    }


def list_crash_reports(*, filters=None, limit: int = 100) -> list[dict]:
    """Classified worker/node death reports from the head's bounded
    crash-forensics table (reference analogue: the GCS worker-death
    table with WorkerExitType + exit_detail). Summary rows — use
    get_crash_report() for the full evidence (stacks, log tail,
    beacon, flight-recorder cross-link)."""
    rows = _call("list_crash_reports", {"limit": limit})["reports"]
    return _filtered(rows, filters)[:limit]


def get_crash_report(worker_id: str) -> "dict | None":
    """One death's FULL post-mortem report: classification
    (exit_type/exit_detail), real exit code / terminating signal,
    faulthandler stack excerpt, log tail, the worker's last beacon
    (task, phase, rss, cpu at the instant of death), and its last
    flight-recorder events. Node deaths live under ``node:<node_id>``."""
    rows = _call("list_crash_reports", {"worker_id": worker_id})["reports"]
    return dict(rows[0]) if rows else None


def profile_worker(worker_id: str, duration_s: float = 5.0, *,
                   mode: str = "cpu", hz: int = 50,
                   include_idle: bool = False) -> dict:
    """Sample one live worker's threads for ``duration_s`` seconds and
    return folded collapsed stacks (``{"file:func;file:func": hits}``)
    — the Python API over the worker's sampling profiler that was
    previously reachable only through the dashboard's /api/profile
    endpoint. ``mode="memory"`` traces allocations (tracemalloc window)
    instead. Render with save_flamegraph() / save_speedscope()."""
    body = {"worker_id": worker_id, "sample_s": float(duration_s),
            "hz": int(hz), "mode": mode, "include_idle": bool(include_idle)}
    return global_runtime().conn.call("profile_worker", body,
                                      timeout=float(duration_s) + 20.0)


def cluster_profile(*, role: "str | None" = None,
                    node: "str | None" = None,
                    window: "int | None" = None) -> dict:
    """The continuous profiling plane's merged cluster table
    (`ray-tpu profile` backs onto this): every process samples its own
    threads on a duty cycle from boot (head, dispatch shards, node
    agents, workers, drivers — role-tagged), window summaries ride the
    amortized rpc_report/heartbeat casts, and the head merges them into
    bounded windows keyed (node, role, window index).

    Returns ``{"windows": [...], "gil_exemplars": [...], "stats": {...},
    "window_s": float}``. Each window carries ``folded`` collapsed
    stacks mergeable with profile_worker() output — render via
    save_flamegraph()/save_speedscope() after merging with
    profplane.merge_folded, or let the CLI do it."""
    body: dict = {}
    if role is not None:
        body["role"] = role
    if node is not None:
        body["node"] = node
    if window is not None:
        body["window"] = int(window)
    return _call("cluster_profile", body)


def query_metrics(name: str, labels: "dict | None" = None,
                  start: "float | None" = None,
                  end: "float | None" = None,
                  step: "float | None" = None) -> dict:
    """Range query against the head's embedded time-series store
    (`ray-tpu metrics query` and the dashboard Charts view back onto
    this). History is retained in two tiers — raw ~10s buckets for the
    last ~30min, 1min rollups for ~24h — and the store answers from
    whichever tier covers ``start`` (``step`` coarser than the tier
    resolution resamples).

    Returns ``{"series": [{"name", "labels", "kind", "resolution_s",
    "points"}], "enabled": bool}``; each point is a
    ``[ts, min, max, sum, count, last]`` aggregate bucket. Under a
    sharded head every shard's store is queried and same-keyed series
    merge. Empty when ``RAY_TPU_TSDB_ENABLED=0``."""
    body: dict = {"name": name}
    if labels:
        body["labels"] = dict(labels)
    if start is not None:
        body["start"] = float(start)
    if end is not None:
        body["end"] = float(end)
    if step is not None:
        body["step"] = float(step)
    return _call("query_metrics", body)


def list_alerts(*, history: bool = False) -> dict:
    """The SLO alert engine's table (`ray-tpu alerts` backs onto
    this): active records (pending + firing) and, with
    ``history=True``, the bounded resolved ring. Returns
    ``{"alerts": [...], "stats": {...}, "enabled": bool}``; a firing
    record pins its cross-plane evidence under ``context`` (trace
    exemplar ids, overlapping profile windows, crash reports)."""
    return _call("list_alerts", {"history": bool(history)})


def save_flamegraph(profile: dict, path: str) -> str:
    """Write a profile_worker() result as collapsed-stack lines — the
    input format of flamegraph.pl / inferno / speedscope's importer."""
    folded = profile.get("folded") or {}
    with open(path, "w") as f:
        for stack, hits in folded.items():
            f.write(f"{stack} {hits}\n")
    return path


def to_speedscope(profile: dict, name: str = "ray_tpu_torch worker") -> dict:
    """Convert a profile_worker() result to the speedscope file format
    (https://www.speedscope.app) — paste/drag the saved JSON into the
    web UI for an interactive flamegraph."""
    folded = profile.get("folded") or {}
    frames: list[dict] = []
    index: dict[str, int] = {}
    samples, weights = [], []
    for stack, hits in folded.items():
        sample = []
        for frame in stack.split(";"):
            i = index.get(frame)
            if i is None:
                i = index[frame] = len(frames)
                frames.append({"name": frame})
            sample.append(i)
        samples.append(sample)
        weights.append(hits)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [{
            "type": "sampled",
            "name": f"{name} ({profile.get('worker_id', '?')})",
            "unit": "none",
            "startValue": 0,
            "endValue": total,
            "samples": samples,
            "weights": weights,
        }],
    }


def save_speedscope(profile: dict, path: str,
                    name: str = "ray_tpu_torch worker") -> str:
    import json

    with open(path, "w") as f:
        json.dump(to_speedscope(profile, name), f)
    return path


def get_task_events(limit: int = 10000,
                    task_ids: "list[str] | None" = None) -> list[dict]:
    body: dict = {"limit": limit}
    if task_ids is not None:
        body["task_ids"] = list(task_ids)
    return _call("get_task_events", body)["events"]


def get_timeline_data(limit: int = 10000) -> dict:
    """Raw flight-recorder feed: events PLUS the head's per-node clock
    offsets and node id — everything timeline() needs to align
    cross-node spans onto one clock."""
    reply = _call("get_task_events", {"limit": limit})
    return {"events": reply["events"],
            "clock_offsets": reply.get("clock_offsets") or {},
            "head_node_id": reply.get("head_node_id")}


def _aligned(ev: dict, data: dict) -> dict:
    from ray_tpu_torch._private.events import align_phases

    return align_phases(ev, data["clock_offsets"], data["head_node_id"])


def timeline(filename: str | None = None) -> "list | str":
    """Chrome-trace export of the task flight recorder (reference:
    _private/profiling.py:124 `ray timeline`). Load the result in
    chrome://tracing or Perfetto (ui.perfetto.dev).

    Per task: the classic execution span (cat "task") on the executing
    node's track, one sub-span per lifecycle segment (cat "phase":
    submit/queue/dispatch/dequeue/exec/seal/resolve — owner- and
    head-side segments render on their own tracks), and flow arrows
    (cat "lifecycle") connecting submit → push/dispatch → exec → resolve
    across pids. Chaos-plane faults appear as instant events (cat
    "chaos") on the node that injected them; user tracing.span events
    keep their old rendering. Cross-node timestamps are aligned onto the
    head's clock via the heartbeat-estimated offsets."""
    from ray_tpu_torch._private.events import PHASE_DOMAIN, PHASE_SEGMENTS

    data = get_timeline_data()
    trace: list = []
    track_index: dict = {}  # Chrome traces want integer pids

    def _pid(label) -> int:
        return track_index.setdefault(label or "?", len(track_index))

    for ev in data["events"]:
        if not isinstance(ev, dict):
            continue
        if ev.get("event") in ("worker_death", "oom_kill"):
            # Crash-forensics instants: classified worker deaths and
            # memory-monitor kills on the dead worker's node track.
            off = (data["clock_offsets"].get(ev.get("node_id"), 0.0)
                   if ev.get("node_id") else 0.0)
            reason = ev.get("reason") or "oom_kill"
            trace.append({
                "cat": "death", "ph": "i", "s": "p",
                "name": f"death:{reason}:{(ev.get('worker_id') or '')[:16]}",
                "ts": (ev["ts"] - off) * 1e6,
                "pid": _pid(ev.get("node_id")),
                "tid": int(ev.get("pid") or 0),
                "args": {k: ev.get(k) for k in
                         ("worker_id", "node_id", "reason", "detail",
                          "tasks") if ev.get(k) is not None},
            })
            continue
        if ev.get("event") == "overload":
            # Overload-protection instants: deadline sheds, admission
            # rejections, memory-pressure transitions — rendered on the
            # affected node's track (or a dedicated "overload" track).
            kind = ev.get("kind") or "shed"
            off = (data["clock_offsets"].get(ev.get("node_id"), 0.0)
                   if ev.get("node_id") else 0.0)
            trace.append({
                "cat": "overload", "ph": "i", "s": "p",
                "name": f"overload:{kind}"
                        + (f":{ev['where']}" if ev.get("where") else ""),
                "ts": (ev["ts"] - off) * 1e6,
                "pid": _pid(ev.get("node_id") or "overload"),
                "tid": 0,
                "args": {k: ev.get(k) for k in
                         ("kind", "where", "task_id", "name", "owner_id",
                          "scope", "pending", "limit", "node_id",
                          "used_bytes", "total_bytes")
                         if ev.get(k) is not None},
            })
            continue
        if ev.get("event") == "chaos":
            trace.append({
                "cat": "chaos", "ph": "i", "s": "p",
                "name": f"fault:{ev.get('action')}:{ev.get('kind')}",
                "ts": ev["ts"] * 1e6,
                "pid": _pid("chaos"), "tid": int(ev.get("pid") or 0),
                "args": {k: ev.get(k) for k in
                         ("action", "direction", "peer", "kind",
                          "delay_s") if ev.get(k) is not None},
            })
            continue
        phases = _aligned(ev, data) if "phases" in ev else {}
        worker_pid = _pid(ev.get("node_id"))
        worker_tid = int(ev.get("pid") or 0)
        name = ev.get("name")
        args = {"task_id": ev.get("task_id"),
                "node_id": ev.get("node_id"),
                "failed": ev.get("failed", False)}
        if ev.get("start") is not None and ev.get("end") is not None:
            # The classic execution / user-span complete event (kept
            # verbatim: existing tooling and tests key on it).
            off = (data["clock_offsets"].get(ev.get("node_id"), 0.0)
                   if ev.get("node_id") else 0.0)
            trace.append({
                "cat": "span" if ev.get("event") == "span" else "task",
                "name": name, "ph": "X",
                "ts": (ev["start"] - off) * 1e6,
                "dur": (ev["end"] - ev["start"]) * 1e6,
                "pid": worker_pid, "tid": worker_tid,
                "args": {**args, **(
                    {"parent": ev.get("parent"),
                     **(ev.get("attributes") or {})}
                    if ev.get("event") == "span" else {})},
            })
        if not phases:
            continue
        owner_pid = _pid(ev.get("owner_node_id") or "owner")
        head_pid = _pid(data.get("head_node_id") or "head")
        track_for = {"owner": (owner_pid, 0), "head": (head_pid, 0),
                     "worker": (worker_pid, worker_tid)}
        for a, b, label in PHASE_SEGMENTS:
            ta, tb = phases.get(a), phases.get(b)
            if ta is None or tb is None:
                continue
            pid_, tid_ = track_for[PHASE_DOMAIN.get(a, "worker")]
            trace.append({
                "cat": "phase", "name": label, "ph": "X",
                "ts": ta * 1e6, "dur": max(0.0, tb - ta) * 1e6,
                "pid": pid_, "tid": tid_,
                "args": {**args, "from": a, "to": b},
            })
        # Flow arrows: submit (owner) → recv (worker) → resolve (owner)
        # connect the per-task story across pids. A lone point would
        # render as a dangling arrow, so fewer than two emit nothing.
        flow_points = [(p, *track_for[PHASE_DOMAIN[p]])
                       for p in ("submit", "recv", "resolve")
                       if p in phases]
        if len(flow_points) >= 2:
            for i, (p, pid_, tid_) in enumerate(flow_points):
                ph = "s" if i == 0 else ("f" if i == len(flow_points) - 1
                                         else "t")
                step = {"cat": "lifecycle", "name": "task-flow",
                        "ph": ph, "id": ev.get("task_id"),
                        "ts": phases[p] * 1e6, "pid": pid_, "tid": tid_}
                if ph == "f":
                    step["bp"] = "e"
                trace.append(step)
    if filename is None:
        return trace
    import json

    with open(filename, "w") as f:
        json.dump(trace, f)
    return filename
