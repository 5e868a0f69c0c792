"""Dashboard: HTTP cluster-state endpoint (port of ray_tpu/dashboard.py,
with its web UI ``dashboard_ui.html``, whose chip row reads ``GPU``).

Counterpart of the reference's dashboard head (SURVEY.md §2.2 —
dashboard/head.py + modules for actors/nodes/jobs/metrics; the React
frontend is out of scope). JSON API over aiohttp in a dedicated actor:

    GET /            tiny HTML summary
    GET /api/cluster resources + nodes + object store stats
    GET /api/actors  /api/tasks  /api/objects  /api/workers  /api/jobs
    GET /api/task_summary
    GET /api/crashes /api/crashes/<worker_id>   post-mortem crash reports
    GET /api/profiles   merged cluster profile table (continuous plane)
    GET /metrics     Prometheus exposition text
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading

import ray_tpu_torch


def _logs_dir() -> str | None:
    import os

    from ray_tpu_torch._private.worker_context import get_head

    head = get_head()
    if head is not None:
        return os.path.join(head.session_dir, "logs")
    # Remote dashboard actor: the session dir travels via env.
    sess = os.environ.get("RAY_TPU_SESSION_DIR")
    return os.path.join(sess, "logs") if sess else None


def _log_index() -> list[dict]:
    from ray_tpu_torch._private import log_utils

    return log_utils.log_index(_logs_dir())


def _profile_worker(worker_id: str, query: "dict | None" = None) -> dict:
    """Delegate to the head (the dashboard actor runs in a worker
    process). ?duration=N samples the worker for N seconds and returns
    folded collapsed stacks (flamegraph input — where time GOES);
    without it, one faulthandler snapshot (where it is STUCK)."""
    from ray_tpu_torch._private.worker_context import global_runtime

    q = query or {}
    body = {"worker_id": worker_id}
    if q.get("duration"):
        body["sample_s"] = float(q["duration"])
        body["hz"] = int(q.get("hz", 50))
        if q.get("mode"):
            body["mode"] = q["mode"]  # "cpu" (default) | "memory"
        if q.get("include_idle"):
            # ?include_idle=1 keeps parked/blocked threads in the
            # profile (needed to see WHERE a deadlocked worker waits —
            # the default filter would render it as an empty graph).
            body["include_idle"] = q["include_idle"] not in ("0", "false")
    timeout = 15 + float(body.get("sample_s") or 0)
    return global_runtime().conn.call("profile_worker", body,
                                      timeout=timeout)


def _log_tail(name: str, max_bytes: int = 64 * 1024) -> dict:
    from ray_tpu_torch._private import log_utils

    return log_utils.log_tail(_logs_dir(), name, max_bytes)


def _serve_apps() -> dict:
    """Applications -> routes, deployments, replica breakdown."""
    from ray_tpu_torch import serve

    try:
        deployments = serve.status()
    except Exception:
        return {"apps": {}}
    routes: dict = {}
    try:
        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
        routes = ray_tpu_torch.get(controller.get_routes.remote(), timeout=10)
    except Exception:
        pass
    apps: dict = {}
    for name, st in (deployments or {}).items():
        app = st.get("app") or "default"
        entry = apps.setdefault(app, {"deployments": {}, "routes": []})
        entry["deployments"][name] = st
    for prefix, info in (routes or {}).items():
        for app, entry in apps.items():
            if info.get("name") in entry["deployments"]:
                entry["routes"].append(
                    {"prefix": prefix, "deployment": info.get("name")})
    return {"apps": apps}


def _train_runs() -> list:
    import json as _json

    from ray_tpu_torch._private.worker_context import global_runtime

    rt = global_runtime()
    runs = []
    try:
        for key in rt.kv_keys(ns="__train__"):
            blob = rt.kv_get(key, ns="__train__")
            if blob:
                try:
                    runs.append(_json.loads(blob))
                except ValueError:
                    pass
    except Exception:
        pass
    runs.sort(key=lambda r: r.get("started_at", 0), reverse=True)
    return runs


def _node_detail(node_id: str) -> "dict | None":
    """One node's page: identity, resources, its workers and tasks
    (reference: dashboard node-detail view, dashboard/modules/node)."""
    from ray_tpu_torch.util import state as us

    node = next((n for n in us.list_nodes()
                 if n.get("node_id") == node_id), None)
    if node is None:
        return None
    workers = [w for w in us.list_workers()
               if w.get("node_id") == node_id]
    tasks = [t for t in us.list_tasks()
             if t.get("node_id") == node_id]
    actors = [a for a in us.list_actors()
              if a.get("node_id") == node_id]
    return {"node": node, "workers": workers, "actors": actors,
            "tasks": tasks[-200:]}


def _task_detail(task_id: str) -> "dict | None":
    """One task's page: record + profile events + owning worker's log
    tail (reference: dashboard task detail view — dashboard/modules/job
    task drill-down over state + events + logs)."""
    from ray_tpu_torch.util import state as us

    task = us.get_task(task_id)
    if task is None:
        return None
    events = us.get_task_events(task_ids=[task_id])
    log: dict = {}
    wid = task.get("worker_id")
    if wid:
        log = _log_tail(str(wid), max_bytes=16 * 1024)
        log["lines"] = log.get("lines", [])[-100:]
    return {"task": task, "events": events, "worker_log": log}


def _actor_detail(actor_id: str) -> "dict | None":
    """One actor's page: record + its tasks + events + worker log tail
    (reference: dashboard/modules/actor — actor detail view)."""
    from ray_tpu_torch.util import state as us

    actor = us.get_actor(actor_id)
    if actor is None:
        return None
    wid = actor.get("worker_id")
    # The head returns the LAST `limit` matching rows — exactly the
    # window the page shows, so a long-lived actor's full task history
    # never ships per poll.
    tasks = us.list_tasks(filters=[("worker_id", "=", wid)],
                          limit=200) if wid else []
    events = us.get_task_events(task_ids=[t["task_id"] for t in tasks],
                                limit=500)
    log: dict = {}
    if wid:
        log = _log_tail(str(wid), max_bytes=16 * 1024)
        log["lines"] = log.get("lines", [])[-100:]
    return {"actor": actor, "tasks": tasks, "events": events,
            "worker_log": log}


class DashboardServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._port = self._sock.getsockname()[1]
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True, name="dashboard")
        self._thread.start()
        self._ready.wait(timeout=10)

    def get_port(self) -> int:
        return self._port

    def ping(self) -> str:
        return "pong"

    # ------------------------------------------------------------------

    @staticmethod
    def _payload(path: str, query: "dict | None" = None):
        from ray_tpu_torch.util import metrics as um
        from ray_tpu_torch.util import state as us

        if path == "/api/cluster":
            return {
                "resources_total": ray_tpu_torch.cluster_resources(),
                "resources_available": ray_tpu_torch.available_resources(),
                "nodes": us.list_nodes(),
                "object_store": us.object_store_stats(),
            }
        if path == "/api/actors":
            return {"actors": us.list_actors()}
        if path == "/api/tasks":
            return {"tasks": us.list_tasks()}
        if path == "/api/task_summary":
            return us.summarize_tasks()
        if path == "/api/objects":
            # Objects view (reference: `ray memory` rendered in the
            # dashboard): full rows + the callsite-grouped census /
            # leak-suspect summary in one payload.
            return {"objects": us.list_objects(),
                    "summary": us.memory_summary()}
        if path.startswith("/api/objects/"):
            obj = us.get_object(path[len("/api/objects/"):])
            return obj if obj is not None else None
        if path == "/api/workers":
            return {"workers": us.list_workers()}
        if path == "/api/jobs":
            from ray_tpu_torch.job_submission import list_jobs

            return {"jobs": list_jobs()}
        if path == "/api/serve":
            # Reference: dashboard/modules/serve — deployment statuses.
            from ray_tpu_torch import serve

            return {"deployments": serve.status()}
        if path == "/api/serve/apps":
            # Application-level view (reference: dashboard/modules/serve
            # — per-app pages: route prefixes, deployments, replicas).
            return _serve_apps()
        if path == "/api/train":
            # Train run registry (reference: dashboard/modules/train —
            # run list + latest metrics; fed by RunStateActor._publish).
            return {"runs": _train_runs()}
        if path.startswith("/api/nodes/"):
            return _node_detail(path[len("/api/nodes/"):])
        if path.startswith("/api/tasks/"):
            return _task_detail(path[len("/api/tasks/"):])
        if path.startswith("/api/actors/"):
            return _actor_detail(path[len("/api/actors/"):])
        if path == "/api/crashes":
            # Crash-forensics plane (reference: the dashboard's worker
            # death listings with exit type/detail): classified
            # worker/node death reports from the head's bounded table.
            return {"crashes": us.list_crash_reports()}
        if path.startswith("/api/crashes/"):
            report = us.get_crash_report(path[len("/api/crashes/"):])
            return report if report is not None else None
        if path == "/api/profiles":
            # Continuous profiling plane: the head's merged cluster
            # profile table (always-on duty-cycled samples from every
            # runtime process, keyed node/role/window) + GIL exemplars
            # and plane counters. ?role=&node=&window= filter.
            q = query or {}
            return us.cluster_profile(
                role=q.get("role") or None,
                node=q.get("node") or None,
                window=int(q["window"]) if q.get("window") else None)
        if path.startswith("/api/profile/"):
            # Live stack dump of a worker (reference:
            # dashboard/modules/reporter/profile_manager.py:191 — py-spy
            # stack capture; here the workers' registered faulthandler
            # SIGUSR1 hook writes every thread's stack into the worker
            # log, which this endpoint harvests).
            return _profile_worker(path[len("/api/profile/"):], query)
        if path == "/api/traces":
            # Request-tracing plane: retained trace summaries (tail
            # exemplars + uniform sample), newest first.
            q = query or {}
            return {"traces": us.list_traces(
                limit=int(q.get("limit", 100)),
                exemplars_only=q.get("exemplars") in ("1", "true"))}
        if path.startswith("/api/traces/"):
            return us.get_trace(path[len("/api/traces/"):])
        if path == "/api/logs":
            # Reference: dashboard/modules/log — per-worker log index.
            return {"logs": _log_index()}
        if path.startswith("/api/logs/"):
            name = path[len("/api/logs/"):]
            return _log_tail(name)
        if path == "/api/metrics/query":
            # Telemetry-history range query against the head's embedded
            # tsdb (raw ~10s buckets for 30min, 1min rollups for 24h).
            # ?name= is required; ?label.k=v filters; ?start/end/step
            # shape the window (the Charts SPA view's data source).
            q = query or {}
            name = q.get("name")
            if not name:
                return {"error": "name= required", "series": []}
            labels = {k[len("label."):]: v for k, v in q.items()
                      if k.startswith("label.")}
            return us.query_metrics(
                name, labels or None,
                float(q["start"]) if q.get("start") else None,
                float(q["end"]) if q.get("end") else None,
                float(q["step"]) if q.get("step") else None)
        if path == "/api/alerts":
            # SLO alert plane: active pending/firing records (with the
            # cross-plane evidence pinned at fire time) + engine stats;
            # ?history=1 adds the resolved ring.
            q = query or {}
            return us.list_alerts(
                history=q.get("history") in ("1", "true"))
        if path == "/api/grafana_alerts":
            # Grafana-provisionable alert-rule bundle rendered from the
            # SAME rule registry the head's engine evaluates — dashboards
            # and alerting can never drift apart.
            from ray_tpu_torch.util import metrics_export

            return metrics_export.grafana_alert_rules()
        if path == "/metrics":
            return um.prometheus_text()
        if path == "/api/prometheus_sd":
            # Prometheus http_sd_configs body (reference:
            # dashboard/modules/metrics service discovery file).
            from ray_tpu_torch.util import metrics_export

            q = query or {}
            return metrics_export.prometheus_sd(
                q.get("host", "127.0.0.1"), int(q.get("port", 0)) or 0)
        if path == "/api/grafana_dashboard":
            # Importable Grafana dashboard JSON over the runtime metric
            # set + any user metrics currently registered (reference:
            # dashboard/modules/metrics/dashboards generation).
            from ray_tpu_torch.util import metrics_export

            try:
                user_metrics = sorted(um.get_metrics_report())
            except Exception:
                user_metrics = []
            return metrics_export.grafana_dashboard(user_metrics)
        if path == "/":
            # Web UI (reference: dashboard/client/src React app; here a
            # single self-contained SPA over the same JSON endpoints).
            import os

            ui = os.path.join(os.path.dirname(__file__),
                              "dashboard_ui.html")
            try:
                with open(ui, encoding="utf-8") as f:
                    return f.read()
            except OSError:
                return "<html><body>dashboard_ui.html missing</body></html>"
        return None

    def _serve(self) -> None:
        from aiohttp import web

        async def handle(request: "web.Request") -> "web.Response":
            loop = asyncio.get_running_loop()
            try:
                payload = await loop.run_in_executor(
                    None, self._payload, request.path, dict(request.query))
            except Exception as e:  # noqa: BLE001
                return web.json_response({"error": str(e)}, status=500)
            if payload is None:
                return web.json_response({"error": "not found"}, status=404)
            if isinstance(payload, str):
                ctype = "text/html" if payload.startswith("<") else "text/plain"
                return web.Response(text=payload, content_type=ctype)
            return web.Response(text=json.dumps(payload, default=str),
                                content_type="application/json")

        async def run():
            app = web.Application()
            app.router.add_get("/{tail:.*}", handle)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.SockSite(runner, self._sock)
            await site.start()
            self._ready.set()
            while True:
                await asyncio.sleep(3600)

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(run())


_dashboard = None


def start_dashboard(host: str = "127.0.0.1", port: int = 0) -> int:
    """Launch (or attach to) the dashboard actor; returns the bound port."""
    from ray_tpu_torch._private import rpc

    global _dashboard
    ray_tpu_torch.api.auto_init()
    if _dashboard is None:
        try:
            _dashboard = ray_tpu_torch.get_actor("DASHBOARD", namespace="_dashboard")
        except ValueError:
            try:
                # Pin to the head node: the log endpoints read the head's
                # session logs directory, which only exists there
                # (reference: the dashboard head process runs on the head).
                from ray_tpu_torch.util.scheduling_strategies import (
                    NodeAffinitySchedulingStrategy,
                )

                nodes = ray_tpu_torch.nodes()
                head_node = next(
                    (n["node_id"] for n in nodes if n.get("is_head")),
                    nodes[0]["node_id"],
                )
                cls = ray_tpu_torch.remote(
                    num_cpus=0, max_concurrency=8, name="DASHBOARD",
                    namespace="_dashboard",
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=head_node),
                )(DashboardServer)
                _dashboard = cls.remote(host, port)
            except rpc.RpcError:
                # Creation race with another client: attach instead.
                _dashboard = ray_tpu_torch.get_actor("DASHBOARD", namespace="_dashboard")
    return ray_tpu_torch.get(_dashboard.get_port.remote())


def stop_dashboard() -> None:
    global _dashboard
    if _dashboard is not None:
        try:
            ray_tpu_torch.kill(_dashboard)
        except Exception:
            pass
        _dashboard = None
