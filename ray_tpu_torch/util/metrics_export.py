"""Prometheus + Grafana integration artifacts (port of
ray_tpu/util/metrics_export.py). The series keep their ``ray_tpu_*``
names, the job label and the dashboard's title: ``util.metrics`` emits
them under those names, and a scrape config or a dashboard written for
ray_tpu reads the port's cluster unchanged.

Counterpart of the reference's dashboard metrics module
(reference: python/ray/dashboard/modules/metrics/ — it writes a
Prometheus scrape config and generates Grafana dashboard JSON for the
cluster's metric set). Here the same two artifacts are generated from
the live registry and the dashboard's exposition endpoint:

    GET /api/prometheus_sd       Prometheus HTTP service-discovery body
    GET /api/grafana_dashboard   importable Grafana dashboard JSON

or from Python::

    from ray_tpu_torch.util.metrics_export import (
        grafana_dashboard, prometheus_scrape_config)
"""

from __future__ import annotations

import json


def prometheus_sd(dashboard_host: str, dashboard_port: int) -> list:
    """HTTP service-discovery payload (prometheus http_sd_configs):
    point prometheus at GET /api/prometheus_sd and it scrapes every
    listed target's /metrics (reference: the dashboard's
    prometheus_service_discovery file)."""
    return [{
        "targets": [f"{dashboard_host}:{dashboard_port}"],
        "labels": {"job": "ray_tpu", "__metrics_path__": "/metrics"},
    }]


def prometheus_scrape_config(dashboard_host: str,
                             dashboard_port: int) -> str:
    """A ready-to-paste prometheus.yml scrape_configs entry."""
    return (
        "scrape_configs:\n"
        "  - job_name: ray_tpu\n"
        "    metrics_path: /metrics\n"
        "    static_configs:\n"
        f"      - targets: ['{dashboard_host}:{dashboard_port}']\n"
    )


def _panel(panel_id: int, title: str, expr, unit: str,
           x: int, y: int) -> dict:
    """``expr`` is one PromQL string or a list of (expr, legend)
    pairs — multi-target panels render each series with its legend
    (p50/p95 pairs share one panel)."""
    if isinstance(expr, str):
        targets = [{"expr": expr, "refId": "A"}]
    else:
        targets = [{"expr": e, "legendFormat": legend,
                    "refId": chr(ord("A") + i)}
                   for i, (e, legend) in enumerate(expr)]
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "fieldConfig": {"defaults": {"unit": unit}},
        "targets": targets,
    }


def _quantile_targets(phase: str) -> list:
    hist = f"ray_tpu_phase_{phase}_seconds_bucket"
    return [
        (f"histogram_quantile(0.5, sum(rate({hist}[5m])) by (le))", "p50"),
        (f"histogram_quantile(0.95, sum(rate({hist}[5m])) by (le))", "p95"),
    ]


# Flight-recorder phase-latency histograms exported by the head
# (ray_tpu_phase_*_seconds, util/metrics.runtime_stats_text).
_PHASES = ("queue_wait", "dispatch", "exec", "result_transfer")


def grafana_dashboard(extra_metrics: "list[str] | None" = None) -> dict:
    """Importable Grafana dashboard covering the core runtime metrics
    (reference: dashboard/modules/metrics/dashboards/*_dashboard_panels
    — default panels generated for the cluster metric set), the
    flight-recorder phase-latency histograms (p50/p95 of queue wait /
    dispatch / exec / result transfer), the cluster RPC head-frame
    census, and the crash-forensics deaths-by-reason counters. User
    metrics passed in ``extra_metrics`` get a generic panel each."""
    panels = [
        _panel(1, "Tasks finished / s",
               "rate(ray_tpu_tasks_finished_total[1m])", "ops", 0, 0),
        _panel(2, "Tasks failed / s",
               "rate(ray_tpu_tasks_failed_total[1m])", "ops", 12, 0),
        _panel(3, "Object store used bytes",
               "ray_tpu_object_store_used_bytes", "bytes", 0, 8),
        _panel(4, "Objects in store",
               "ray_tpu_object_store_num_objects", "short", 12, 8),
        _panel(5, "Workers alive",
               "ray_tpu_workers_alive", "short", 0, 16),
        _panel(6, "Actors alive",
               "ray_tpu_actors_alive", "short", 12, 16),
    ]
    next_id = 7
    y = 24
    # Per-phase latency quantiles (PR 3 tracing plane).
    for i, phase in enumerate(_PHASES):
        panels.append(_panel(
            next_id, f"Task {phase.replace('_', ' ')} latency (p50/p95)",
            _quantile_targets(phase), "s",
            (i % 2) * 12, y + (i // 2) * 8))
        next_id += 1
    y += 16
    # Cluster RPC census + crash-forensics deaths.
    panels.append(_panel(
        next_id, "Head control-plane frames / s (cluster total)",
        "rate(ray_tpu_rpc_head_frames_total[1m])", "ops", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Worker deaths by reason / 5m",
        "sum by (reason) (increase(ray_tpu_worker_deaths_total[5m]))",
        "short", 12, y))
    next_id += 1
    y += 8
    # Object-plane observability row (PR 7): live bytes by state,
    # top-callsite attribution, leak-suspect trend.
    panels.append(_panel(
        next_id, "Object store bytes by state",
        "sum by (state) (ray_tpu_object_store_bytes)", "bytes", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Object bytes by top callsites",
        "topk(10, ray_tpu_object_callsite_bytes)", "bytes", 12, y))
    next_id += 1
    y += 8
    panels.append(_panel(
        next_id, "Live object refs by kind",
        "sum by (kind) (ray_tpu_objects_live)", "short", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Object leak suspects",
        "ray_tpu_object_leak_suspects", "short", 12, y))
    next_id += 1
    y += 8
    # Data-plane row (PR 8): payload movement by path (p2p primaries,
    # relay sources, host-local arena reads, zero-copy views, inline
    # control-plane payloads, spill restores) + the host-copy census
    # behind the one-copy guard.
    panels.append(_panel(
        next_id, "Object bytes transferred / s by path",
        "sum by (path) "
        "(rate(ray_tpu_object_bytes_transferred_total[1m]))",
        "Bps", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Host-side payload copies / s by path",
        "sum by (path) (rate(ray_tpu_object_host_copies_total[1m]))",
        "ops", 12, y))
    next_id += 1
    y += 8
    # Serving-plane row (PR 10): ingress QPS + replica count, batch
    # queue depth, continuous-batching batch size, and overload sheds.
    panels.append(_panel(
        next_id, "Serve ingress QPS by deployment",
        "sum by (deployment) (ray_tpu_serve_qps)", "ops", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Serve replicas / ongoing by deployment",
        [("sum by (deployment) (ray_tpu_serve_replicas)", "replicas"),
         ("sum by (deployment) (ray_tpu_serve_ongoing)", "ongoing")],
        "short", 12, y))
    next_id += 1
    y += 8
    panels.append(_panel(
        next_id, "Serve batch queue depth / batch size p50",
        [("sum by (deployment) (ray_tpu_serve_queue_depth)", "queue depth"),
         ("max by (deployment) (ray_tpu_serve_batch_size_p50)",
          "batch size p50")],
        "short", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Serve requests shed / 5m (deadline + queue-full)",
        "sum by (deployment) (increase(ray_tpu_serve_shed_total[5m]))",
        "short", 12, y))
    next_id += 1
    y += 8
    # Request-tracing row: retention/exemplar gauges plus the per-kind
    # exemplar-id info series (the drill-down trace id for a p99/shed
    # spike — `ray-tpu trace <id>` renders the waterfall).
    panels.append(_panel(
        next_id, "Traces retained / exemplars",
        [("ray_tpu_traces_retained", "retained"),
         ("ray_tpu_traces_exemplars", "exemplars")], "short", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Trace folds + span drops / 5m",
        [("increase(ray_tpu_traces_folded_total[5m])", "folded"),
         ("increase(ray_tpu_trace_spans_dropped_total[5m])",
          "spans dropped")],
        "short", 12, y))
    next_id += 1
    y += 8
    # LLM serving row: prefix-cache efficiency + paged-KV pressure per
    # pool (mono / prefill / decode), decode-queue depth, and the
    # disaggregation handoff's byte rate (the data-plane transfer
    # counter's "handoff" path — no dedicated LLM byte gauge exists).
    panels.append(_panel(
        next_id, "LLM prefix-cache hit rate / queue depth by pool",
        [("ray_tpu_llm_prefix_hit_rate", "hit rate"),
         ("sum by (pool) (ray_tpu_llm_queue_depth)", "queue depth")],
        "short", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "LLM KV pages by pool (in use / free)",
        [("sum by (pool) (ray_tpu_llm_kv_pages_in_use)", "in use"),
         ("sum by (pool) (ray_tpu_llm_kv_pages_free)", "free")],
        "short", 12, y))
    next_id += 1
    y += 8
    panels.append(_panel(
        next_id, "LLM prefill→decode handoff bytes / s",
        "sum(rate(ray_tpu_object_bytes_transferred_total"
        "{path=\"handoff\"}[1m]))",
        "Bps", 0, y))
    next_id += 1
    y += 8
    # Continuous-profiling row (PR 18): self-time top-N frames per role
    # (where the cluster's CPU cycles GO, from the always-on sampler)
    # and the plane's window/exemplar churn.
    panels.append(_panel(
        next_id, "Profile self-time top frames (hits, by role)",
        "topk(10, sum by (role, frame) (ray_tpu_profile_self_hits))",
        "short", 0, y))
    next_id += 1
    panels.append(_panel(
        next_id, "Profile windows / GIL exemplars / pins",
        [("ray_tpu_profile_windows", "windows held"),
         ("ray_tpu_profile_pinned_windows", "pinned"),
         ("increase(ray_tpu_profile_gil_exemplars_total[5m])",
          "GIL exemplars / 5m")],
        "short", 12, y))
    next_id += 1
    y += 8
    for i, name in enumerate(extra_metrics or []):
        panels.append(_panel(next_id, name, name, "short",
                             (i % 2) * 12, y + (i // 2) * 8))
        next_id += 1
    return {
        "title": "ray_tpu cluster",
        "uid": "ray-tpu-cluster",
        "schemaVersion": 39,
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus",
        }]},
        "panels": panels,
    }


def grafana_dashboard_json(extra_metrics: "list[str] | None" = None) -> str:
    return json.dumps(grafana_dashboard(extra_metrics), indent=2)


# ----------------------------------------------------------------------
# Alert-rule export: the SAME registry the head's in-cluster engine
# evaluates (alertplane.default_rules), rendered to a Grafana
# provisioning bundle — external alerting can never drift from what the
# cluster itself watches.

def _selector(name: str, labels: "dict | None") -> str:
    if not labels:
        return name
    sel = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{sel}}}"


def _window(seconds: float) -> str:
    s = int(seconds)
    return f"{s // 60}m" if s >= 60 and s % 60 == 0 else f"{s}s"


def _threshold_expr(rule: dict) -> str:
    sel = _selector(rule["series"], rule.get("labels"))
    win = _window(float(rule.get("window_s", 60.0)))
    agg = rule.get("agg", "last")
    if agg == "rate":
        return f"sum(rate({sel}[{win}]))"
    if agg == "avg":
        return f"avg(avg_over_time({sel}[{win}]))"
    if agg == "min":
        return f"min(min_over_time({sel}[{win}]))"
    if agg == "max":
        return f"max(max_over_time({sel}[{win}]))"
    return f"max({sel})"  # "last": newest sample per series, folded


def _burn_expr(rule: dict, window_s: float) -> str:
    budget = max(1e-9, 1.0 - float(rule["objective"]))
    win = _window(window_s)
    if rule.get("bad") and rule.get("total"):
        bad = _selector(rule["bad"], rule.get("bad_labels"))
        total = _selector(rule["total"], rule.get("total_labels"))
        return (f"(sum(rate({bad}[{win}])) / "
                f"sum(rate({total}[{win}]))) / {budget:g}")
    sel = _selector(rule["series"], rule.get("labels"))
    over = float(rule["over"])
    # Time-fraction the gauge sat above the SLO bound, vs budget.
    return (f"avg_over_time(({sel} > bool {over:g})[{win}:]) "
            f"/ {budget:g}")


def grafana_alert_rules(rules: "list[dict] | None" = None) -> dict:
    """Grafana alert-provisioning bundle (apiVersion 1 file format)
    rendered from the head's rule registry. Threshold rules become a
    single-query classic condition; burn-rate rules render the
    multi-window AND (fast > factor and slow > factor) exactly as the
    in-cluster engine evaluates them."""
    if rules is None:
        from ray_tpu_torch._private import alertplane
        from ray_tpu_torch._private.config import Config

        rules = alertplane.default_rules(Config())
    out_rules = []
    for rule in rules:
        if rule.get("kind") == "burn_rate":
            factor = float(rule.get("burn_factor", 14.4))
            fast = _burn_expr(rule,
                              float(rule.get("fast_window_s", 300.0)))
            slow = _burn_expr(rule,
                              float(rule.get("slow_window_s", 3600.0)))
            expr = f"({fast} > {factor:g}) and ({slow} > {factor:g})"
        else:
            op = rule.get("op", ">")
            expr = (f"{_threshold_expr(rule)} {op} "
                    f"{float(rule['threshold']):g}")
        out_rules.append({
            "uid": f"ray-tpu-{rule['name']}",
            "title": rule["name"],
            "condition": "A",
            "for": _window(float(rule.get("for_s", 0.0))) if
                   rule.get("for_s") else "0s",
            "labels": {"severity": rule.get("severity", "warn"),
                       "source": "ray_tpu"},
            "annotations": {"summary": rule.get("summary", "")},
            "data": [{
                "refId": "A",
                "relativeTimeRange": {"from": 3600, "to": 0},
                "datasourceUid": "${datasource}",
                "model": {"expr": expr, "refId": "A",
                          "instant": True},
            }],
        })
    return {
        "apiVersion": 1,
        "groups": [{
            "orgId": 1,
            "name": "ray_tpu_slo",
            "folder": "ray_tpu",
            "interval": "30s",
            "rules": out_rules,
        }],
    }


def grafana_alert_rules_json(rules: "list[dict] | None" = None) -> str:
    return json.dumps(grafana_alert_rules(rules), indent=2)
