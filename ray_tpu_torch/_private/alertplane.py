"""Declarative SLO alerting over the embedded time-series store.

The tsdb (tsdb.py) retains history; this module watches it. Rules are
DATA, not code — a bounded registry of dicts the head evaluates on its
health tick (alerts_eval_interval_s), the Grafana generator renders to
an alerting bundle (util/metrics_export.grafana_alert_rules), and
rtlint cross-checks against the OBSERVABILITY.md catalog (RT-M003), so
in-cluster alerting and external dashboards can never drift.

Two rule kinds:

  * ``threshold`` — (series, labels, agg over window_s) OP threshold,
    held for ``for_s`` before firing (hysteresis: a blip shorter than
    for_s resets the pending timer and never pages anyone).
  * ``burn_rate`` — the Google-SRE multi-window form: an SLO objective
    (e.g. 99.9% of tasks not shed) defines an error budget; the rule
    computes how fast the budget burns over a FAST window (~5m, catches
    a cliff) and a SLOW window (~1h, suppresses flapping) and fires
    only when BOTH exceed ``burn_factor``. Bad fraction comes from a
    counter pair (bad/total rates) or, for latency-style gauges, the
    time-fraction the series sat above ``over``.

Lifecycle: pending -> firing -> resolved. A firing alert pins its
evidence at fire time via cross-plane joins (the head's context hook):
matching trace exemplar ids, the overlapping profile windows,
and crash reports in the window — the alert record IS
the incident's starting bundle. Resolved records move to a bounded
history ring.

Sinks: a stderr log line on every transition, plus an optional webhook
(``RAY_TPU_ALERT_WEBHOOK``) POSTed best-effort from a daemon thread —
alerting must never block or wedge the health loop.

Kill switch: ``RAY_TPU_ALERTS_ENABLED=0`` — no engine, no evaluation,
empty alert surfaces.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from ray_tpu_torch._private import tsdb

SEVERITIES = ("page", "warn", "info")


def enabled() -> bool:
    return os.environ.get("RAY_TPU_ALERTS_ENABLED", "1").lower() \
        not in ("0", "false", "no", "off")


def default_rules(config) -> "list[dict]":
    """The stock SLO rule registry, thresholds from Config. Series
    names here are machine-checked against docs/OBSERVABILITY.md by
    rtlint RT-M003."""
    return [
        {
            "name": "serve-p99-slo-burn",
            "kind": "burn_rate",
            "series": "ray_tpu_phase_p99_seconds",
            "labels": {"phase": "exec"},
            "over": config.alert_serve_p99_slo_s,
            "objective": 0.99,
            "fast_window_s": 300.0,
            "slow_window_s": 3600.0,
            "burn_factor": 14.4,
            "for_s": 0.0,
            "severity": "page",
            "summary": "exec-phase p99 is burning the serve latency "
                       "error budget on both the 5m and 1h windows",
        },
        {
            "name": "shed-ratio-slo-burn",
            "kind": "burn_rate",
            "bad": "ray_tpu_tasks_shed_total",
            "total": "ray_tpu_tasks_finished_total",
            "objective": 0.999,
            "fast_window_s": 300.0,
            "slow_window_s": 3600.0,
            "burn_factor": 14.4,
            "for_s": 0.0,
            "severity": "page",
            "summary": "deadline sheds are burning the completion "
                       "error budget on both windows",
        },
        {
            "name": "phase-p95-queue-wait",
            "kind": "threshold",
            "series": "ray_tpu_phase_p95_seconds",
            "labels": {"phase": "queue_wait"},
            "agg": "avg",
            "window_s": 120.0,
            "op": ">",
            "threshold": config.alert_phase_p95_warn_s,
            "for_s": 30.0,
            "severity": "warn",
            "summary": "queue-wait p95 sustained above threshold — "
                       "dispatch is falling behind admission",
        },
        {
            "name": "worker-death-rate",
            "kind": "threshold",
            "series": "ray_tpu_worker_deaths_total",
            "agg": "rate",
            "window_s": 300.0,
            "op": ">",
            "threshold": config.alert_worker_death_rate,
            "for_s": 0.0,
            "severity": "page",
            "summary": "workers are dying faster than the crash-loop "
                       "threshold",
        },
        {
            "name": "kv-page-exhaustion",
            "kind": "threshold",
            "series": "ray_tpu_llm_kv_pages_free",
            "agg": "min",
            "window_s": 120.0,
            "op": "<",
            "threshold": config.alert_kv_pages_min,
            "for_s": 30.0,
            "severity": "page",
            "summary": "a paged-KV pool is out of free pages — decode "
                       "admission is about to stall",
        },
    ]


# ----------------------------------------------------------------------
# expression evaluation (pure functions over the SeriesStore)

def eval_expr(store, series: str, labels, agg: str, window_s: float,
              now: float) -> "float | None":
    """One rule expression: per-series agg over the window, combined
    across matching series (rate/sum add; min/max fold; avg is count-
    weighted over every bucket; last takes the newest). None = no data
    in the window (a rule with no data never fires)."""
    res = store.query(series, labels, start=now - window_s, end=now,
                      now=now)
    res = [r for r in res if r["points"]]
    if not res:
        return None
    if agg == "avg":
        pts = tsdb.window_points(res, now - window_s, now)
        return tsdb.agg_over(pts, "avg")
    per = [tsdb.agg_over(r["points"], agg) for r in res]
    per = [v for v in per if v is not None]
    if not per:
        return None
    if agg in ("rate", "sum"):
        return sum(per)
    if agg == "min":
        return min(per)
    if agg in ("max", "last"):
        return max(per)
    raise ValueError(f"unknown agg {agg!r}")


def burn_rate(store, rule: dict, window_s: float,
              now: float) -> "float | None":
    """Error-budget burn multiplier over one window: 1.0 means burning
    exactly at budget (the SLO is met with nothing to spare), N means
    the budget is consumed N times too fast."""
    budget = max(1e-9, 1.0 - float(rule["objective"]))
    if rule.get("bad") and rule.get("total"):
        bad = eval_expr(store, rule["bad"], rule.get("bad_labels"),
                        "rate", window_s, now)
        total = eval_expr(store, rule["total"],
                          rule.get("total_labels"), "rate", window_s,
                          now)
        if bad is None or total is None or total <= 0:
            return None
        return (bad / total) / budget
    # Gauge form: fraction of observed time the series sat above
    # ``over`` (bucket-avg, count-weighted).
    res = store.query(rule["series"], rule.get("labels"),
                      start=now - window_s, end=now, now=now)
    pts = tsdb.window_points(res, now - window_s, now)
    total_n = sum(b[tsdb.COUNT] for b in pts)
    if not total_n:
        return None
    over = float(rule["over"])
    bad_n = sum(b[tsdb.COUNT] for b in pts
                if b[tsdb.SUM] / b[tsdb.COUNT] > over)
    return (bad_n / total_n) / budget


# ----------------------------------------------------------------------
# the engine

class AlertEngine:
    """Bounded rule table + firing/resolved lifecycle, evaluated on the
    head's health tick. Thread-safety: evaluate() and readers take the
    engine's own lock; the head never calls it under self.lock."""

    def __init__(self, config, rules: "list[dict] | None" = None):
        self.config = config
        self._lock = threading.Lock()
        self.rules: list[dict] = list(
            rules if rules is not None else default_rules(config))[
                : max(1, config.alerts_max_rules)]
        # rule name -> live record (pending or firing).
        self.active: dict[str, dict] = {}
        from collections import deque

        self.history: "deque[dict]" = deque(
            maxlen=max(8, config.alerts_history_max))
        self.fired_total = 0
        self.resolved_total = 0
        self._last_eval = 0.0

    # -- evaluation ----------------------------------------------------

    def evaluate(self, store, now: "float | None" = None,
                 context_fn=None, force: bool = False) -> "list[dict]":
        """Evaluate every rule; returns records that TRANSITIONED to
        firing this pass (the head runs sinks on them). ``context_fn``
        is the cross-plane join hook — called once per fire, its dict
        is pinned on the record as evidence."""
        now = now if now is not None else time.time()
        if not force and now - self._last_eval < \
                self.config.alerts_eval_interval_s:
            return []
        self._last_eval = now
        fired: list[dict] = []
        with self._lock:
            for rule in self.rules:
                try:
                    cond, value, detail = self._condition(store, rule,
                                                          now)
                except Exception:
                    continue  # a torn rule must not wedge the sweep
                rec = self.active.get(rule["name"])
                if cond:
                    if rec is None:
                        rec = self.active[rule["name"]] = {
                            "name": rule["name"],
                            "severity": rule.get("severity", "warn"),
                            "kind": rule.get("kind", "threshold"),
                            "summary": rule.get("summary", ""),
                            "state": "pending",
                            "since": now,
                            "rule": {k: v for k, v in rule.items()
                                     if k != "summary"},
                        }
                    rec["value"] = value
                    rec.update(detail)
                    if rec["state"] == "pending" and \
                            now - rec["since"] >= \
                            float(rule.get("for_s", 0.0)):
                        rec["state"] = "firing"
                        rec["fired_at"] = now
                        self.fired_total += 1
                        if context_fn is not None:
                            try:
                                rec["context"] = context_fn(rec) or {}
                            except Exception:
                                rec["context"] = {}
                        fired.append(rec)
                elif rec is not None:
                    if rec["state"] == "firing":
                        rec["state"] = "resolved"
                        rec["resolved_at"] = now
                        self.resolved_total += 1
                        self.history.append(rec)
                    # pending blips vanish without trace: hysteresis.
                    del self.active[rule["name"]]
        for rec in fired:
            self._sink(rec, "FIRING")
        return fired

    def _condition(self, store, rule: dict, now: float):
        if rule.get("kind") == "burn_rate":
            factor = float(rule.get("burn_factor", 14.4))
            fast = burn_rate(store, rule,
                             float(rule.get("fast_window_s", 300.0)),
                             now)
            slow = burn_rate(store, rule,
                             float(rule.get("slow_window_s", 3600.0)),
                             now)
            cond = (fast is not None and slow is not None
                    and fast > factor and slow > factor)
            return cond, fast, {"burn_fast": fast, "burn_slow": slow,
                                "burn_factor": factor}
        value = eval_expr(store, rule["series"], rule.get("labels"),
                          rule.get("agg", "last"),
                          float(rule.get("window_s", 60.0)), now)
        if value is None:
            return False, None, {}
        thr = float(rule["threshold"])
        cond = value > thr if rule.get("op", ">") == ">" else value < thr
        return cond, value, {"threshold": thr}

    # -- sinks ---------------------------------------------------------

    def note_resolved(self) -> "list[dict]":
        """Drain-and-log hook: sink RESOLVED transitions recorded since
        the last call (history entries not yet announced)."""
        with self._lock:
            fresh = [r for r in self.history
                     if not r.get("_announced")]
            for r in fresh:
                r["_announced"] = True
        for r in fresh:
            self._sink(r, "RESOLVED")
        return fresh

    def _sink(self, rec: dict, transition: str) -> None:
        print(f"ray_tpu_torch alert {transition}: {rec['name']} "
              f"[{rec['severity']}] value={rec.get('value')} — "
              f"{rec.get('summary', '')}", file=sys.stderr)
        url = os.environ.get("RAY_TPU_ALERT_WEBHOOK")
        if not url:
            return
        payload = {k: v for k, v in rec.items() if k != "_announced"}
        payload["transition"] = transition
        threading.Thread(target=_post_webhook, args=(url, payload),
                         daemon=True, name="alert-webhook").start()

    # -- read side -----------------------------------------------------

    def list(self, include_history: bool = False) -> "list[dict]":
        with self._lock:
            rows = [dict(r) for r in self.active.values()]
            if include_history:
                rows += [dict(r) for r in self.history]
        for r in rows:
            r.pop("_announced", None)
        rows.sort(key=lambda r: r.get("fired_at") or r.get("since") or 0)
        return rows

    def stats(self) -> dict:
        with self._lock:
            firing = [r for r in self.active.values()
                      if r["state"] == "firing"]
            by_sev = {}
            for r in firing:
                by_sev[r["severity"]] = by_sev.get(r["severity"], 0) + 1
            return {
                "rules": len(self.rules),
                "firing": len(firing),
                "firing_by_severity": by_sev,
                "pending": sum(1 for r in self.active.values()
                               if r["state"] == "pending"),
                "fired_total": self.fired_total,
                "resolved_total": self.resolved_total,
                "history": len(self.history),
            }


def _post_webhook(url: str, payload: dict) -> None:
    """Best-effort JSON POST (stdlib only, short timeout, all failures
    swallowed — a down receiver must cost one daemon thread, nothing
    else)."""
    try:
        from urllib.request import Request, urlopen

        req = Request(url, data=json.dumps(payload).encode(),
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=2.0):
            pass
    except Exception:
        pass
