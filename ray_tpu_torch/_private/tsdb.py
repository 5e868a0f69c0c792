"""Embedded time-series store: bounded metric history on the head.

Every other metrics surface in the runtime is point-in-time —
``prometheus_text`` exposition, instantaneous ``runtime_stats``, the
Grafana bundle that presumes an external Prometheus nobody deploys.
This module retains history INSIDE the cluster so an operator (and the
alert engine, alertplane.py) can answer "what happened 10 minutes ago"
and "is p99 burning through the SLO" with zero third-party infra.

Cost contract (same as every observability plane): points
arrive EXCLUSIVELY from the already-amortized report casts (rpc_report,
agent heartbeats, report_metrics flushes) and from the head sampling
its own ``runtime_stats`` tables on the health tick — never a new
per-call head frame (guarded in tests/test_dispatch_fastpath.py).

Storage shape (a miniature Gorilla/Prometheus-TSDB, minus compression
— cluster metric volume is small enough that plain ring buffers win):

  * one ``_Series`` per (name, sorted-label-tuple) key, each holding
    TWO downsampling tiers of aggregate buckets:
      raw     ~10s resolution x 30min   (tsdb_raw_* knobs)
      rollup   1min resolution x 24h    (tsdb_rollup_* knobs)
    A bucket is [bucket_ts, min, max, sum, count, last] — enough to
    answer avg/min/max/last/rate without keeping raw samples.
  * the store is BOUNDED (tsdb_max_series): past the cap new keys fold
    into one ``(other series)`` catch-all and a dropped counter
    increments — a label flood must not melt the head (the classic
    self-inflicted monitoring outage rtlint RT-M002 exists to prevent).
  * under ``RAY_TPU_HEAD_SHARDS>1`` each shard keeps its own store;
    range queries fan out over the shard bus and merge, so no
    shard ships points to another except at query time.

Kill switch: ``RAY_TPU_TSDB_ENABLED=0`` — no store, no sampling, the
query surface answers empty.
"""

from __future__ import annotations

import os
import threading
from collections import deque

OTHER_SERIES = "(other series)"

# Bucket field indexes (list, not a class: these are allocated at
# sample rate and cross the wire verbatim in query replies).
TS, MIN, MAX, SUM, COUNT, LAST = range(6)


def enabled() -> bool:
    """The plane's kill switch (default ON — history is part of the
    always-on observability contract, like task events)."""
    return os.environ.get("RAY_TPU_TSDB_ENABLED", "1").lower() \
        not in ("0", "false", "no", "off")


def label_key(labels: "dict | None") -> tuple:
    """Canonical hashable label identity: sorted (k, v) tuple."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _matches(series_labels: tuple, want: "dict | None") -> bool:
    """Query label filter: subset match — every requested pair must be
    present on the series; extra series labels are fine."""
    if not want:
        return True
    have = dict(series_labels)
    return all(have.get(str(k)) == str(v) for k, v in want.items())


class _Tier:
    """One downsampling tier: a ring of aggregate buckets."""

    __slots__ = ("resolution_s", "buckets")

    def __init__(self, resolution_s: float, retention_s: float):
        self.resolution_s = max(1.0, float(resolution_s))
        n = max(2, int(retention_s / self.resolution_s))
        self.buckets: deque[list] = deque(maxlen=n)

    def add(self, ts: float, value: float) -> None:
        bts = int(ts // self.resolution_s) * self.resolution_s
        cur = self.buckets[-1] if self.buckets else None
        if cur is not None and cur[TS] == bts:
            if value < cur[MIN]:
                cur[MIN] = value
            if value > cur[MAX]:
                cur[MAX] = value
            cur[SUM] += value
            cur[COUNT] += 1
            cur[LAST] = value
        else:
            self.buckets.append([bts, value, value, value, 1, value])

    def range(self, start: float, end: float) -> list:
        return [b for b in self.buckets if start <= b[TS] <= end]


class _Series:
    __slots__ = ("name", "labels", "kind", "raw", "rollup", "points")

    def __init__(self, name: str, labels: tuple, kind: str, cfg):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.raw = _Tier(cfg.tsdb_raw_resolution_s,
                         cfg.tsdb_raw_retention_s)
        self.rollup = _Tier(cfg.tsdb_rollup_resolution_s,
                            cfg.tsdb_rollup_retention_s)
        self.points = 0  # lifetime ingested points

    def add(self, ts: float, value: float) -> None:
        self.raw.add(ts, value)
        self.rollup.add(ts, value)
        self.points += 1


def _coalesce(buckets: list, step: float) -> list:
    """Resample tier buckets to a coarser step (never finer — the data
    isn't there). Aggregates merge the same way the tiers build them."""
    out: list[list] = []
    for b in buckets:
        bts = int(b[TS] // step) * step
        cur = out[-1] if out else None
        if cur is not None and cur[TS] == bts:
            cur[MIN] = min(cur[MIN], b[MIN])
            cur[MAX] = max(cur[MAX], b[MAX])
            cur[SUM] += b[SUM]
            cur[COUNT] += b[COUNT]
            cur[LAST] = b[LAST]
        else:
            nb = list(b)
            nb[TS] = bts
            out.append(nb)
    return out


class SeriesStore:
    """The head-side store: bounded map of (name, labels) -> _Series.

    Thread-safe (its own lock, never the head's — ingest happens under
    self.lock in the head handlers, queries happen outside it)."""

    def __init__(self, config):
        self.config = config
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}
        self.dropped_total = 0     # points folded into (other series)
        self.ingested_total = 0

    # -- write side ----------------------------------------------------

    def ingest(self, name: str, labels: "dict | None", value,
               ts: float, kind: str = "gauge") -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        key = (name, label_key(labels))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= max(8, self.config.tsdb_max_series):
                    # Fold, don't drop silently: the catch-all series
                    # keeps the POINT VOLUME visible even when the key
                    # space exploded past the bound.
                    self.dropped_total += 1
                    key = (OTHER_SERIES, ())
                    s = self._series.get(key)
                    if s is None:
                        s = self._series[key] = _Series(
                            OTHER_SERIES, (), "gauge", self.config)
                else:
                    s = self._series[key] = _Series(
                        name, key[1], kind, self.config)
            s.add(ts, value)
            self.ingested_total += 1

    # -- read side -----------------------------------------------------

    def query(self, name: str, labels: "dict | None" = None,
              start: "float | None" = None, end: "float | None" = None,
              step: "float | None" = None, *,
              now: "float | None" = None) -> list:
        """Range query -> [{"name", "labels", "kind", "points"}].
        Points are [ts, min, max, sum, count, last] aggregate buckets.
        Tier choice: raw while the window fits raw retention (and the
        step doesn't ask coarser), else the 1min rollups."""
        import time as _time

        now = now if now is not None else _time.time()
        end = end if end is not None else now
        start = start if start is not None else \
            end - self.config.tsdb_raw_retention_s
        out = []
        with self._lock:
            raw_floor = now - self.config.tsdb_raw_retention_s
            for (n, lk), s in self._series.items():
                if n != name or not _matches(lk, labels):
                    continue
                use_rollup = start < raw_floor or (
                    step is not None
                    and step >= s.rollup.resolution_s)
                tier = s.rollup if use_rollup else s.raw
                pts = [list(b) for b in tier.range(start, end)]
                if step is not None and step > tier.resolution_s:
                    pts = _coalesce(pts, float(step))
                out.append({
                    "name": s.name, "labels": dict(lk),
                    "kind": s.kind, "resolution_s": tier.resolution_s,
                    "points": pts,
                })
        out.sort(key=lambda r: sorted(r["labels"].items()))
        return out

    def latest(self, name: str, labels: "dict | None" = None):
        """Most recent sample value across matching series (None when
        nothing matched)."""
        best_ts, best = None, None
        with self._lock:
            for (n, lk), s in self._series.items():
                if n != name or not _matches(lk, labels):
                    continue
                if s.raw.buckets:
                    b = s.raw.buckets[-1]
                    if best_ts is None or b[TS] > best_ts:
                        best_ts, best = b[TS], b[LAST]
        return best

    def names(self) -> list:
        with self._lock:
            return sorted({n for (n, _lk) in self._series})

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "points": sum(
                    len(s.raw.buckets) + len(s.rollup.buckets)
                    for s in self._series.values()),
                "ingested_total": self.ingested_total,
                "dropped_total": self.dropped_total,
            }


# ----------------------------------------------------------------------
# window algebra (shared by the alert engine, the CLI, and tests) —
# pure functions over the query() reply shape.

def window_points(result: list, start: float, end: float) -> list:
    """Flatten a query() reply to time-ordered buckets in [start, end],
    merging multi-series replies (label-summed view)."""
    pts = [b for r in result for b in r["points"]
           if start <= b[TS] <= end]
    pts.sort(key=lambda b: b[TS])
    return pts


def agg_over(points: list, agg: str) -> "float | None":
    """Aggregate a bucket list: avg (count-weighted), min, max, last,
    sum, or rate (per-second slope of a cumulative counter, summed
    across interleaved series via first/last-bucket deltas)."""
    if not points:
        return None
    if agg == "avg":
        total = sum(b[SUM] for b in points)
        count = sum(b[COUNT] for b in points)
        return total / count if count else None
    if agg == "min":
        return min(b[MIN] for b in points)
    if agg == "max":
        return max(b[MAX] for b in points)
    if agg == "last":
        return points[-1][LAST]
    if agg == "sum":
        return sum(b[SUM] for b in points)
    if agg == "rate":
        if len(points) < 2:
            return 0.0
        dt = points[-1][TS] - points[0][TS]
        if dt <= 0:
            return 0.0
        return max(0.0, points[-1][LAST] - points[0][LAST]) / dt
    raise ValueError(f"unknown agg {agg!r}")
