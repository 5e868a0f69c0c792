"""Owner-side object reference census: callsite-attributed accounting
of every live ObjectRef this runtime owns.

Counterpart of the reference's per-worker reference table behind `ray
memory` (reference: src/ray/core_worker/reference_count.h:72 — each
CoreWorker tracks its owned refs with the Python callsite recorded at
creation, and the debugging tool aggregates them cluster-wide via
`ray memory` / memory_summary, _private/internal_api.py). Here the
owner half lives beside CoreRuntime:

  * creation callsite — the first user frame above the ray_tpu_torch package,
    captured at put()/.remote() time and INTERNED by (code object,
    lineno): the hot path pays one dict lookup after the first call
    from a given line, not a stack walk.
  * per-ref record — callsite, kind (put/inline/shm/p2p for puts,
    return/return_direct for task results), size (stamped when the
    seal lands on the owner plane), created_at, awaited bit.
  * bounded summary — grouped by callsite, shipped to the head
    PIGGYBACKED on the existing amortized rpc_report cast (zero new
    per-call head frames; the guard contract). The head
    merges these with its ObjectEntry directory into the cluster-wide
    `ray-tpu memory` view and feeds the leak detector's trend windows.

Disable with RAY_TPU_OBJECT_CENSUS_ENABLED=0 (the microbenchmark's
census on/off op measures the delta — a stack walk per NEW callsite,
a dict write per object otherwise).
"""

from __future__ import annotations

import os
import sys
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Interned callsites: (code object, lineno) -> "file:line:function".
# Code objects are immortal for the life of their function; a bounded
# sweep guards against pathological exec()-generated code churn.
_callsite_cache: dict = {}
# code object -> is it OUTSIDE the ray_tpu_torch package (per-code verdict
# cache: the walk's startswith() on a long path is ~3x a dict hit).
_code_external: dict = {}
_CALLSITE_CACHE_MAX = 4096

UNKNOWN = "(unknown callsite)"


def callsite(depth: int = 2) -> str:
    """The first stack frame OUTSIDE the ray_tpu_torch package, rendered as
    ``file:line:function`` and interned. ``depth`` skips the census's
    own callers so the common case (user code -> api.put -> runtime)
    resolves in one or two frame hops. Steady state per call: one
    _getframe, a few per-code dict hits, one interned-string lookup."""
    try:
        f = sys._getframe(depth)
    except ValueError:
        return UNKNOWN
    ext_cache = _code_external
    while f is not None:
        code = f.f_code
        ext = ext_cache.get(code)
        if ext is None:
            if len(ext_cache) >= _CALLSITE_CACHE_MAX:
                ext_cache.clear()
            ext = ext_cache[code] = \
                not code.co_filename.startswith(_PKG_DIR)
        if ext:
            key = (code, f.f_lineno)
            site = _callsite_cache.get(key)
            if site is None:
                if len(_callsite_cache) >= _CALLSITE_CACHE_MAX:
                    _callsite_cache.clear()
                site = f"{code.co_filename}:{f.f_lineno}:{code.co_name}"
                _callsite_cache[key] = site
            return site
        f = f.f_back
    return UNKNOWN


class OwnerCensus:
    """Per-runtime table of live owned refs. Hot-path mutators
    (record/release/update) are single dict operations — GIL-atomic,
    so they take NO lock (callers include the submit hot path and the
    __del__-driven release flusher; at flood rates two lock hops per
    task were a measurable slice of the submit budget). summary()
    snapshots the table with one atomic list() instead of holding a
    lock against writers; the bound/dropped counters are best-effort
    under concurrency, which observability can afford."""

    __slots__ = ("_lock", "_by_oid", "_max", "dropped", "_released_bytes")

    # record layout: [callsite, kind, size, created_at, awaited, direct]
    def __init__(self, max_entries: int = 100_000):
        self._lock = threading.Lock()  # summary-vs-summary only
        self._by_oid: dict[str, list] = {}
        self._max = max(1, int(max_entries))
        self.dropped = 0        # records not tracked (table full)
        self._released_bytes = 0  # lifetime bytes released (trend aid)

    def record(self, oid: str, kind: str, size: int = 0,
               site: "str | None" = None) -> None:
        by_oid = self._by_oid
        if len(by_oid) >= self._max and oid not in by_oid:
            self.dropped += 1
            return
        by_oid[oid] = [site or UNKNOWN, kind, size, time.time(), False,
                       False]

    def record_many(self, oids, kind: str, site: "str | None" = None,
                    ) -> None:
        site = site or UNKNOWN
        now = time.time()
        by_oid, cap = self._by_oid, self._max
        for oid in oids:
            if len(by_oid) >= cap and oid not in by_oid:
                self.dropped += 1
                continue
            by_oid[oid] = [site, kind, 0, now, False, False]

    def update_size(self, oid: str, size: int) -> None:
        rec = self._by_oid.get(oid)
        if rec is not None:
            rec[2] = size

    def mark_awaited(self, oids) -> None:
        for oid in oids:
            rec = self._by_oid.get(oid)
            if rec is not None:
                rec[4] = True

    def mark_direct(self, oids) -> None:
        """Direct-plane dispatch flag: the task producing these return
        ids went owner→worker without a head hop (direct.py)."""
        for oid in oids:
            rec = self._by_oid.get(oid)
            if rec is not None:
                rec[5] = True

    def release(self, oid: str) -> None:
        rec = self._by_oid.pop(oid, None)
        if rec is not None:
            self._released_bytes += rec[2]

    def __len__(self) -> int:
        return len(self._by_oid)

    def get(self, oid: str) -> "dict | None":
        rec = self._by_oid.get(oid)
        if rec is None:
            return None
        return {"callsite": rec[0], "kind": rec[1], "size": rec[2],
                "created_at": rec[3], "awaited": rec[4],
                "direct": rec[5]}

    def summary(self, max_groups: int = 64,
                sample_ids: int = 8) -> dict:
        """Bounded per-callsite aggregation for the rpc_report
        piggyback. Groups beyond ``max_groups`` (by live bytes) fold
        into one ``(other callsites)`` bucket so a pathological caller
        can't bloat the report."""
        now = time.time()
        groups: dict[str, dict] = {}
        with self._lock:
            # One C-level list() is atomic under the GIL: a consistent
            # snapshot without blocking concurrent record/release.
            snapshot = list(self._by_oid.items())
        total_bytes = 0
        for oid, (site, kind, size, created, awaited, direct) in \
                snapshot:
            g = groups.get(site)
            if g is None:
                g = groups[site] = {
                    "count": 0, "bytes": 0, "kinds": {},
                    "oldest_age_s": 0.0, "unawaited": 0,
                    "sample_ids": []}
            g["count"] += 1
            g["bytes"] += size
            total_bytes += size
            k = kind + ("+direct" if direct else "")
            g["kinds"][k] = g["kinds"].get(k, 0) + 1
            g["oldest_age_s"] = max(g["oldest_age_s"],
                                    round(now - created, 1))
            if not awaited:
                g["unawaited"] += 1
            if len(g["sample_ids"]) < sample_ids:
                g["sample_ids"].append(oid)
        live = len(snapshot)
        ranked = sorted(groups.items(),
                        key=lambda kv: (kv[1]["bytes"], kv[1]["count"]),
                        reverse=True)
        if len(ranked) > max_groups:
            head, tail = ranked[:max_groups], ranked[max_groups:]
            other = {"count": 0, "bytes": 0, "kinds": {},
                     "oldest_age_s": 0.0, "unawaited": 0,
                     "sample_ids": []}
            for _site, g in tail:
                other["count"] += g["count"]
                other["bytes"] += g["bytes"]
                other["unawaited"] += g["unawaited"]
                other["oldest_age_s"] = max(other["oldest_age_s"],
                                            g["oldest_age_s"])
            ranked = head + [("(other callsites)", other)]
        return {
            "groups": {site: g for site, g in ranked},
            "live_objects": live,
            "live_bytes": total_bytes,
            "released_bytes": self._released_bytes,
            "dropped": self.dropped,
        }
