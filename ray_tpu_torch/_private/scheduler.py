"""Cluster resource model and scheduling policies.

Counterpart of the reference's scheduler stack (reference:
src/ray/common/scheduling/cluster_resource_data.h:36,290 — ResourceRequest /
NodeResources with fixed-point arithmetic; policy implementations under
src/ray/raylet/scheduling/policy/: hybrid_scheduling_policy.h:50,
bundle_scheduling_policy.h, composite_scheduling_policy.h:33).

Resources are arbitrary named floats (CPU, TPU, memory, custom markers like
``TPU-v4-16-head``). Fixed-point at 1e-4 granularity avoids float drift when
fractional resources are repeatedly acquired/returned — same motivation as
the reference's FixedPoint (fixed_point.h).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

GRANULARITY = 10000  # 1e-4 units


def _round4(x: float) -> int:
    """Deterministic 4-decimal utilization rounding shared with the C++
    core (scheduler.cc Round4): floor(x·1e4 + 0.5) over the SAME double
    math on both sides — Python's round() (decimal, half-even) and C++
    std::round (half-away) disagree on edge values."""
    import math

    return math.floor(x * 10000.0 + 0.5)


def _fnv1a(s: str) -> int:
    """64-bit FNV-1a — the deterministic SPREAD tie-break hash, identical
    in scheduler.cc."""
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def shard_gpu_range(n: int, index: int, total: int) -> tuple[int, int]:
    """The device indices [lo, hi) of shard ``index``'s contiguous slice
    of a node's ``n`` GPUs: disjoint across shards, together all ``n``."""
    return (n * index) // total, (n * (index + 1)) // total


def split_shard_resources(base: dict, index: int, total: int) -> dict:
    """One head shard's slice of the box (sharded head,
    head_shards.py): CPUs floor-divided with the remainder to the low
    shard indexes (never below 1 — a shard must be able to run a
    worker), TPU chips partitioned contiguously so no chip is visible
    from two shards, custom resources divided evenly. node:* keys are
    dropped — each shard's Head mints its own node identity."""
    out: dict = {}
    for key, val in (base or {}).items():
        if key.startswith("node:"):
            continue
        if key == "CPU":
            n = int(val)
            share = n // total + (1 if index < n % total else 0)
            out["CPU"] = float(max(1, share))
        elif key == "GPU":
            lo, hi = shard_gpu_range(int(val), index, total)
            if hi > lo:
                out["GPU"] = float(hi - lo)
        elif key == "memory":
            out["memory"] = float(val) / total
        else:
            out[key] = float(val) / total
    return out


def _fp(v: float) -> int:
    return round(v * GRANULARITY)


def _unfp(v: int) -> float:
    return v / GRANULARITY


class ResourceSet:
    """A bag of named fixed-point resource quantities."""

    __slots__ = ("_r",)

    def __init__(self, resources: dict[str, float] | None = None):
        self._r: dict[str, int] = {k: _fp(v) for k, v in (resources or {}).items() if _fp(v) != 0}

    @classmethod
    def _raw(cls, r: dict[str, int]) -> "ResourceSet":
        rs = cls()
        rs._r = {k: v for k, v in r.items() if v != 0}
        return rs

    def to_dict(self) -> dict[str, float]:
        return {k: _unfp(v) for k, v in self._r.items()}

    def get(self, name: str) -> float:
        return _unfp(self._r.get(name, 0))

    def is_empty(self) -> bool:
        return not self._r

    def fits(self, other: "ResourceSet") -> bool:
        """True if `other` (a demand) fits within self (availability)."""
        return all(self._r.get(k, 0) >= v for k, v in other._r.items())

    def subtract(self, other: "ResourceSet") -> None:
        for k, v in other._r.items():
            self._r[k] = self._r.get(k, 0) - v
            if self._r[k] == 0:
                del self._r[k]

    def add(self, other: "ResourceSet") -> None:
        for k, v in other._r.items():
            self._r[k] = self._r.get(k, 0) + v
            if self._r[k] == 0:
                del self._r[k]

    def copy(self) -> "ResourceSet":
        return ResourceSet._raw(dict(self._r))

    def keys(self) -> Iterable[str]:
        return self._r.keys()

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


@dataclasses.dataclass
class NodeEntry:
    node_id: str
    address: str
    total: ResourceSet
    available: ResourceSet
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)

    def utilization(self) -> float:
        """Max over resource kinds of used/total — the hybrid policy's score."""
        best = 0.0
        for k in self.total.keys():
            tot = self.total.get(k)
            if tot <= 0:
                continue
            used = tot - self.available.get(k)
            best = max(best, used / tot)
        return best


# --- scheduling strategies (user-facing mirrors util/scheduling_strategies) ---


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a node (reference: util/scheduling_strategies.py NodeAffinity)."""

    node_id: str
    soft: bool = False


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object  # PlacementGroup handle
    placement_group_bundle_index: int = -1


# Label match expressions (reference: util/scheduling_strategies.py
# In/NotIn/Exists/DoesNotExist for NodeLabelSchedulingStrategy).


class In:
    def __init__(self, *values):
        self.values = set(values)

    def matches(self, v) -> bool:
        return v is not None and v in self.values


class NotIn:
    def __init__(self, *values):
        self.values = set(values)

    def matches(self, v) -> bool:
        return v is not None and v not in self.values


class Exists:
    def matches(self, v) -> bool:
        return v is not None


class DoesNotExist:
    def matches(self, v) -> bool:
        return v is None


def _labels_match(labels: dict, conditions: dict) -> bool:
    for key, expr in (conditions or {}).items():
        v = labels.get(key)
        if hasattr(expr, "matches"):
            if not expr.matches(v):
                return False
        elif v != expr:  # plain value = equality
            return False
    return True


@dataclasses.dataclass
class NodeLabelSchedulingStrategy:
    """Schedule onto nodes by label (reference:
    util/scheduling_strategies.py:135). ``hard`` conditions filter
    candidate nodes; ``soft`` conditions are preferred but not required.
    Values may be plain strings (equality) or In/NotIn/Exists/
    DoesNotExist expressions."""

    hard: dict
    soft: dict | None = None


class ClusterScheduler:
    """Picks a node for each resource demand.

    Policy composition mirrors the reference's CompositeSchedulingPolicy:
    "DEFAULT" = hybrid pack-until-threshold-then-spread
    (hybrid_scheduling_policy.h:50), "SPREAD" = least-utilized round robin,
    node affinity, and placement-group bundle placement with
    PACK/SPREAD/STRICT_PACK/STRICT_SPREAD (bundle_scheduling_policy.h).
    """

    def __init__(self, spread_threshold: float = 0.5):
        self.nodes: dict[str, NodeEntry] = {}
        self.spread_threshold = spread_threshold
        self._rr_counter = 0
        # C++ scheduler core (src/scheduler/scheduler.cc): membership and
        # acquire/release are mirrored; the hybrid/SPREAD pick runs native
        # (reference: the decision lives in C++ ClusterResourceScheduler,
        # cluster_resource_scheduler.h:46). Absent the .so, the pure-Python
        # path below is authoritative.
        self._native = None
        try:
            from ray_tpu_torch._private.native_sched import NativeScheduler, available

            if available():
                self._native = NativeScheduler(spread_threshold)
        except Exception:
            self._native = None

    # --- membership ---

    def add_node(self, node: NodeEntry) -> None:
        self.nodes[node.node_id] = node
        if self._native is not None:
            self._native.add_node(
                node.node_id, node.total.to_dict(), node.available.to_dict()
            )

    def remove_node(self, node_id: str) -> None:
        self.nodes.pop(node_id, None)
        if self._native is not None:
            self._native.remove_node(node_id)

    def mark_dead(self, node_id: str) -> None:
        node = self.nodes.get(node_id)
        if node is not None:
            node.alive = False
        if self._native is not None:
            self._native.set_alive(node_id, False)

    def alive_nodes(self) -> list[NodeEntry]:
        return [n for n in self.nodes.values() if n.alive]

    # --- selection ---

    def pick_node(self, demand: ResourceSet, strategy=None,
                  exclude=None) -> NodeEntry | None:
        """``exclude``: node ids that must not receive placements right
        now (memory-pressured nodes, overload-protection plane). Hard
        affinity to an excluded node waits rather than mis-placing."""
        nodes = self.alive_nodes()
        if exclude:
            nodes = [n for n in nodes if n.node_id not in exclude]
        if not nodes:
            return None
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            node = self.nodes.get(strategy.node_id)
            if exclude and strategy.node_id in exclude:
                node = None
            if node is not None and node.alive and node.available.fits(demand):
                return node
            if not strategy.soft:
                return None
            # fall through to default policy
        if isinstance(strategy, NodeLabelSchedulingStrategy):
            hard = [n for n in nodes
                    if _labels_match(n.labels, strategy.hard)
                    and n.available.fits(demand)]
            if not hard:
                return None
            soft = [n for n in hard
                    if _labels_match(n.labels, strategy.soft or {})]
            pool = soft or hard
            # Hybrid tie-break within the labeled pool.
            below = [n for n in pool
                     if n.utilization() < self.spread_threshold]
            if below:
                return max(below, key=lambda n: (_round4(n.utilization()),
                                                 n.node_id))
            return min(pool, key=lambda n: (_round4(n.utilization()),
                                            n.node_id))
        if self._native is not None and not exclude:
            # The C++ core has no exclusion filter; pressured-node
            # passes take the (rare) Python path below instead.
            picked = self._native.pick_node(
                demand.to_dict(), spread=strategy == "SPREAD"
            )
            return self.nodes.get(picked) if picked is not None else None
        feasible = [n for n in nodes if n.total.fits(demand)]
        available = [n for n in feasible if n.available.fits(demand)]
        if not available:
            return None
        if strategy == "SPREAD":
            # Least utilized first, deterministic round-robin tiebreak.
            # FNV-1a (not Python's randomized str hash) so the C++ core
            # makes bit-identical picks (scheduler.cc).
            self._rr_counter += 1
            return min(
                available,
                key=lambda n: (_round4(n.utilization()),
                               (_fnv1a(n.node_id) + self._rr_counter) % len(available)),
            )
        # hybrid: among nodes below the utilization threshold, pack onto the
        # most utilized (minimize fragmentation); else spread to least.
        below = [n for n in available if n.utilization() < self.spread_threshold]
        if below:
            return max(below, key=lambda n: (_round4(n.utilization()), n.node_id))
        return min(available, key=lambda n: (_round4(n.utilization()), n.node_id))

    def acquire(self, node_id: str, demand: ResourceSet) -> bool:
        node = self.nodes.get(node_id)
        if node is None or not node.available.fits(demand):
            return False
        node.available.subtract(demand)
        if self._native is not None:
            self._native.acquire(node_id, demand.to_dict())
        return True

    def release(self, node_id: str, demand: ResourceSet) -> None:
        node = self.nodes.get(node_id)
        if node is not None:
            node.available.add(demand)
            if self._native is not None:
                self._native.release(node_id, demand.to_dict())

    # --- placement groups ---

    def place_bundles(
        self, bundles: list[dict[str, float]], policy: str
    ) -> list[str] | None:
        """Returns a node id per bundle, or None if infeasible now.

        All-or-nothing (gang) placement — the caller reserves atomically,
        mirroring the 2PC prepare/commit of the reference's
        GcsPlacementGroupScheduler (gcs_placement_group_scheduler.h).
        """
        demands = [ResourceSet(b) for b in bundles]
        # Work on a scratch copy of availability for atomicity.
        scratch = {n.node_id: n.available.copy() for n in self.alive_nodes()}
        placement: list[str] = []

        def nodes_by_util():
            return sorted(self.alive_nodes(), key=lambda n: n.utilization())

        if policy in ("STRICT_PACK",):
            for node in self.alive_nodes():
                avail = scratch[node.node_id].copy()
                if all(self._take(avail, d) for d in demands):
                    return [node.node_id] * len(demands)
            return None
        if policy in ("STRICT_SPREAD",):
            nodes = nodes_by_util()
            if len(nodes) < len(demands):
                return None
            used: set[str] = set()
            for d in demands:
                pick = next(
                    (n for n in nodes if n.node_id not in used and scratch[n.node_id].fits(d)),
                    None,
                )
                if pick is None:
                    return None
                used.add(pick.node_id)
                scratch[pick.node_id].subtract(d)
                placement.append(pick.node_id)
            return placement
        # PACK (best effort pack) / SPREAD (best effort spread)
        prefer_pack = policy == "PACK"
        for d in demands:
            candidates = [n for n in self.alive_nodes() if scratch[n.node_id].fits(d)]
            if not candidates:
                return None
            if prefer_pack:
                # Prefer nodes already used by this group, then most-utilized.
                pick = min(
                    candidates,
                    key=lambda n: (n.node_id not in placement, -n.utilization(), n.node_id),
                )
            else:
                pick = min(
                    candidates,
                    key=lambda n: (placement.count(n.node_id), n.utilization(), n.node_id),
                )
            scratch[pick.node_id].subtract(d)
            placement.append(pick.node_id)
        return placement

    @staticmethod
    def _take(avail: ResourceSet, d: ResourceSet) -> bool:
        if avail.fits(d):
            avail.subtract(d)
            return True
        return False
