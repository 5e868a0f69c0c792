"""Resource-view syncer: versioned replication of the cluster resource
view from the head to every node agent.

Reference analogue: ``src/ray/common/ray_syncer/ray_syncer.h:83`` — the
RESOURCE_VIEW sync protocol between raylets and the GCS (NodeState
components exchanging version-stamped snapshots, delta-only traffic,
periodic anti-entropy). There every raylet both reports its local view
and receives everyone else's because each raylet schedules locally;
here the head is already the single authority for grants (the dispatch
path debits/credits ``NodeEntry.available``), so the sync is
one-directional: the head publishes version-stamped deltas on the
existing pubsub plane and agents materialize an eventually-consistent
``ClusterView``.

Consumers:
- agent-local state queries — the agent's public transfer server
  answers ``cluster_view`` so ``ray status``-style reads on any node
  never touch the head (the reference serves these from each raylet's
  synced view);
- spillback candidate pre-filtering and head-failover warm state: the
  view survives at every agent across a head restart.

Wire protocol (one pubsub message per tick, nothing on quiet ticks)::

    {"seq": N,              # per-publisher monotonic message number
     "snapshot": bool,      # True => receivers replace their whole view
     "deltas": [ {node_id, address, alive, version, total, available,
                  labels} ],
     "removed": [node_id]}  # reaped nodes (on deltas only)

Per-node ``version`` bumps only when that node's state actually changed,
so receivers can discard stale reorderings; ``seq`` gaps are healed by
the periodic full snapshot (anti-entropy, like the reference's
snapshot-on-reconnect). Every message carries the publisher's ``pub``
id: a head restart starts a fresh publisher whose seq counter restarts
at 1, and receivers reset their seq cursor on a pub-id change instead
of discarding the new head's stream as stale."""

from __future__ import annotations

import os
import threading

TOPIC = "__resource_view__"


def _fingerprint(st: dict) -> tuple:
    return (st["alive"],
            tuple(sorted(st["total"].items())),
            tuple(sorted(st["available"].items())))


class ViewPublisher:
    """Head side: diff the scheduler's node table every tick, publish
    deltas to ``__resource_view__`` subscribers (node agents)."""

    def __init__(self, head, period_s: "float | None" = None):
        import uuid

        self.head = head
        self.pub_id = uuid.uuid4().hex[:12]
        self.period = period_s if period_s is not None else float(
            os.environ.get("RAY_TPU_RESOURCE_SYNC_PERIOD_S", "0.25"))
        # Clamped to >= 2: `tick % 1 == 1` is never true (no snapshot,
        # ever — anti-entropy off) and `tick % 0` raises.
        self.snapshot_every = max(2, int(
            os.environ.get("RAY_TPU_RESOURCE_SYNC_SNAPSHOT_TICKS", "40")))
        self._fingerprints: dict[str, tuple] = {}
        self._versions: dict[str, int] = {}
        self._seq = 0
        self._tick = 0
        self._lock = threading.Lock()  # collect() vs snapshot_for()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="resource-syncer")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------

    def _node_states(self) -> dict[str, dict]:
        with self.head.lock:
            return {
                nid: {
                    "node_id": n.node_id,
                    "address": n.address,
                    "alive": n.alive,
                    "total": n.total.to_dict(),
                    "available": n.available.to_dict(),
                    "labels": dict(n.labels),
                }
                for nid, n in self.head.scheduler.nodes.items()
            }

    def collect(self, snapshot: bool) -> "dict | None":
        """One tick's message, or None when nothing changed (and no
        snapshot is due)."""
        current = self._node_states()
        with self._lock:
            changed: list[dict] = []
            for nid, st in current.items():
                fp = _fingerprint(st)
                if self._fingerprints.get(nid) != fp:
                    self._fingerprints[nid] = fp
                    self._versions[nid] = self._versions.get(nid, 0) + 1
                    changed.append(st)
                st["version"] = self._versions[nid]
            removed = [nid for nid in self._fingerprints
                       if nid not in current]
            for nid in removed:
                self._fingerprints.pop(nid, None)
                self._versions.pop(nid, None)
            if not snapshot and not changed and not removed:
                return None
            self._seq += 1
            return {
                "pub": self.pub_id,
                "seq": self._seq,
                "snapshot": snapshot,
                "deltas": list(current.values()) if snapshot else changed,
                "removed": [] if snapshot else removed,
            }

    def broadcast_snapshot(self) -> None:
        """Full view to every subscriber. Used when a fresh subscriber
        appears (the reference sends a full snapshot on each new sync
        connection). Broadcast — not a private cast to the newcomer —
        because collect() folds any pending diffs into the snapshot's
        versions: a private send would mark those diffs as published
        while every existing subscriber never saw them."""
        msg = self.collect(snapshot=True)
        if msg is not None:
            self._publish(msg)

    def _publish(self, msg: dict) -> None:
        # One fan-out path: whatever delivery semantics _h_publish grows
        # (buffering, dead-subscriber pruning), the syncer inherits.
        self.head._h_publish({"topic": TOPIC, "data": msg}, None)

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            self._tick += 1
            # Tick 1 and every Nth tick: full snapshot (anti-entropy for
            # subscribers that missed deltas across head/agent hiccups).
            snapshot = (self._tick % self.snapshot_every) == 1
            try:
                msg = self.collect(snapshot)
            except Exception:
                continue  # scheduler table mid-mutation; next tick wins
            if msg is not None:
                self._publish(msg)


class ClusterView:
    """Agent side: the eventually-consistent materialized view."""

    def __init__(self):
        self.nodes: dict[str, dict] = {}
        self.last_seq = -1
        self.last_pub = None
        self.updates = 0
        self._lock = threading.Lock()

    def apply(self, data: dict) -> None:
        with self._lock:
            seq = int(data.get("seq", 0))
            pub = data.get("pub")
            if pub != self.last_pub:
                # New publisher incarnation (head restart): its seq
                # counter restarted, so reset the cursor — but only a
                # snapshot may switch epochs (deltas against a base this
                # view never saw would produce a frankenview).
                if not data.get("snapshot"):
                    return
                self.last_pub = pub
                self.last_seq = -1
            if seq <= self.last_seq:
                return  # stale replay (incl. a snapshot raced by a
                # newer delta: casts from the subscribe handler and the
                # publisher thread are not mutually ordered)
            if data.get("snapshot"):
                self.nodes = {d["node_id"]: d for d in data.get("deltas", [])}
                self.last_seq = seq
                self.updates += 1
                return
            for d in data.get("deltas", []):
                cur = self.nodes.get(d["node_id"])
                if cur is None or d.get("version", 0) >= cur.get("version", 0):
                    self.nodes[d["node_id"]] = d
            for nid in data.get("removed", []):
                self.nodes.pop(nid, None)
            self.last_seq = seq
            self.updates += 1

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "seq": self.last_seq,
                "updates": self.updates,
                "nodes": {nid: dict(st) for nid, st in self.nodes.items()},
            }

    def totals(self) -> dict:
        """Aggregate cluster totals/available over alive nodes — the
        head-free mirror of ``ray_tpu_torch.cluster_resources()``."""
        total: dict[str, float] = {}
        avail: dict[str, float] = {}
        with self._lock:
            for st in self.nodes.values():
                if not st.get("alive"):
                    continue
                for k, v in st["total"].items():
                    total[k] = total.get(k, 0.0) + v
                for k, v in st["available"].items():
                    avail[k] = avail.get(k, 0.0) + v
        return {"total": total, "available": avail}
