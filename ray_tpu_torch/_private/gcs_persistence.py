"""Head state snapshot/restore + write-ahead log (GCS fault tolerance).

Counterpart of the reference's persistent GCS storage + restart recovery
(reference: gcs/store_client/redis_store_client.h:111 — Redis-backed
head tables; gcs/gcs_server/gcs_init_data.h — bulk-loading all tables on
GCS restart; gcs_redis_failure_detector.h). Design difference: instead
of an external Redis, a periodic snapshot FILE (atomic replace) plus an
append-only WAL of every durable-table mutation — the reference's Redis
writes each mutation as it happens; here each mutation appends one
framed op, so state created AFTER the last snapshot survives a kill -9.
Restart = load snapshot, replay WAL segments newer than it, then the
normal bulk restore. Snapshots compact the log: each snapshot rotates to
a fresh segment and prunes the ones it subsumes.

What persists: the KV store (which also carries serialized functions and
actor class blobs, so restarts can respawn actors), actor specs and
restart counters, the named-actor registry, placement-group specs, and
the head's node identity. What intentionally does NOT persist: object
store contents and directory (objects are lost on head failure; lineage
re-execution rebuilds what is re-requested), in-flight task state
(owners resubmit), and worker records (all worker processes die with
their head connection — the lease model)."""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from ray_tpu_torch._private.gcs import Head

FORMAT_VERSION = 1


def _frozen(obj: Any) -> Any:
    """Pickle-roundtrip copy: the payload must not alias live mutable
    head records (ActorSpec, pg.bundles), because the big pickle in
    write_blob runs OUTSIDE head.lock and a concurrent mutation (e.g.
    _h_kill_actor flipping spec.max_restarts) would tear the snapshot."""
    return pickle.loads(pickle.dumps(obj, protocol=5))


def build_payload(head: "Head") -> dict:
    """Serialize the durable tables into a picklable payload. Caller
    holds head.lock — keep this cheap; the disk write happens outside
    the lock (write_blob). Mutable records are copied here, under the
    lock; immutable values (KV bytes, id strings) are shared."""
    actors = []
    for actor_id, rec in head.actors.items():
        actors.append({
            "actor_id": actor_id,
            "spec": _frozen(rec.spec),
            "state": rec.state,
            "restarts": rec.restarts,
        })
    pgs = []
    for pg_id, pg in head.pgs.items():
        pgs.append({
            "pg_id": pg_id,
            "name": pg.name,
            "bundles": _frozen(pg.bundles),
            "strategy": pg.strategy,
        })
    return {
        "version": FORMAT_VERSION,
        "written_at": time.time(),
        "session_id": head.session_id,
        "node_id": head.node_id,
        "kv": dict(head.kv),
        "actors": actors,
        "named_actors": dict(head.named_actors),
        "pgs": pgs,
    }


def _as_store(path_or_store):
    """Accept a StoreClient or a legacy base path (kept for direct
    callers/tests; maps to a FileStoreClient with the historical
    <base>/<base>.wal.N layout)."""
    from ray_tpu_torch._private.gcs_store import FileStoreClient, StoreClient

    if isinstance(path_or_store, StoreClient):
        return path_or_store
    return FileStoreClient(os.path.dirname(os.path.abspath(path_or_store))
                           or ".", legacy_base=path_or_store)


def write_blob(payload: dict, store) -> None:
    """Atomic snapshot write (called WITHOUT head.lock: pickling +
    fsync of a many-MB KV under the lock would stall every RPC
    handler). ``store``: StoreClient or legacy base path."""
    _as_store(store).write_atomic("snapshot",
                                  pickle.dumps(payload, protocol=5))


class WriteAheadLog:
    """Append-only framed op log: ``<u32 len><u32 crc32><pickle(op)>``.

    Segment files live beside the snapshot (``{path}.wal.{seg}``). Each
    append is written + flushed, so ops survive a head kill -9 (page
    cache persists across process death; full-host durability would add
    fsync, deliberately not paid per-op). A torn final frame — the crash
    landed mid-append — is detected by length/CRC and dropped."""

    def __init__(self, base_path, seg: int = 0):
        self.store = _as_store(base_path)
        self.seg = seg
        self._f = None
        # Reopening after a crash: a frame torn mid-append would poison
        # every LATER append (readers stop at the first bad frame), so
        # truncate the segment to its valid prefix before appending.
        self._repair(self.store, self._seg_name(seg))
        self._open()

    @staticmethod
    def _seg_name(seg: int) -> str:
        return f"wal.{seg}"

    @staticmethod
    def _scan(data: bytes) -> "tuple[list, int]":
        """(decoded ops, length of the valid prefix). ONE validity rule
        shared by repair and replay: a frame counts only if its CRC
        matches AND it unpickles — a repair keeping frames that replay
        rejects would strand every op appended after them."""
        import struct
        import zlib

        ops: list = []
        pos = 0
        while pos + 8 <= len(data):
            ln, crc = struct.unpack_from("<II", data, pos)
            frame = data[pos + 8: pos + 8 + ln]
            if len(frame) < ln or zlib.crc32(frame) != crc:
                break
            try:
                ops.append(pickle.loads(frame))
            except Exception:
                break  # e.g. a zero-filled tail: ln=0/crc=0 is CRC-"valid"
            pos += 8 + ln
        return ops, pos

    @staticmethod
    def _repair(store, name: str) -> None:
        data = store.read(name)
        if data is None:
            return
        _, valid = WriteAheadLog._scan(data)
        if valid < len(data):
            store.rewrite(name, data[:valid])

    def _open(self) -> None:
        self._f = self.store.open_append(self._seg_name(self.seg))

    def append(self, op: tuple) -> None:
        import struct
        import zlib

        blob = pickle.dumps(op, protocol=5)
        self._f.write(struct.pack("<II", len(blob), zlib.crc32(blob)))
        self._f.write(blob)
        self._f.flush()

    def rotate(self) -> int:
        """Start a new segment; returns ITS number (ops appended from
        now land there — a snapshot built at this instant records it)."""
        self._f.close()
        self.seg += 1
        self._open()
        return self.seg

    def prune_below(self, seg: int) -> None:
        """Delete segments subsumed by a successfully written snapshot."""
        for s in WriteAheadLog.existing_segments(self.store):
            if s < seg:
                self.store.delete(self._seg_name(s))

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass

    @staticmethod
    def existing_segments(base_path) -> "list[int]":
        """Sorted segment numbers present in the store."""
        import re

        store = _as_store(base_path)
        segs = []
        for name in store.list("wal."):
            m = re.fullmatch(r"wal\.(\d+)", name)
            if m:
                segs.append(int(m.group(1)))
        return sorted(segs)

    @staticmethod
    def read_ops(base_path: str, from_seg: int) -> "tuple[list, int]":
        """All ops of on-disk segments >= from_seg in order, and the
        highest segment number present on disk at all (the restarted
        head appends after it — never below, or stale higher-numbered
        segments would later be reopened and their ancient ops replayed
        over newer state). Discovery is by directory listing, not by
        counting up from from_seg: if the snapshot is unreadable
        (from_seg falls back to 0) the pre-compaction segments are gone,
        and a contiguous walk from 0 would silently find nothing."""
        store = _as_store(base_path)
        segs = WriteAheadLog.existing_segments(store)
        last_seg = max(segs, default=from_seg)
        ops: list = []
        for seg in segs:
            if seg < from_seg:
                continue
            data = store.read(WriteAheadLog._seg_name(seg)) or b""
            seg_ops, _ = WriteAheadLog._scan(data)
            ops.extend(seg_ops)
        return ops, last_seg


def empty_payload() -> dict:
    """Skeleton payload for WAL-only recovery (head died before the
    first snapshot was ever written)."""
    return {"version": FORMAT_VERSION, "written_at": 0.0,
            "session_id": None, "node_id": None, "kv": {}, "actors": [],
            "named_actors": {}, "pgs": []}


def apply_ops(payload: dict, ops: list) -> dict:
    """Replay WAL ops INTO the snapshot payload (mutating it), so the
    single restore_into path below applies the combined state with its
    usual semantics (restart budgets, named-actor filtering, PG
    re-placement)."""
    actors = {e["actor_id"]: e for e in payload.get("actors", [])}
    pgs = {e["pg_id"]: e for e in payload.get("pgs", [])}
    for op in ops:
        kind = op[0]
        if kind == "kv_put":
            payload["kv"][(op[1], op[2])] = op[3]
        elif kind == "kv_del":
            payload["kv"].pop((op[1], op[2]), None)
        elif kind == "actor_create":
            spec = op[1]
            actors[spec.actor_id] = {
                "actor_id": spec.actor_id, "spec": spec,
                "state": "PENDING_CREATION", "restarts": 0,
            }
            if spec.name:
                payload["named_actors"][(spec.namespace, spec.name)] = (
                    spec.actor_id)
        elif kind == "actor_dead":
            e = actors.get(op[1])
            if e is not None:
                e["state"] = "DEAD"
                spec = e["spec"]
                if spec.name:
                    payload["named_actors"].pop(
                        (spec.namespace, spec.name), None)
        elif kind == "actor_restarts":
            e = actors.get(op[1])
            if e is not None:
                e["restarts"] = op[2]
        elif kind == "actor_max_restarts":
            e = actors.get(op[1])
            if e is not None:
                e["spec"].max_restarts = op[2]
        elif kind == "pg_create":
            pgs[op[1]] = {"pg_id": op[1], "name": op[2], "bundles": op[3],
                          "strategy": op[4]}
        elif kind == "pg_remove":
            pgs.pop(op[1], None)
    payload["actors"] = list(actors.values())
    payload["pgs"] = list(pgs.values())
    return payload


def load_snapshot(path) -> "dict | None":
    blob = _as_store(path).read("snapshot")
    if blob is None:
        return None
    try:
        payload = pickle.loads(blob)
    except (EOFError, pickle.UnpicklingError):
        return None
    if payload.get("version") != FORMAT_VERSION:
        return None
    return payload


def restore_into(head: "Head", payload: dict) -> dict:
    """Populate a fresh Head's tables from a snapshot (called during
    __init__, before the RPC server accepts connections — the analogue
    of GcsInitData's bulk load). Returns restore stats.

    Every worker process of the previous head epoch is gone (the head
    connection was their lease), so all snapshot actors are dead; the
    ones whose restart budget allows it are queued for restart exactly
    like worker-death restarts (reference: gcs_actor_manager.h:96
    max_restarts semantics — a head failover consumes one restart).
    """
    from ray_tpu_torch._private.gcs import ActorRecord, PlacementGroupRecord

    head.kv.update(payload.get("kv", {}))
    restored = skipped = 0
    restorable_ids = set()
    for entry in payload.get("actors", []):
        spec = entry["spec"]
        if entry["state"] == "DEAD":
            skipped += 1
            continue
        restarts = entry["restarts"] + 1
        if spec.max_restarts >= 0 and restarts > spec.max_restarts:
            skipped += 1
            continue
        rec = ActorRecord(spec)
        rec.restarts = restarts
        rec.state = "PENDING_CREATION"
        head.actors[entry["actor_id"]] = rec
        restorable_ids.add(entry["actor_id"])
        restored += 1
    for key, actor_id in payload.get("named_actors", {}).items():
        if actor_id in restorable_ids:
            head.named_actors[key] = actor_id
    for entry in payload.get("pgs", []):
        from ray_tpu_torch._private.gcs import ObjectEntry

        pg = PlacementGroupRecord(entry["pg_id"], entry["name"],
                                  entry["bundles"], entry["strategy"])
        head.pgs[entry["pg_id"]] = pg
        # Recreate the ready() object; placement itself retries when
        # nodes (re-)register and as the head's own resources free up.
        ready = ObjectEntry(entry["pg_id"] + ":ready", "head")
        ready.refcount = 1
        head.objects[entry["pg_id"] + ":ready"] = ready
        head._try_place_pg(pg)
    return {"actors_restored": restored, "actors_skipped": skipped,
            "kv_keys": len(payload.get("kv", {})),
            "pgs": len(payload.get("pgs", []))}
