"""Node agent: joins a cluster and forks workers on this machine.

Counterpart of the reference's raylet daemon role (SURVEY.md §1 L1 —
NodeManager raylet/node_manager.h:123: per-node worker pool + resource
reporting; here scheduling stays centralized in the head, so the agent is
the worker-pool half only). The TCP session to the head is the node's
lease: the connection dropping IS node death (reference: GCS health
checks, gcs_health_check_manager.h:45).

Start via CLI: ``ray-tpu start --address <head_host:port>``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
from collections import deque

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import GLOBAL_CONFIG


def _host_id() -> str:
    from ray_tpu_torch._private import dataplane

    return dataplane.host_id()


def _sys_sample() -> dict:
    """Node-health gauges for the heartbeat's telemetry piggyback:
    1-minute load average plus /proc/meminfo available/total. Cheap
    (two syscalls, one small read), best-effort (an exotic platform
    just omits the field)."""
    out: dict = {}
    try:
        out["load1"] = round(os.getloadavg()[0], 3)
    except (OSError, AttributeError):
        pass
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    out["mem_total_bytes"] = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    out["mem_available_bytes"] = \
                        int(line.split()[1]) * 1024
                if len(out) >= 3:
                    break
    except OSError:
        pass
    return out


class _ZygotePid:
    """Popen-shaped handle for a worker forked by the node's zygote
    (the zygote is the OS parent and auto-reaps; this handle can only
    signal and poll liveness)."""

    def __init__(self, pid: int):
        self.pid = pid

    def poll(self):
        try:
            os.kill(self.pid, 0)
            return None
        except OSError:
            return 0

    def send_signal(self, signum: int) -> None:
        os.kill(self.pid, signum)

    def terminate(self) -> None:
        try:
            os.kill(self.pid, 15)
        except OSError:
            pass

    def kill(self) -> None:
        try:
            os.kill(self.pid, 9)
        except OSError:
            pass

    def wait(self, timeout: "float | None" = None):
        import time as _time

        deadline = None if timeout is None else _time.time() + timeout
        while self.poll() is None:
            if deadline is not None and _time.time() > deadline:
                raise subprocess.TimeoutExpired("zygote-child", timeout)
            _time.sleep(0.02)
        return 0


class NodeAgent:
    def __init__(
        self,
        head_address: tuple[str, int],
        *,
        num_cpus: float | None = None,
        num_gpus: float | None = None,
        resources: dict | None = None,
        labels: dict | None = None,
        node_id: str | None = None,
        force_remote_objects: bool = False,
    ):
        self.head_address = head_address
        self.force_remote_objects = force_remote_objects
        self.procs: dict[str, subprocess.Popen] = {}
        self._exit = threading.Event()
        self._labels = labels or {}
        self._resources = self._detect_resources(num_cpus, num_gpus, resources)
        # Synced cluster resource view (reference: ray_syncer.h:83 —
        # each raylet holds everyone's versioned resource view). Built
        # before any server starts so cluster_view queries never race
        # construction; populated once registration subscribes.
        from ray_tpu_torch._private.resource_syncer import TOPIC, ClusterView

        self.cluster_view = ClusterView()
        self._view_topic = TOPIC
        # --- node-local object store + P2P transfer server (reference:
        # per-node plasma store + chunked push/pull, push_manager.h:32 /
        # pull_manager.h:57). Large objects created on this node live in
        # THIS arena; the head keeps only the directory entry, and other
        # nodes pull chunks straight from here — bytes never traverse
        # the head. ---
        import uuid as _uuid

        from ray_tpu_torch._private.shm_store import ShmArena

        self.store_name = f"/ray_tpu_torch_agent_{_uuid.uuid4().hex[:10]}"
        self.store_capacity = GLOBAL_CONFIG.agent_object_store_memory
        self.store = ShmArena(self.store_name, self.store_capacity)
        self.local_objects: dict[str, tuple[int, int]] = {}  # id -> (off, size)
        self._store_lock = threading.Lock()
        # Raw-socket bulk plane for payload pulls (reference:
        # push_manager.h chunked transfer); the rpc transfer server
        # keeps the control ops (alloc/seal/abort) and stays as the
        # legacy pull fallback. Reads pin the object so a concurrent
        # free cannot recycle the region mid-send.
        self._pull_pins: dict[str, int] = {}
        self._pending_free: set[str] = set()
        from ray_tpu_torch._private.bulk_transfer import BulkServer

        self.bulk_server = BulkServer(self._bulk_read)
        self.transfer_server = rpc.Server(self._transfer_handle,
                                          host="0.0.0.0", port=0)
        from ray_tpu_torch._private.retry import default_policy

        self._retry_policy = default_policy()
        self.conn = rpc.connect(
            head_address,
            handler=self._handle,
            name="node_agent",
            on_close=self._on_head_lost,
            retry=self._retry_policy,
        )
        # Registration is idempotent (re-join with the same node_id is a
        # supported path), so it rides the unified retry policy: under
        # injected faults a dropped register frame backs off and
        # resends instead of killing the agent at boot.
        reply = self.conn.call(
            "register_node",
            {
                "node_id": node_id,
                "resources": self._resources,
                "labels": self._labels,
                "address": socket.gethostname(),
                "transfer_port": self.transfer_server.address[1],
                "bulk_port": self.bulk_server.address[1],
                "store_name": self.store_name,
                "store_capacity": self.store_capacity,
                "host_id": _host_id(),
            },
            timeout=GLOBAL_CONFIG.worker_register_timeout_s,
            retry=self._retry_policy,
        )
        self.node_id = reply["node_id"]
        self.session_dir = reply["session_dir"]
        # Sharded head: the router minted our node_id for the shard that
        # owns us; remember which for diagnostics/census labelling.
        self.head_shard = int(reply.get("shard", 0))
        self.head_shards = int(reply.get("head_shards", 1))
        # Per-node worker log + crash-forensics dir: workers arm their
        # crash file/beacon here (RAY_TPU_CRASH_DIR at spawn) and the
        # reaper reads the evidence post-mortem.
        self.log_dir = os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch_agent",
            self.node_id, "logs")
        os.makedirs(self.log_dir, exist_ok=True)
        # Continuous profiling plane: the agent samples its own service
        # threads (reap/mem-watch/pull server) from boot; window
        # summaries piggyback on agent_heartbeat. Armed after
        # registration so the role is tagged with the minted node_id.
        from ray_tpu_torch._private import profplane

        profplane.arm("agent", self.node_id)
        # Subscribe to the resource-view sync stream: triggers an
        # immediate full snapshot from the head; deltas stream in as
        # pubsub casts handled in _handle.
        try:
            self.conn.call("subscribe", {"topic": self._view_topic},
                           timeout=10)
        except rpc.RpcError:
            pass  # older head without the syncer; view stays empty
        # OOM protection for THIS node: the agent watches local memory and
        # reports pressure; the head (which owns the worker/task tables and
        # the retriable-first policy) picks and kills a victim scoped to
        # this node (reference: per-raylet MemoryMonitor, memory_monitor.h).
        self._mem_thread = threading.Thread(
            target=self._memory_watch, daemon=True, name="agent-mem-watch"
        )
        self._mem_thread.start()
        # Liveness beacon (reference: raylet->GCS heartbeats feeding
        # gcs_health_check_manager.h:45): lets the head declare this
        # node dead after the health grace even when the TCP session
        # stays technically open (partition, injected drop).
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name="agent-heartbeat").start()
        # Crash forensics: reap real exit statuses of this node's
        # workers, classify them (forensics.py), and ship a bounded
        # crash report to the head with the worker_death cast
        # (reference: the raylet reporting WorkerExitType + exit_detail
        # through the GCS death path).
        threading.Thread(target=self._reap_loop, daemon=True,
                         name="agent-reaper").start()

    def _reap_loop(self) -> None:
        from ray_tpu_torch._private import forensics
        from ray_tpu_torch._private.cgroup import CgroupSetup

        cg = CgroupSetup.get_or_create(self, self.node_id)
        oom = forensics.OomWatch(
            (os.path.join(cg.workers_path, "memory.events"),)
            if cg.enabled and cg.workers_path else ())
        while not self._exit.wait(0.2):
            dead = [(wid, proc) for wid, proc in list(self.procs.items())
                    if proc.poll() is not None]
            for wid, proc in dead:
                if self.procs.get(wid) is proc:
                    self.procs.pop(wid, None)
                try:
                    self._report_worker_death(wid, proc, oom)
                except Exception:
                    pass
                try:
                    cg.remove_worker(proc.pid)
                except Exception:
                    pass

    def _report_worker_death(self, worker_id: str, proc, oom) -> None:
        from ray_tpu_torch._private import forensics

        exit_code = term_signal = None
        if isinstance(proc, _ZygotePid):
            # Forked from the node zygote: the zygote is the OS parent
            # and recorded the waitpid status in its exit file.
            zy = getattr(self, "_zygote", None)
            if zy is not None:
                status = zy.exit_status(proc.pid, wait_s=0.5)
                exit_code, term_signal = forensics.split_status(status)
        else:
            rc = proc.returncode
            if rc is not None:
                exit_code, term_signal = (rc, None) if rc >= 0 else \
                    (None, -rc)
        report = forensics.collect_report(
            worker_id, self.node_id, proc.pid,
            exit_code=exit_code, term_signal=term_signal,
            crash_dir=self.log_dir,
            log_path=os.path.join(self.log_dir, f"{worker_id}.log"),
            oom_killed=(term_signal == 9 and oom.delta() > 0),
            source="agent")
        try:
            self.conn.cast("worker_death",
                           {"worker_id": worker_id, "report": report})
        except Exception:
            pass  # head unreachable: its own conn-close path classifies

    def _heartbeat_loop(self) -> None:
        import time as _time

        period = max(0.1, GLOBAL_CONFIG.health_check_period_s)
        every_n = max(1, int(GLOBAL_CONFIG.clock_sync_every_n_heartbeats))
        # Recent NTP-style probes as (rtt, offset); the min-RTT sample
        # wins — queueing delay only ever inflates RTT, so the tightest
        # round trip carries the least-biased offset estimate.
        probes: "deque[tuple[float, float]]" = deque(maxlen=8)
        beat = 0
        while not self._exit.wait(period):
            body: dict = {"node_id": self.node_id}
            if beat % every_n == 0:
                try:
                    # Clock probe (timeline alignment): offset estimate
                    # = (t0+t1)/2 - t_head, i.e. node_clock - head_clock
                    # assuming symmetric network latency. The offset is
                    # wall-clock by contract (it aligns wall timelines
                    # across nodes); the RTT used to RANK probes is an
                    # elapsed time and must be monotonic — an NTP step
                    # mid-probe would otherwise crown a garbage sample
                    # as the "tightest" round trip.
                    m0 = _time.monotonic()
                    t0 = _time.time()
                    reply = self.conn.call("clock_sync", {}, timeout=5)
                    t1 = _time.time()
                    m1 = _time.monotonic()
                    probes.append(((m1 - m0),
                                   (t0 + t1) / 2.0 - reply["t_head"]))
                except Exception:
                    pass  # older head / transient failure: keep beating
            if probes:
                body["clock_offset"] = min(probes)[1]
            # Cluster-wide rpc counter aggregation: this agent's own
            # head-connection census rides the beacon.
            body["rpc"] = {"head": {
                "frames_sent": self.conn.frames_sent,
                "calls_sent": self.conn.calls_sent,
                "sent_kinds": dict(self.conn.sent_kinds)}}
            # Profiling-plane piggyback: the agent's sampler window
            # rides the heartbeat it already sends — zero new frames.
            from ray_tpu_torch._private import profplane

            prof = profplane.report_summary()
            if prof is not None:
                body["profile"] = prof
            # Telemetry-history piggyback: a tiny node-health sample
            # (load average + memory) becomes per-node gauge series in
            # the head's tsdb — `ray-tpu top`'s node rows. Same beacon,
            # zero new frames.
            sys_sample = _sys_sample()
            if sys_sample:
                body["sys"] = sys_sample
            beat += 1
            try:
                self.conn.cast("agent_heartbeat", body)
            except (rpc.ConnectionLost, rpc.RpcError):
                pass  # reconnect loop owns recovery

    def _on_head_lost(self, _conn) -> None:
        """Head connection dropped. Instead of dying (the pre-FT lease
        semantics), retry the head address for a grace window and
        RE-REGISTER under the same node_id — a restarted head re-adopts
        this node (reference: raylets reconnecting to a recovered GCS,
        gcs_redis_failure_detector.h + gcs_init_data.h)."""
        if self._exit.is_set():
            return
        threading.Thread(target=self._reconnect_loop, daemon=True,
                         name="agent-reconnect").start()

    def _reconnect_loop(self) -> None:
        import time

        deadline = time.time() + GLOBAL_CONFIG.agent_reconnect_grace_s
        # Old-epoch workers die with their head connections, but not
        # instantly (one may be mid-task): give them a moment, then
        # TERMINATE stragglers — the new epoch schedules against this
        # node's full resources, so ghosts must not keep holding them.
        for proc in list(self.procs.values()):
            try:
                proc.wait(timeout=0.5)
            except Exception:
                try:
                    proc.terminate()
                    proc.wait(timeout=2.0)
                except Exception:
                    try:
                        proc.kill()
                    except Exception:
                        pass
        self.procs.clear()
        from ray_tpu_torch._private.retry import backoff_delays

        delays = backoff_delays(self._retry_policy)
        while time.time() < deadline and not self._exit.is_set():
            conn = None
            try:
                conn = rpc.connect(
                    self.head_address,
                    handler=self._handle,
                    name="node_agent",
                    on_close=self._on_head_lost,
                )
                reply = conn.call(
                    "register_node",
                    {
                        "node_id": self.node_id,
                        "resources": self._resources,
                        "labels": self._labels,
                        "address": socket.gethostname(),
                        "transfer_port": self.transfer_server.address[1],
                        "bulk_port": self.bulk_server.address[1],
                        "store_name": self.store_name,
                        "store_capacity": self.store_capacity,
                        "host_id": _host_id(),
                    },
                    timeout=GLOBAL_CONFIG.worker_register_timeout_s,
                )
                self.conn = conn
                self.session_dir = reply["session_dir"]
                # The old head's object directory died with it: every
                # local payload is unreferenced now. Reclaim the arena.
                with self._store_lock:
                    for offset, _ in self.local_objects.values():
                        try:
                            self.store.free(offset)
                        except Exception:
                            pass
                    self.local_objects.clear()
                try:
                    conn.call("subscribe", {"topic": self._view_topic},
                              timeout=10)
                except rpc.RpcError:
                    pass
                print(f"node agent {self.node_id}: re-registered with "
                      f"restarted head", flush=True)
                return
            except Exception:
                if conn is not None:
                    # Half-open connection: detach its close hook so it
                    # cannot spawn a second reconnect loop.
                    conn._on_close = None
                    try:
                        conn.close()
                    except Exception:
                        pass
                # Unified backoff (was a fixed 1 s poll): decorrelated
                # exponential delays so a head restart isn't greeted by
                # a synchronized re-register storm from every agent.
                time.sleep(min(next(delays),
                               max(0.0, deadline - time.time())))
        self._exit.set()

    def _memory_watch(self) -> None:
        from ray_tpu_torch._private.memory_monitor import system_memory_usage

        cfg = GLOBAL_CONFIG
        if not cfg.memory_monitor_enabled or cfg.memory_usage_threshold >= 1.0:
            return
        soft = float(cfg.memory_pressure_threshold)
        soft_on = 0 < soft < cfg.memory_usage_threshold
        pressured = False
        while not self._exit.wait(cfg.memory_monitor_interval_s):
            try:
                used, total = system_memory_usage()
                if total <= 0:
                    continue
                ratio = used / total
                # Soft watermark (overload plane): while this node is
                # past it, the head stops placing work and granting
                # leases here. Re-cast every tick while pressured — the
                # head expires stale pressure entries, so a lost
                # recovery cast can never wedge the node out of the
                # scheduler forever.
                if soft_on:
                    was = pressured
                    if pressured:
                        pressured = (ratio
                                     >= soft - cfg.memory_pressure_hysteresis)
                    else:
                        pressured = ratio >= soft
                    if pressured or was:
                        self.conn.cast("mem_pressure", {
                            "node_id": self.node_id,
                            "pressured": pressured,
                            "used_bytes": used,
                            "total_bytes": total,
                        })
                if ratio >= cfg.memory_usage_threshold:
                    self.conn.cast("oom_pressure", {
                        "node_id": self.node_id,
                        "used_bytes": used,
                        "total_bytes": total,
                    })
            except Exception:
                pass

    @staticmethod
    def _detect_resources(num_cpus, num_gpus, resources) -> dict:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        else:
            res.setdefault("CPU", float(os.cpu_count() or 1))
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        else:
            from ray_tpu_torch.accelerators.accelerator import merge_detected_resources

            merge_detected_resources(res)
        return res

    # ------------------------------------------------------------------

    def _handle(self, kind: str, body: dict, conn: rpc.Connection):
        if kind == "spawn_worker":
            self._spawn(body)
        elif kind == "signal_worker":
            # Dashboard live profiling: poke the worker's faulthandler
            # (reference: reporter/profile_manager.py stack capture).
            import signal as _signal

            proc = self.procs.get(body["worker_id"])
            if proc is not None and proc.poll() is None:
                try:
                    proc.send_signal(body.get("signum",
                                              int(_signal.SIGUSR1)))
                except OSError:
                    pass
        elif kind == "free_object":
            # Head directory says the object's refcount hit zero. An
            # in-flight bulk read defers the free to its pin release.
            with self._store_lock:
                oid = body["object_id"]
                if self._pull_pins.get(oid):
                    self._pending_free.add(oid)
                else:
                    loc = self.local_objects.pop(oid, None)
                    if loc is not None:
                        self.store.free(loc[0])
        elif kind == "spill_objects":
            # Memory-pressured node (watermarks): the head picked
            # cold primaries to move into external storage. Off the
            # dispatch thread — spilling writes files.
            threading.Thread(target=self._spill_objects,
                             args=(list(body.get("ids") or ()),),
                             daemon=True, name="agent-spill").start()
        elif kind == "pubsub_message":
            if body.get("topic") == self._view_topic:
                self.cluster_view.apply(body.get("data") or {})
        elif kind == "log_index":
            # Remote-node log access: the head forwards `ray-tpu logs
            # --node <id>` here so every node's worker logs are
            # listable/tailable from the driver (reference: the
            # dashboard log module's per-node agent routes).
            from ray_tpu_torch._private import log_utils

            return {"logs": log_utils.log_index(self.log_dir)}
        elif kind == "log_tail":
            from ray_tpu_torch._private import log_utils

            return log_utils.log_tail(
                self.log_dir, body["name"],
                int(body.get("max_bytes", 64 * 1024)))
        elif kind == "shutdown_node":
            self._exit.set()
        return None

    def _spill_store(self):
        """External storage for this node's spills: the session spill
        dir (shared storage in production — S3-style via the
        object_spilling_config backends; one filesystem on a dev box),
        so the head can restore/delete the copies and they survive this
        node's death."""
        store = getattr(self, "_spill_backend", None)
        if store is None:
            from ray_tpu_torch._private.external_storage import FileSystemStorage

            store = self._spill_backend = FileSystemStorage(
                os.path.join(self.session_dir, "spill"))
        return store

    def _spill_objects(self, ids: list) -> None:
        """Spill-with-consent protocol: write the bytes to external
        storage FIRST, then ask the head to drop the arena copy — the
        head refuses while any reader holds a meta into this arena, in
        which case the spill file stays as a backup (it doubles as the
        node-death recovery copy)."""
        from ray_tpu_torch._private import dataplane

        store = self._spill_store()
        for oid in ids:
            with self._store_lock:
                loc = self.local_objects.get(oid)
                if loc is None:
                    continue
                view = self.store.view(loc[0], loc[1])
                try:
                    data = bytes(view)
                finally:
                    view.release()
            try:
                path = store.spill(oid, memoryview(data))
            except OSError:
                continue
            dataplane.record("spill", len(data))
            try:
                reply = self.conn.call(
                    "object_spilled",
                    {"object_id": oid, "node_id": self.node_id,
                     "path": path}, timeout=30)
            except (rpc.RpcError, rpc.ConnectionLost):
                continue  # head unreachable: keep both copies
            if reply.get("delete"):
                store.delete(path)
            if reply.get("drop"):
                # Same deferred-free discipline as free_object: an
                # in-flight bulk read pins the region.
                with self._store_lock:
                    if self._pull_pins.get(oid):
                        self._pending_free.add(oid)
                    else:
                        loc2 = self.local_objects.pop(oid, None)
                        if loc2 is not None:
                            self.store.free(loc2[0])

    def _bulk_read(self, object_id: str, start: int, length: int):
        with self._store_lock:
            loc = self.local_objects.get(object_id)
            if loc is None:
                raise KeyError(f"object {object_id} not on this node")
            offset, size = loc
            if start >= size:
                raise ValueError(f"start {start} past object size {size}")
            n = min(length, size - start)
            self._pull_pins[object_id] = self._pull_pins.get(object_id, 0) + 1
            view = self.store.view(offset + start, n)

        def release(object_id=object_id, view=view):
            view.release()
            with self._store_lock:
                left = self._pull_pins.get(object_id, 1) - 1
                if left <= 0:
                    self._pull_pins.pop(object_id, None)
                    if object_id in self._pending_free:
                        self._pending_free.discard(object_id)
                        loc2 = self.local_objects.pop(object_id, None)
                        if loc2 is not None:
                            self.store.free(loc2[0])
                else:
                    self._pull_pins[object_id] = left

        return view, release

    def _transfer_handle(self, kind: str, body: dict, conn: rpc.Connection):
        """Store-plane RPCs: local workers allocate/seal; remote nodes
        pull chunks (reference: ObjectManager push/pull protocol,
        push_manager.h:32 — here pull-based: the consumer drives)."""
        if kind == "cluster_view":
            # Head-free cluster state read served from the synced view
            # (reference: each raylet answers resource queries from its
            # ray_syncer-replicated view, not by asking the GCS).
            out = self.cluster_view.to_dict()
            out["totals"] = self.cluster_view.totals()
            out["node_id"] = self.node_id
            return out
        if kind == "alloc":
            with self._store_lock:
                offset = self.store.alloc(body["size"])
            if offset is None:
                raise rpc.RpcError(
                    f"ObjectStoreFullError: agent store cannot allocate "
                    f"{body['size']} bytes")
            return {"offset": offset}
        if kind == "locate":
            # Data plane: direct arena readers (no head pin) bracket
            # their copy with two locates — unchanged (offset, size)
            # across the read proves the region wasn't spilled/freed
            # mid-copy (ids never re-seal at a different offset within
            # one agent lifetime).
            with self._store_lock:
                loc = self.local_objects.get(body["object_id"])
            return {"offset": loc[0] if loc else None,
                    "size": loc[1] if loc else None}
        if kind == "seal_local":
            with self._store_lock:
                existing = self.local_objects.get(body["object_id"])
                if existing is not None:
                    # Duplicate seal (N workers replicating the same
                    # broadcast payload concurrently): keep the first
                    # copy, free the newcomer's allocation, and tell the
                    # caller which offset is canonical — otherwise every
                    # extra copy leaks until agent shutdown and a
                    # replica registration could point at a freed
                    # region.
                    self.store.free(body["offset"])
                    return {"offset": existing[0], "dup": True}
                self.local_objects[body["object_id"]] = (
                    body["offset"], body["size"])
            return {"offset": body["offset"], "dup": False}
        if kind == "pull":
            with self._store_lock:
                loc = self.local_objects.get(body["object_id"])
                if loc is None:
                    raise rpc.RpcError(
                        f"object {body['object_id']} not on this node")
                offset, size = loc
                start = body["start"]
                n = min(body["length"], size - start)
                # Copy under the lock: a concurrent free_object +
                # realloc must not recycle the region mid-read.
                view = self.store.view(offset + start, n)
                try:
                    data = bytes(view)
                finally:
                    view.release()
            return {"data": data, "total": size}
        if kind == "abort_alloc":
            with self._store_lock:
                self.store.free(body["offset"])
            return {}
        if kind == "abort_sealed":
            # Writer-side rollback: seal_local succeeded but the head
            # directory registration failed — without this the sealed
            # bytes have no directory entry and nothing ever frees them.
            with self._store_lock:
                loc = self.local_objects.pop(body["object_id"], None)
                if loc is not None:
                    self.store.free(loc[0])
            return {}
        raise rpc.RpcError(f"unknown transfer op {kind!r}")

    def _spawn(self, body: dict) -> None:
        worker_id = body["worker_id"]
        env = dict(os.environ)
        if not body.get("gpu_capable"):
            # Chipless pool worker: GPU-invisible (see Head.spawn_worker).
            from ray_tpu_torch._private.hermetic import hide_gpus

            hide_gpus(env)
        env["RAY_TPU_WORKER_ID"] = worker_id
        # Use the address THIS agent dialed, not the head's bind address —
        # a head bound to 0.0.0.0 would otherwise tell remote workers to
        # connect to their own loopback.
        env["RAY_TPU_HEAD"] = f"{self.head_address[0]}:{self.head_address[1]}"
        env["RAY_TPU_NODE_ID"] = body["node_id"]
        if self.force_remote_objects:
            # Tests: same-host agents exercise the off-host object path.
            env["RAY_TPU_REMOTE"] = "1"
        # Workers on this node use the agent's local store for large
        # objects (P2P data plane; name:capacity:host:port).
        env["RAY_TPU_AGENT_STORE"] = (
            f"{self.store_name}:{self.store_capacity}:"
            f"127.0.0.1:{self.transfer_server.address[1]}:"
            f"{self.bulk_server.address[1]}")
        # Crash file + beacon land next to the worker log (forensics.arm
        # in the worker; the reaper reads them post-mortem).
        env["RAY_TPU_CRASH_DIR"] = self.log_dir
        log_dir = self.log_dir
        proc = None
        if not body.get("gpu_capable"):
            # Fork from this node's zygote (reference: warm raylet
            # worker pool, worker_pool.h:224) — see gcs.spawn_worker.
            zy = getattr(self, "_zygote", None)
            if zy is None:
                from ray_tpu_torch._private.zygote import ZygoteClient

                zyenv = dict(env)
                for k in ("RAY_TPU_WORKER_ID", "RAY_TPU_NODE_ID"):
                    zyenv.pop(k, None)
                zy = self._zygote = ZygoteClient(zyenv, log_dir)
                zy.start_async()  # first spawn falls back to Popen
            pid = zy.spawn(
                {k: env[k] for k in env
                 if k.startswith("RAY_TPU_")},
                os.path.join(log_dir, f"{worker_id}.log"))
            if pid is not None:
                proc = _ZygotePid(pid)
        if proc is None:
            with open(os.path.join(log_dir, f"{worker_id}.log"), "ab") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch._private.worker"],
                    env=env,
                    stdout=out,
                    stderr=subprocess.STDOUT,
                    cwd=os.getcwd(),
                )  # child keeps inherited fd; parent must not leak one per spawn
        self.procs[worker_id] = proc
        # Best-effort cgroup v2 isolation (reference: cgroup_setup.h).
        from ray_tpu_torch._private.cgroup import CgroupSetup

        CgroupSetup.get_or_create(self, self.node_id).add_worker_process(proc.pid)

    def run_forever(self) -> None:
        self._exit.wait()
        self.shutdown()

    def shutdown(self) -> None:
        zy = getattr(self, "_zygote", None)
        if zy is not None:
            zy.stop()
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=2.0)
            except Exception:
                pass
        # Only after the workers actually exited (rmdir on a populated
        # cgroup is EBUSY).
        cg = getattr(self, "_cgroup", None)
        if cg is not None:
            cg.teardown()
        try:
            self.transfer_server.stop()
        except Exception:
            pass
        try:
            self.bulk_server.stop()
        except Exception:
            pass
        try:
            self.store.close(unlink=True)
        except Exception:
            pass
        try:
            self.conn.close()
        except Exception:
            pass


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description="ray_tpu_torch node agent")
    p.add_argument("--address", required=True, help="head host:port")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default=None, help='JSON, e.g. \'{"side": 1}\'')
    p.add_argument("--labels", default=None,
                   help='JSON node labels, e.g. \'{"zone": "us-a"}\' '
                        '(NodeLabelSchedulingStrategy targets)')
    p.add_argument("--node-id", default=None)
    p.add_argument("--force-remote-objects", action="store_true")
    args = p.parse_args()
    host, port = args.address.rsplit(":", 1)
    import json

    agent = NodeAgent(
        (host, int(port)),
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources=json.loads(args.resources) if args.resources else None,
        labels=json.loads(args.labels) if args.labels else None,
        node_id=args.node_id,
        force_remote_objects=args.force_remote_objects,
    )
    print(f"node agent up: node_id={agent.node_id}", flush=True)
    agent.run_forever()


if __name__ == "__main__":
    main()
