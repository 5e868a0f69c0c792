"""Host-memory monitor + OOM worker-killing policy.

Counterpart of the reference's MemoryMonitor
(reference: src/ray/common/memory_monitor.h:52 — cgroup/system usage
polling) and the worker-killing policies
(raylet/worker_killing_policy_retriable_fifo.h — prefer retriable tasks,
newest first; worker_killing_policy_group_by_owner.h). When host memory
passes the threshold, one busy worker is killed per tick; the existing
worker-death machinery (gcs._handle_worker_death) then retries its task
or restarts its actor, exactly as if it had crashed.

Victim policy (first match wins):
  1. newest worker running a RETRIABLE normal task (retries remain),
  2. newest worker running any normal task,
  3. newest RESTARTABLE actor worker.
Actors without restart budget are never chosen (killing them converts
memory pressure into permanent application failure).
"""

from __future__ import annotations

import threading
import time
from typing import Callable


def system_memory_usage() -> tuple[int, int]:
    """(used_bytes, total_bytes), cgroup-v2-aware (container limits win
    over the host numbers when present and lower)."""
    used = total = 0
    try:
        with open("/proc/meminfo") as f:
            info = {}
            for line in f:
                k, v = line.split(":", 1)
                info[k] = int(v.strip().split()[0]) * 1024
        total = info["MemTotal"]
        used = total - info.get("MemAvailable", 0)
    except Exception:
        return 0, 0
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw != "max":
            cg_total = int(raw)
            if 0 < cg_total < total:
                with open("/sys/fs/cgroup/memory.current") as f:
                    used = int(f.read().strip())
                total = cg_total
    except Exception:
        pass
    return used, total


class PressureGauge:
    """Cheap cached answer to "is THIS host past the soft memory
    watermark?" — one /proc/meminfo read per check interval, with
    hysteresis so the state doesn't flap at the boundary. Workers use
    it to bounce direct pushes (direct_rej) while pressured; recomputed
    lazily on access, so idle processes never poll."""

    def __init__(self, usage_fn: Callable[[], tuple[int, int]] | None = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG as _cfg

        self._usage_fn = usage_fn or system_memory_usage
        self._soft = float(_cfg.memory_pressure_threshold)
        self._hyst = float(_cfg.memory_pressure_hysteresis)
        self._interval = max(0.2, float(_cfg.memory_monitor_interval_s))
        self._enabled = (_cfg.memory_monitor_enabled and self._soft > 0
                         and self._soft < 1.0)
        self._last_check = 0.0
        self._pressured = False

    def pressured(self) -> bool:
        if not self._enabled:
            return False
        now = time.monotonic()
        if now - self._last_check >= self._interval:
            self._last_check = now
            try:
                used, total = self._usage_fn()
            except Exception:
                return self._pressured
            if total > 0:
                ratio = used / total
                if self._pressured:
                    self._pressured = ratio >= self._soft - self._hyst
                else:
                    self._pressured = ratio >= self._soft
        return self._pressured


class MemoryMonitor:
    def __init__(
        self,
        head,
        threshold: float = 0.95,
        interval_s: float = 1.0,
        usage_fn: Callable[[], tuple[int, int]] | None = None,
        min_kill_interval_s: float = 2.0,
        soft_threshold: float | None = None,
        hysteresis: float = 0.03,
    ):
        self._head = head
        self._threshold = threshold
        self._interval = interval_s
        self._usage_fn = usage_fn or system_memory_usage
        self._min_kill_interval = min_kill_interval_s
        self._last_kill = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.num_kills = 0
        # Soft watermark BELOW the kill threshold (overload-protection
        # plane): past it the head node is marked "pressured" — no new
        # placements or lease grants land on it — long before the
        # reactive SIGKILL defense has to fire. Disabled when >= the
        # kill threshold.
        self._soft = soft_threshold
        self._hysteresis = hysteresis
        self._soft_pressured = False

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="memory-monitor"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.tick()
            except Exception:
                pass  # monitoring must never take the head down

    def tick(self) -> bool:
        """One poll of the HEAD host; returns True if a worker was killed."""
        used, total = self._usage_fn()
        if total <= 0:
            return False
        ratio = used / total
        # Soft watermark first: backpressure (stop placements and lease
        # grants, bounce direct pushes) kicks in well below the kill
        # threshold, so graceful degradation gets a chance to work
        # before the reactive SIGKILL defense.
        soft = self._soft
        if soft is not None and 0 < soft < self._threshold:
            if not self._soft_pressured and ratio >= soft:
                self._soft_pressured = True
                self._head.set_node_pressure(
                    self._head.node_id, True, used, total)
            elif (self._soft_pressured
                  and ratio < soft - self._hysteresis):
                self._soft_pressured = False
                self._head.set_node_pressure(
                    self._head.node_id, False, used, total)
        if ratio < self._threshold:
            return False
        return self.kill_on_node(self._head.node_id, used, total)

    def kill_on_node(self, node_id: str, used: int, total: int) -> bool:
        """Apply the kill policy to one node's workers (the head's own
        tick, or a remote node agent reporting pressure via
        'oom_pressure'). Rate-limited globally so one kill gets time to
        free memory before the next."""
        now = time.time()
        if now - self._last_kill < self._min_kill_interval:
            return False
        victim, task_names = self._pick_victim(node_id)
        if victim is None:
            return False
        self._last_kill = now
        self.num_kills += 1
        # Crash-forensics intent: this SIGKILL must classify as a
        # memory-monitor kill, not an anonymous external kill.
        if victim.expected_exit is None:
            victim.expected_exit = (
                "memory_monitor",
                f"killed by the memory monitor's OOM policy on node "
                f"{node_id} (host memory {used}/{total} bytes, "
                f"threshold {self._threshold:.2f}); running: "
                f"{', '.join(task_names) or '<idle>'}")
        self._head.metrics["memory_monitor_kills"] = self.num_kills
        self._head.task_events.append({
            "event": "oom_kill",
            "worker_id": victim.worker_id,
            "node_id": node_id,
            "tasks": task_names,
            "used_bytes": used,
            "total_bytes": total,
            "ts": now,
        })
        self._kill(victim)
        return True

    def _pick_victim(self, node_id: str):
        """Returns (victim, its task names) — names snapshotted under the
        head lock (the inflight dict mutates concurrently as tasks finish).
        Candidates are scoped to ``node_id``: memory pressure is per-host,
        and killing a worker elsewhere cannot relieve it. Remote nodes'
        agents measure their own memory and report via 'oom_pressure'."""
        head = self._head
        with head.lock:
            busy = [
                r for r in head.workers.values()
                if r.inflight and r.node_id == node_id
            ]
            newest = sorted(busy, key=lambda r: -r.started_at)

            def result(r):
                return r, [s.name for s in r.inflight.values()]

            # 1. retriable normal tasks, newest first.
            for r in newest:
                if r.actor_id is None and all(
                    s.retries_used < s.max_retries for s in r.inflight.values()
                ):
                    return result(r)
            # 2. any normal task.
            for r in newest:
                if r.actor_id is None:
                    return result(r)
            # 3. restartable actors only.
            for r in newest:
                actor = head.actors.get(r.actor_id)
                if actor is None:
                    continue
                mr = actor.spec.max_restarts
                if mr != 0 and (mr < 0 or actor.restarts < mr):
                    return result(r)
        return None, []

    def _kill(self, victim) -> None:
        # Kill the process; the connection close triggers
        # _handle_worker_death → retry/restart (the OOM path reuses the
        # crash path end to end, like the reference raylet's policy kills).
        try:
            if victim.proc is not None:
                victim.proc.kill()
            elif victim.conn is not None:
                victim.conn.cast("kill", {})
        except Exception:
            pass
