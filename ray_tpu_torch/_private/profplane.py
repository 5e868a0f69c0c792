"""Continuous profiling plane: an always-on, duty-cycled sampling
profiler armed at boot in every runtime process.

The other observability planes answer "what happened" (flight
recorder), "what died" (forensics), "what leaks" (census), and "what
did this request touch" (tracing); this one answers "where do the CPU
cycles GO" — continuously, cluster-wide, with the same cost contract
as all of them: data rides the EXISTING amortized report casts (the
runtime's rpc_report, the agent's heartbeat, the head's own health
tick) and never adds a per-call head frame.

Architecture (reference analogue: the dashboard's py-spy-based
profile_manager.py, made always-on the way the reference's
TaskEventBuffer made task events always-on):

  * One ``ContinuousSampler`` per process, role-tagged (head / shard /
    agent / worker / driver). A single daemon thread samples every
    OTHER thread's stack via sys._current_frames() at
    ``RAY_TPU_PROFILE_HZ``, but only for ``RAY_TPU_PROFILE_DUTY_CYCLE``
    of each one-second cycle — steady-state cost is duty * hz stack
    walks per second (≈4/s at the defaults), measured ≤3% on the
    depth-32 pipelined op (benchmarks/microbenchmark.py).
  * Samples fold into a BOUNDED collapsed-stack table
    (``profiling_table_max``; overflow counts into "(other stacks)" +
    a dropped counter — a stack explosion must not leak the
    instrument).
  * Every ``profiling_window_s`` the owner ships a bounded top-K
    summary head-ward piggybacked on the report cast that already
    flows; the head merges summaries into a bounded cluster table
    keyed (node, role, window) — ``util.state.cluster_profile()`` /
    ``ray-tpu profile`` render the merged flamegraph.
  * The on-demand probe (``util.state.profile_worker``) BORROWS the
    armed sampler's stream — ``borrow()`` temporarily raises the
    sample rate and tees each sample to the borrower — so continuous +
    on-demand sampling never run two sampler threads or double-count.
  * Cross-plane joins: a task whose exec wall time dwarfs its CPU time
    (the ``exec_cpu`` stamp) triggers ``note_task_cpu`` to pin a
    GIL-starvation exemplar (the profile of the window the task
    starved in) onto the next summary; each window is also persisted
    to a sidecar file next to the forensics ``.beacon`` so a SIGKILL'd
    worker leaves a "what it was burning CPU on" record.

Kill switch: ``RAY_TPU_PROFILING_ENABLED=0`` arms nothing — no thread,
no table, no report field, bit-identical report casts.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

# py-spy's default --idle=false, shared with the on-demand probe
# (worker._sample_profile historically carried its own copy; this is
# now the single source): threads parked in a wait primitive tell you
# nothing about where time GOES. C builtins (time.sleep,
# sock.recv_into) leave NO Python frame, so the filter matches both
# the pure-Python wait wrappers by leaf name AND blocking-call leaves
# by their source line.
IDLE_LEAVES = {"wait", "_recv_exact", "accept", "select",
               "poll", "_wait_for_tstate_lock"}
IDLE_CALLS = (".sleep(", ".wait(", ".recv(", ".recv_into(",
              ".accept(", ".select(", ".poll(", ".acquire(")

OTHER_BUCKET = "(other stacks)"

_DEFAULT_HZ = 19        # prime: avoids aliasing with 10/50/100 ms loops
_DEFAULT_DUTY = 0.2


def is_idle_leaf(leaf) -> bool:
    """True when a stack's leaf frame is a wait primitive (the sample
    says "parked", not "working")."""
    if leaf.name in IDLE_LEAVES:
        return True
    line = leaf.line or ""
    return any(c in line for c in IDLE_CALLS)


def fold_stack(stack) -> str:
    """traceback.extract_stack frames -> collapsed-stack key
    ("file:func;file:func;..."), flamegraph.pl input order."""
    return ";".join(f"{os.path.basename(f.filename)}:{f.name}"
                    for f in stack)


def enabled() -> bool:
    """The plane's kill switch (default ON — this is an always-on
    plane the way task events are)."""
    return os.environ.get("RAY_TPU_PROFILING_ENABLED", "1").lower() \
        not in ("0", "false", "no", "off")


def _coerce_float(raw: "str | None", default: float) -> float:
    try:
        return float(raw or default)
    except ValueError:
        return default


class _Borrow:
    """One on-demand probe teed off the continuous stream."""

    __slots__ = ("folded", "samples", "include_idle", "hz")

    def __init__(self, include_idle: bool, hz: int):
        self.folded: dict[str, int] = {}
        self.samples = 0
        self.include_idle = include_idle
        self.hz = hz


class ContinuousSampler:
    """The per-process half of the plane: one daemon thread, one
    bounded folded-stack table, duty-cycled."""

    def __init__(self, role: str, ident: "str | None" = None, *,
                 hz: "float | None" = None,
                 duty_cycle: "float | None" = None,
                 table_max: int = 4096,
                 sidecar_path: "str | None" = None,
                 sidecar_stacks: int = 200,
                 cycle_s: float = 1.0):
        self.role = role
        self.ident = ident or f"{role}-{os.getpid()}"
        self.pid = os.getpid()
        self.hz = max(1.0, min(200.0, float(
            hz if hz is not None
            else _coerce_float(os.environ.get("RAY_TPU_PROFILE_HZ"),
                               _DEFAULT_HZ))))
        self.duty_cycle = max(0.01, min(1.0, float(
            duty_cycle if duty_cycle is not None
            else _coerce_float(os.environ.get("RAY_TPU_PROFILE_DUTY_CYCLE"),
                               _DEFAULT_DUTY))))
        self.table_max = max(16, int(table_max))
        self.sidecar_path = sidecar_path
        self.sidecar_stacks = max(1, int(sidecar_stacks))
        self.cycle_s = max(0.05, float(cycle_s))

        self._folded: dict[str, int] = {}
        self._swap_lock = threading.Lock()
        self.dropped = 0
        self.samples = 0              # lifetime sample passes
        self._win_samples = 0         # samples in the current window
        self._win_cost_s = 0.0        # time spent INSIDE sampling calls
        self.window_start = time.time()
        self.last_window: "dict | None" = None
        self.windows_shipped = 0

        # GIL-starvation exemplar, pinned by note_task_cpu until the
        # next window summary ships it.
        self._pending_exemplar: "dict | None" = None
        self.gil_exemplars = 0

        # On-demand borrows teed off the stream (profile_worker).
        self._borrows: dict[int, _Borrow] = {}
        self._borrow_lock = threading.Lock()
        self._next_borrow_id = 1
        self.borrows_served = 0

        self._stopped = False
        self._wake = threading.Event()
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="profplane-sampler")
        self._thread.start()

    # -- sampling loop -------------------------------------------------

    def _loop(self) -> None:
        while not self._stopped:
            now = time.monotonic()
            with self._borrow_lock:
                boost = max((b.hz for b in self._borrows.values()),
                            default=0.0)
            if boost:
                # A borrow is active: sample continuously at the raised
                # rate for the probe's benefit (the window table keeps
                # accumulating too — one stream, counted once each).
                rate = max(self.hz, boost)
                active = True
            else:
                rate = self.hz
                phase = (now - self._t0) % self.cycle_s
                active = phase < self.cycle_s * self.duty_cycle
            if active:
                # Cost is thread CPU time, not wall: a preempted pass on
                # a loaded box burns no extra cycles and must not inflate
                # the reported overhead.
                t0 = time.thread_time()
                try:
                    self._sample_once()
                except Exception:
                    pass  # a torn frame walk must never kill the plane
                self._win_cost_s += time.thread_time() - t0
                self._wake.wait(max(0.001, 1.0 / rate))
            else:
                # Sleep out the idle remainder of the cycle; borrow()
                # sets _wake so a probe starting mid-idle isn't delayed
                # a full cycle.
                phase = (time.monotonic() - self._t0) % self.cycle_s
                self._wake.wait(max(0.001, self.cycle_s - phase))
            self._wake.clear()

    def _sample_once(self) -> None:
        me = threading.get_ident()
        with self._borrow_lock:
            borrows = list(self._borrows.values())
        folded = self._folded  # one read: survives a concurrent swap
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            try:
                stack = traceback.extract_stack(frame)
            except Exception:
                continue
            if not stack:
                continue
            idle = is_idle_leaf(stack[-1])
            key = None
            if not idle:
                key = fold_stack(stack)
                n = folded.get(key)
                if n is not None:
                    folded[key] = n + 1
                elif len(folded) < self.table_max:
                    folded[key] = 1
                else:
                    self.dropped += 1
                    folded[OTHER_BUCKET] = folded.get(OTHER_BUCKET, 0) + 1
            for b in borrows:
                if idle and not b.include_idle:
                    continue
                k = key if key is not None else fold_stack(stack)
                b.folded[k] = b.folded.get(k, 0) + 1
        self.samples += 1
        self._win_samples += 1
        for b in borrows:
            b.samples += 1

    # -- window shipping -----------------------------------------------

    def window_summary(self, max_stacks: int = 64) -> dict:
        """Close the current window: swap the table out, fold it to a
        bounded top-K summary (the piggyback payload), stash it as
        last_window, and persist the sidecar. Called from the report
        shipper on the amortized cadence — never per call."""
        with self._swap_lock:
            cur, self._folded = self._folded, {}
            start, self.window_start = self.window_start, time.time()
            samples, self._win_samples = self._win_samples, 0
            cost, self._win_cost_s = self._win_cost_s, 0.0
            dropped, self.dropped = self.dropped, 0
            exemplar, self._pending_exemplar = self._pending_exemplar, None
        end = time.time()
        top = sorted(cur.items(), key=lambda kv: kv[1], reverse=True)
        kept = dict(top[:max_stacks])
        rest = sum(v for _, v in top[max_stacks:])
        if rest:
            kept[OTHER_BUCKET] = kept.get(OTHER_BUCKET, 0) + rest
        summary = {
            "role": self.role,
            "ident": self.ident,
            "pid": self.pid,
            "start": start,
            "end": end,
            "samples": samples,
            "sample_cost_s": round(cost, 6),
            "hz": self.hz,
            "duty_cycle": self.duty_cycle,
            "folded": kept,
            "dropped": dropped,
        }
        if exemplar is not None:
            summary["gil_exemplar"] = exemplar
        self.last_window = summary
        self.windows_shipped += 1
        if self.sidecar_path:
            self._write_sidecar(cur, summary)
        return summary

    def _write_sidecar(self, cur: dict, summary: dict) -> None:
        """Crash-forensics join: the last window, bounded, on disk next
        to the .beacon — plain file bytes a supervisor can read after
        SIGKILL. Atomic rename so a death mid-write leaves the previous
        window, never a torn file."""
        try:
            top = sorted(cur.items(), key=lambda kv: kv[1],
                         reverse=True)[:self.sidecar_stacks]
            rec = {k: v for k, v in summary.items() if k != "folded"}
            rec["folded"] = dict(top)
            tmp = self.sidecar_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.sidecar_path)
        except OSError:
            pass  # full disk / vanished session dir: profiling is best-effort

    # -- cross-plane joins ---------------------------------------------

    def note_task_cpu(self, task_id: str, name: "str | None",
                      wall_s: float, cpu_s: float, *,
                      min_wall_s: float = 0.5,
                      cpu_ratio: float = 0.25) -> bool:
        """GIL/blocking attribution: a task whose exec wall time dwarfs
        its CPU time pins the CURRENT window's profile as an exemplar —
        "this is what the process was doing while that task starved".
        First trigger per window wins (the exemplar is a snapshot, not
        a stream); steady-state cost is two float compares per task."""
        if wall_s < min_wall_s or cpu_s > wall_s * cpu_ratio:
            return False
        if self._pending_exemplar is not None:
            return False
        top = sorted(self._folded.items(), key=lambda kv: kv[1],
                     reverse=True)[:32]
        self._pending_exemplar = {
            "task_id": task_id,
            "name": name,
            "wall_s": round(wall_s, 4),
            "cpu_s": round(cpu_s, 4),
            "folded": dict(top),
        }
        self.gil_exemplars += 1
        return True

    # -- on-demand borrow (profile_worker unification) -------------------

    def borrow(self, duration_s: float, *, hz: int = 50,
               include_idle: bool = False) -> dict:
        """Tee an on-demand probe off the continuous stream for
        ``duration_s``: the sampler's rate is raised to ``hz`` and each
        sample lands in BOTH the window table and the borrower — one
        sampler thread, no double-counting, concurrent borrows safe."""
        duration_s = min(30.0, max(0.1, float(duration_s)))
        b = _Borrow(bool(include_idle), max(1, min(200, int(hz))))
        with self._borrow_lock:
            bid = self._next_borrow_id
            self._next_borrow_id += 1
            self._borrows[bid] = b
        self._wake.set()  # probe starting mid-idle must not wait a cycle
        try:
            time.sleep(duration_s)
        finally:
            with self._borrow_lock:
                self._borrows.pop(bid, None)
            self.borrows_served += 1
        return {"samples": b.samples, "folded": b.folded,
                "duration_s": duration_s, "hz": b.hz}

    def stop(self) -> None:
        self._stopped = True
        self._wake.set()


# ----------------------------------------------------------------------
# process-global arming

_SAMPLER: "ContinuousSampler | None" = None
_ARM_LOCK = threading.Lock()


def sampler() -> "ContinuousSampler | None":
    return _SAMPLER


def arm(role: str, ident: "str | None" = None) -> "ContinuousSampler | None":
    """Arm this process's continuous sampler (idempotent — the first
    role wins; worker boot arms before the runtime constructor runs).
    Returns None when the kill switch is off."""
    global _SAMPLER
    if not enabled():
        return None
    with _ARM_LOCK:
        if _SAMPLER is not None:
            return _SAMPLER
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        sidecar = None
        if role == "worker" and ident:
            from ray_tpu_torch._private import forensics
            crash_dir = forensics.crash_dir_from_env()
            if crash_dir:
                try:
                    os.makedirs(crash_dir, exist_ok=True)
                    sidecar = forensics.profile_path(crash_dir, ident)
                except OSError:
                    sidecar = None
        _SAMPLER = ContinuousSampler(
            role, ident,
            table_max=GLOBAL_CONFIG.profiling_table_max,
            sidecar_path=sidecar,
            sidecar_stacks=GLOBAL_CONFIG.profiling_sidecar_stacks)
        return _SAMPLER


def disarm() -> None:
    """Stop and forget this process's sampler. Called when the driver
    detaches (ray_tpu_torch.shutdown()) and by tests; arm() re-arms."""
    global _SAMPLER
    with _ARM_LOCK:
        if _SAMPLER is not None:
            _SAMPLER.stop()
            _SAMPLER = None


def report_summary(force: bool = False) -> "dict | None":
    """The piggyback hook: a window summary when the window elapsed,
    else None (the report cast ships without a profile field). Called
    by the runtime's rpc_report shipper, the agent's heartbeat loop,
    and the head's health tick — all already-amortized paths."""
    s = _SAMPLER
    if s is None:
        return None
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    if not force and (time.time() - s.window_start
                      < GLOBAL_CONFIG.profiling_window_s):
        return None
    return s.window_summary(GLOBAL_CONFIG.profiling_report_stacks)


def note_task_cpu(task_id: str, name: "str | None",
                  wall_s: float, cpu_s: float) -> bool:
    """Module-level join hook for the worker's task-finish path."""
    s = _SAMPLER
    if s is None:
        return False
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    return s.note_task_cpu(
        task_id, name, wall_s, cpu_s,
        min_wall_s=GLOBAL_CONFIG.profiling_gil_min_wall_s,
        cpu_ratio=GLOBAL_CONFIG.profiling_gil_cpu_ratio)


# ----------------------------------------------------------------------
# folded-profile algebra (shared by the head merge, the CLI, and tests)

def merge_folded(into: dict, folded: dict, cap: int = 500) -> None:
    """Accumulate one folded table into another, bounded: past ``cap``
    distinct stacks new keys collapse into the overflow bucket."""
    for k, v in (folded or {}).items():
        n = into.get(k)
        if n is not None:
            into[k] = n + v
        elif len(into) < cap:
            into[k] = v
        else:
            into[OTHER_BUCKET] = into.get(OTHER_BUCKET, 0) + v


def diff_folded(a: dict, b: dict) -> dict:
    """Differential folded output (B - A), hits normalized per sample
    share so two windows of different lengths compare honestly. Keys
    present in either side appear; zero-delta stacks are dropped."""
    ta = max(1, sum(a.values()))
    tb = max(1, sum(b.values()))
    out: dict[str, float] = {}
    for k in set(a) | set(b):
        d = b.get(k, 0) / tb - a.get(k, 0) / ta
        if abs(d) > 1e-9:
            out[k] = round(d, 6)
    return out


def self_time(folded: dict) -> dict:
    """Leaf-frame self-hit counts from a folded table — the input of
    the ray_tpu_profile_self_hits top-N exposition."""
    out: dict[str, int] = {}
    for stack, hits in (folded or {}).items():
        if stack == OTHER_BUCKET:
            continue
        leaf = stack.rsplit(";", 1)[-1]
        out[leaf] = out.get(leaf, 0) + hits
    return out
