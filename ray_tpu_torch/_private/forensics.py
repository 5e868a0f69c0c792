"""Post-mortem crash forensics: exit classification, stack capture, beacon.

Counterpart of the reference's structured worker-death diagnostics
(reference: src/ray/protobuf/common.proto WorkerExitType + the
``exit_detail`` strings threaded through the GCS death path,
gcs/gcs_server/gcs_worker_manager.cc; OOM attribution in the raylet's
memory monitor, src/ray/common/memory_monitor.h:52). Our runtime used to
reduce every death to a bare ``death_cause`` string — this module gives
each worker process a black box the supervisor can read AFTER the
process is gone:

  * a **crash file** (``<logs>/<worker_id>.crash``): ``faulthandler``
    is armed into it, so fatal signals (SIGSEGV/SIGABRT/SIGBUS/...)
    dump every thread's Python stack on the way down; uncaught
    exceptions from ``sys``/``threading`` excepthooks land there too.
  * a **beacon** (``<logs>/<worker_id>.beacon``): a tiny mmap'd file
    the worker stamps with its current task, execution phase, RSS and
    thread CPU time. Plain file bytes — readable even after SIGKILL,
    which leaves no time for any in-process handler.

The supervisor half — ``classify_exit`` + ``collect_report`` — turns
the real ``wait()`` status plus this evidence (and cgroup
``memory.events`` oom_kill deltas via ``OomWatch``) into one bounded,
classified crash report. The head keeps those in a bounded table,
enriches user-facing death errors with them, and serves them through
``util.state.list_crash_reports()`` / the ``ray-tpu crashes`` CLI /
the dashboard.

Everything here is best-effort by construction: forensics must never
take a healthy worker down or add measurable steady-state cost (the
beacon write is a few hundred nanoseconds of mmap slice assignment per
task, and arming is one-time at worker boot).
"""

from __future__ import annotations

import json
import mmap
import os
import signal
import sys
import threading
import time

# Bounded-report knobs (constants, not config: reports must stay small
# enough to ride control-plane casts unconditionally).
STACK_MAX_CHARS = 8000      # crash-file bytes read for classification
STACK_EXCERPT_LINES = 16    # lines of stack shipped in the report
LOG_TAIL_BYTES = 8 * 1024   # log bytes read
LOG_TAIL_LINES = 40         # lines of log tail shipped

# --- exit reasons (Prometheus label values + user-facing text) --------
CLEAN_EXIT = "clean_exit"                  # exit 0, no supervisor intent
RETIRED = "retired"                        # max_calls clean retirement
INTENDED_KILL = "intended_kill"            # ray_tpu_torch.kill() / doomed-ghost kill
SHUTDOWN = "shutdown"                      # cluster shutdown
MEMORY_MONITOR_KILL = "memory_monitor_kill"  # head OOM policy victim
KERNEL_OOM = "kernel_oom"                  # kernel OOM killer (cgroup evidence)
FATAL_SIGNAL = "fatal_signal"              # SIGSEGV/SIGABRT/... crash
UNCAUGHT_EXCEPTION = "uncaught_exception"  # nonzero exit + excepthook trace
SIGKILL = "sigkill"                        # SIGKILL, unattributed
TERMINATED = "terminated"                  # SIGTERM/SIGINT from outside
NODE_DEATH = "node_death"                  # whole node presumed dead
SPAWN_FAILURE = "spawn_failure"            # never registered
UNKNOWN = "unknown"

# Supervisor-intent -> reason. An intent always wins over status
# guesswork (a memory-monitor kill IS a SIGKILL at the wait() level).
_INTENT_REASONS = {
    "memory_monitor": MEMORY_MONITOR_KILL,
    "retired": RETIRED,
    "intended_kill": INTENDED_KILL,
    "shutdown": SHUTDOWN,
    "node_death": NODE_DEATH,
    "spawn_failure": SPAWN_FAILURE,
}

# Reason specificity rank for report merging (head intent vs agent
# classification, whichever arrives second upgrades the stored report
# only if it knows MORE): unattributed guesses < evidence-backed
# classifications < supervisor intents.
REASON_RANK = {
    UNKNOWN: 0,
    CLEAN_EXIT: 1, SIGKILL: 1, TERMINATED: 1,
    KERNEL_OOM: 2, FATAL_SIGNAL: 2, UNCAUGHT_EXCEPTION: 2,
    MEMORY_MONITOR_KILL: 3, RETIRED: 3, INTENDED_KILL: 3, SHUTDOWN: 3,
    NODE_DEATH: 3, SPAWN_FAILURE: 3,
}


def signal_name(sig: "int | None") -> "str | None":
    if sig is None:
        return None
    try:
        return signal.Signals(sig).name
    except ValueError:
        return f"signal {sig}"


def split_status(status: "int | None") -> "tuple[int | None, int | None]":
    """os.waitpid status -> (exit_code, term_signal)."""
    if status is None:
        return None, None
    if os.WIFSIGNALED(status):
        return None, os.WTERMSIG(status)
    if os.WIFEXITED(status):
        return os.WEXITSTATUS(status), None
    return None, None


# ----------------------------------------------------------------------
# classification

def classify_exit(*, exit_code: "int | None" = None,
                  term_signal: "int | None" = None,
                  expected: "tuple | None" = None,
                  crash_text: str = "",
                  oom_killed: bool = False) -> tuple[str, str]:
    """(reason, detail) for one observed worker death.

    ``expected`` is the supervisor's recorded intent ``(intent, detail)``
    — set by the head before IT kills a worker (memory-monitor victim,
    ray_tpu_torch.kill, retirement release, shutdown) so its own kills never
    classify as anonymous SIGKILLs. ``oom_killed`` is cgroup
    ``memory.events`` evidence that the KERNEL's OOM killer fired in the
    window (reference: the raylet attributing SIGKILLs to the system OOM
    killer before blaming the network)."""
    intent = expected[0] if expected else None
    idetail = (expected[1] if expected and len(expected) > 1 else "") or ""
    if intent == "memory_monitor":
        return (MEMORY_MONITOR_KILL,
                idetail or "killed by the memory monitor's OOM policy")
    if intent in ("node_death", "spawn_failure"):
        return _INTENT_REASONS[intent], idetail
    if term_signal is not None:
        if term_signal == signal.SIGKILL:
            if oom_killed:
                return (KERNEL_OOM,
                        "SIGKILL attributed to the kernel OOM killer "
                        "(cgroup memory.events oom_kill advanced)")
            if intent:
                return _INTENT_REASONS.get(intent, INTENDED_KILL), idetail
            return SIGKILL, "SIGKILL from outside the runtime (unattributed)"
        if term_signal in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            if intent:
                return _INTENT_REASONS.get(intent, INTENDED_KILL), idetail
            return TERMINATED, f"terminated by {signal_name(term_signal)}"
        detail = f"fatal {signal_name(term_signal)}"
        if _has_fault_dump(crash_text):
            detail += " (post-mortem stacks captured)"
        return FATAL_SIGNAL, detail
    if exit_code is not None:
        if exit_code == 0:
            if intent:
                return _INTENT_REASONS.get(intent, CLEAN_EXIT), idetail
            return CLEAN_EXIT, "exit code 0"
        if ("Uncaught exception" in crash_text
                or "Traceback (most recent call last)" in crash_text):
            return (UNCAUGHT_EXCEPTION,
                    f"exit code {exit_code} after an uncaught exception")
        return UNKNOWN, f"exit code {exit_code}"
    if intent:
        return _INTENT_REASONS.get(intent, CLEAN_EXIT), idetail
    return UNKNOWN, "exit status unavailable"


def _has_fault_dump(crash_text: str) -> bool:
    return ("Fatal Python error" in crash_text
            or "Current thread" in crash_text
            or "Thread 0x" in crash_text)


# ----------------------------------------------------------------------
# file locations

def crash_dir_from_env() -> "str | None":
    d = os.environ.get("RAY_TPU_CRASH_DIR")
    if d:
        return d
    sess = os.environ.get("RAY_TPU_SESSION_DIR")
    return os.path.join(sess, "logs") if sess else None


def crash_path(crash_dir: str, worker_id: str) -> str:
    return os.path.join(crash_dir, f"{worker_id}.crash")


def beacon_path(crash_dir: str, worker_id: str) -> str:
    return os.path.join(crash_dir, f"{worker_id}.beacon")


def profile_path(crash_dir: str, worker_id: str) -> str:
    """The continuous profiler's last-window sidecar (profplane.py):
    one bounded JSON file next to the beacon, overwritten atomically
    per window — readable after SIGKILL like the beacon."""
    return os.path.join(crash_dir, f"{worker_id}.profile")


def read_profile_sidecar(path: str) -> "dict | None":
    """Best-effort read of a dead worker's last profile window (the
    "what it was burning CPU on" half of the post-mortem)."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


# ----------------------------------------------------------------------
# the beacon

class Beacon:
    """Tiny mmap'd status file the worker stamps per task. SIGKILL
    leaves no time for handlers — but the last stamp is already on the
    page cache, so the supervisor reads what the worker was doing at the
    instant of death regardless of HOW it died. One fixed-size frame
    (magic + length + JSON); a torn concurrent read fails JSON decode
    and reads as "no beacon" rather than garbage."""

    SIZE = 1024
    _MAGIC = b"RTB1"

    def __init__(self, path: str):
        self.path = path
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, self.SIZE)
            self._mm = mmap.mmap(fd, self.SIZE)
        finally:
            os.close(fd)
        self._pid = os.getpid()
        try:
            self._page = os.sysconf("SC_PAGESIZE")
        except (ValueError, OSError):
            self._page = 4096
        self._rss = 0
        self._rss_ts = 0.0
        self.update("", "", "boot")

    def _read_rss(self) -> int:
        # /proc read amortized: a per-call stat read would tax nop-task
        # floods for a field that only needs ~0.5 s freshness.
        now = time.monotonic()
        if now - self._rss_ts > 0.5:
            self._rss_ts = now
            try:
                with open("/proc/self/statm", "rb") as f:
                    self._rss = int(f.read().split()[1]) * self._page
            except (OSError, ValueError, IndexError):
                pass
        return self._rss

    def update(self, task_id: str = "", name: str = "",
               phase: str = "idle") -> None:
        # Hot path (stamped per task): hand-built JSON — json.dumps on
        # a fresh dict costs ~5 us; this is ~1 us. Fields are
        # runtime-generated ids/names (no quoting hazards); names are
        # clipped so the frame always fits.
        payload = (
            '{"pid":%d,"task_id":"%s","name":"%s","phase":"%s",'
            '"rss":%d,"cpu_s":%.4f,"ts":%.4f}' % (
                self._pid, task_id[:64],
                name.replace('"', "'")[:128], phase,
                self._read_rss(), time.thread_time(), time.time())
        ).encode()
        payload = payload[:self.SIZE - 8]
        frame = self._MAGIC + len(payload).to_bytes(4, "little") + payload
        self._mm[:len(frame)] = frame

    def close(self) -> None:
        # The FILE stays: it is the post-mortem record.
        try:
            self._mm.close()
        except Exception:
            pass


def read_beacon(path: str) -> "dict | None":
    try:
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8 or head[:4] != Beacon._MAGIC:
                return None
            n = int.from_bytes(head[4:8], "little")
            if not 0 < n <= Beacon.SIZE - 8:
                return None
            return json.loads(f.read(n))
    except (OSError, ValueError):
        return None


# ----------------------------------------------------------------------
# worker-side arming

_beacon: "Beacon | None" = None
_crash_file = None


def arm(worker_id: "str | None" = None,
        crash_dir: "str | None" = None) -> bool:
    """Arm THIS process's black box: faulthandler into the crash file
    (fatal signals dump all-thread stacks), sys/threading excepthooks
    appending uncaught exceptions there, and the beacon. Returns False
    (armed nothing) when the process has no worker identity or no
    writable crash dir — forensics never takes a worker down."""
    global _beacon, _crash_file
    import faulthandler

    worker_id = worker_id or os.environ.get("RAY_TPU_WORKER_ID")
    crash_dir = crash_dir or crash_dir_from_env()
    if not worker_id or not crash_dir:
        return False
    try:
        os.makedirs(crash_dir, exist_ok=True)
        f = open(crash_path(crash_dir, worker_id), "a", buffering=1)
    except OSError:
        return False
    _crash_file = f  # module-held: faulthandler needs the fd alive forever
    try:
        faulthandler.enable(file=f, all_threads=True)
    except (RuntimeError, ValueError):
        pass
    _install_excepthooks(f)
    try:
        _beacon = Beacon(beacon_path(crash_dir, worker_id))
    except OSError:
        _beacon = None
    return True


def _install_excepthooks(f) -> None:
    import traceback

    prev_sys = sys.excepthook
    prev_thr = threading.excepthook

    def _sys_hook(tp, val, tb):
        try:
            f.write("Uncaught exception (main thread):\n")
            traceback.print_exception(tp, val, tb, file=f)
            f.flush()
        except Exception:
            pass
        prev_sys(tp, val, tb)

    def _thr_hook(args):
        try:
            name = args.thread.name if args.thread else "?"
            f.write(f"Uncaught exception in thread {name}:\n")
            traceback.print_exception(args.exc_type, args.exc_value,
                                      args.exc_traceback, file=f)
            f.flush()
        except Exception:
            pass
        prev_thr(args)

    sys.excepthook = _sys_hook
    threading.excepthook = _thr_hook


def beacon_update(task_id: str = "", name: str = "",
                  phase: str = "idle") -> None:
    """Per-task beacon stamp; no-op when unarmed. Never raises."""
    b = _beacon
    if b is None:
        return
    try:
        b.update(task_id, name, phase)
    except Exception:
        pass


# ----------------------------------------------------------------------
# supervisor-side evidence readers

def read_crash_text(crash_dir: "str | None", worker_id: str,
                    max_chars: int = STACK_MAX_CHARS) -> str:
    if not crash_dir:
        return ""
    try:
        with open(crash_path(crash_dir, worker_id), "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_chars))
            return f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def stack_excerpt(crash_text: str,
                  max_lines: int = STACK_EXCERPT_LINES) -> list[str]:
    """The report's bounded stack: from the LAST fault marker onward
    (faulthandler may have been poked before; the final dump is the
    death)."""
    if not crash_text:
        return []
    idx = -1
    # A fatal dump starts at its "Fatal Python error"/"Uncaught
    # exception" header with the thread stacks after it — anchor on the
    # last header, falling back to the first raw thread marker.
    for marker in ("Fatal Python error", "Uncaught exception"):
        i = crash_text.rfind(marker)
        if i >= 0:
            idx = i
            break
    if idx < 0:
        for marker in ("Current thread", "Thread 0x"):
            i = crash_text.find(marker)
            if i >= 0:
                idx = i
                break
    if idx < 0:
        return []
    return crash_text[idx:].splitlines()[:max_lines]


def read_log_tail(log_path: "str | None",
                  max_bytes: int = LOG_TAIL_BYTES,
                  max_lines: int = LOG_TAIL_LINES) -> list[str]:
    if not log_path:
        return []
    try:
        with open(log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            text = f.read().decode("utf-8", errors="replace")
    except OSError:
        return []
    return text.splitlines()[-max_lines:]


def collect_report(worker_id: str, node_id: "str | None",
                   pid: "int | None", *,
                   exit_code: "int | None" = None,
                   term_signal: "int | None" = None,
                   crash_dir: "str | None" = None,
                   log_path: "str | None" = None,
                   expected: "tuple | None" = None,
                   oom_killed: bool = False,
                   source: str = "head") -> dict:
    """One bounded crash report: classification + the evidence that
    produced it. Safe to build for a process that never wrote any
    forensics files (report is just thinner)."""
    crash_text = read_crash_text(crash_dir, worker_id)
    reason, detail = classify_exit(
        exit_code=exit_code, term_signal=term_signal, expected=expected,
        crash_text=crash_text, oom_killed=oom_killed)
    beacon = read_beacon(beacon_path(crash_dir, worker_id)) \
        if crash_dir else None
    profile = read_profile_sidecar(profile_path(crash_dir, worker_id)) \
        if crash_dir else None
    report = {
        "worker_id": worker_id,
        "node_id": node_id,
        "pid": pid,
        "exit_type": reason,
        "exit_detail": detail,
        "exit_code": exit_code,
        "term_signal": term_signal,
        "signal_name": signal_name(term_signal),
        "stack": stack_excerpt(crash_text),
        "log_tail": read_log_tail(log_path),
        "beacon": beacon,
        # Continuous-profiler join (profplane sidecar): the dead
        # worker's last sampled window — where its CPU went right
        # before the death, even after SIGKILL.
        "profile": profile,
        "source": source,
        "ts": time.time(),
    }
    if beacon and beacon.get("task_id"):
        report["last_task"] = {"task_id": beacon["task_id"],
                               "name": beacon.get("name")}
    return report


# ----------------------------------------------------------------------
# kernel OOM attribution

class OomWatch:
    """cgroup-v2 ``memory.events`` oom_kill delta watcher (reference:
    the raylet reading cgroup memory events to attribute worker
    SIGKILLs to the kernel OOM killer). A supervisor keeps one per
    node; a positive ``delta()`` around a SIGKILL death is strong
    evidence the kernel, not an operator, fired."""

    def __init__(self, extra_paths: "tuple | list" = ()):
        candidates = list(extra_paths) + ["/sys/fs/cgroup/memory.events"]
        self._paths = [p for p in candidates if p and os.path.isfile(p)]
        self._last = self.count()

    def count(self) -> int:
        total = 0
        for p in self._paths:
            try:
                with open(p) as f:
                    for line in f:
                        if line.startswith("oom_kill "):
                            total += int(line.split()[1])
            except (OSError, ValueError, IndexError):
                pass
        return total

    def delta(self) -> int:
        cur = self.count()
        d = cur - self._last
        self._last = cur
        return max(0, d)
