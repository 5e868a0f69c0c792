"""Fork-server ("zygote") for chipless pool workers.

Counterpart of the reference's pre-started worker-pool processes
(reference: src/ray/raylet/worker_pool.h:224 — the raylet keeps warm
workers so task/actor assignment costs one RPC, not an interpreter
start). A fresh ``python -m ray_tpu_torch._private.worker`` pays the full
interpreter + package import (~300 ms; torch is not among the imports).
The zygote pays that ONCE: it imports the worker module single-threaded,
then forks a child per spawn request (~5 ms), which applies its
per-worker env and enters the normal worker main.

Only chipless workers fork from the zygote, which runs with
``CUDA_VISIBLE_DEVICES=""`` — GPU-capable workers start as fresh
interpreters, because CUDA fixes a process's visible devices when it
initialises and a forked CUDA context is unusable in the child.

Protocol (line-JSON over stdin/stdout):
    parent -> zygote: {"env": {...}, "log": "/path/worker.log"}
    zygote -> parent: {"pid": 12345}
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading


def main() -> None:
    # Reap forked workers (the zygote is their parent) AND preserve
    # their exit statuses for the crash-forensics plane: the head/agent
    # cannot waitpid a zygote child, so the real wait status — the
    # ground truth for "SIGSEGV vs OOM-kill vs clean exit"
    # classification — would be discarded with a plain SIG_IGN. Exits
    # append to a JSONL file the supervisor's classifier reads
    # (_private/forensics / ZygoteClient.exit_status). Python signal
    # handlers run at bytecode boundaries, so the file append is safe.
    exit_file = os.environ.get("RAY_TPU_ZYGOTE_EXIT_FILE")
    if exit_file:
        import time as _time

        def _reap(signum, frame):
            while True:
                try:
                    pid, status = os.waitpid(-1, os.WNOHANG)
                except ChildProcessError:
                    return
                if pid == 0:
                    return
                try:
                    with open(exit_file, "a") as f:
                        f.write(json.dumps({"pid": pid, "status": status,
                                            "ts": _time.time()}) + "\n")
                except OSError:
                    pass

        signal.signal(signal.SIGCHLD, _reap)
    else:
        signal.signal(signal.SIGCHLD, signal.SIG_IGN)
    # The heavy import, paid once. MUST stay single-threaded up to the
    # fork loop: forking a threaded process leaves dead locks behind.
    from ray_tpu_torch._private import worker as worker_mod

    sys.stdout.write("READY\n")
    sys.stdout.flush()
    for line in sys.stdin:
        if not line.strip():
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        pid = os.fork()
        if pid == 0:
            try:
                os.setsid()
                signal.signal(signal.SIGCHLD, signal.SIG_DFL)
                fd = os.open(req["log"],
                             os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
                os.dup2(fd, 1)
                os.dup2(fd, 2)
                os.close(fd)
                os.close(0)
                for k, v in req["env"].items():
                    os.environ[k] = str(v)
                worker_mod.main()
            except BaseException:  # noqa: BLE001 — child must never
                import traceback   # return into the zygote loop

                traceback.print_exc()
            finally:
                os._exit(0)
        sys.stdout.write(json.dumps({"pid": pid}) + "\n")
        sys.stdout.flush()


def _read_line_bounded(fd: int, timeout_s: float) -> str:
    """Read one newline-terminated line from a raw fd within a
    deadline; raises TimeoutError on ANY stall, including mid-line."""
    import select
    import time

    deadline = time.monotonic() + timeout_s
    buf = b""
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError("zygote fork reply timed out")
        r, _, _ = select.select([fd], [], [], remaining)
        if not r:
            raise TimeoutError("zygote fork reply timed out")
        chunk = os.read(fd, 4096)
        if not chunk:
            raise EOFError("zygote closed its stdout")
        buf += chunk
        if b"\n" in buf:
            return buf.split(b"\n", 1)[0].decode()


class ZygoteClient:
    """Lazily starts and talks to one zygote process. Thread-safe.
    ``spawn`` returns the worker pid, or None when the zygote path is
    unavailable (caller falls back to a direct Popen)."""

    def __init__(self, base_env: dict, log_dir: str):
        self._base_env = dict(base_env)
        self._log_dir = log_dir
        # Child exit statuses land here (see main()'s SIGCHLD handler);
        # exit_status() is the forensics plane's lookup. RAY_TPU_ prefix
        # so agent-side zygote forks forward it to grandchildren too.
        self.exit_file = os.path.join(log_dir, "zygote_exits.jsonl")
        self._base_env.setdefault("RAY_TPU_ZYGOTE_EXIT_FILE",
                                  self.exit_file)
        self._proc: subprocess.Popen | None = None
        # _lock guards the request channel + published state and is only
        # ever held for FAST operations (state flips, one fork
        # round-trip — bounded by _REPLY_TIMEOUT_S via select, so a
        # zygote that accepts a request and never replies costs at most
        # that before being declared dead). The slow warmup (Popen +
        # READY readline) runs in a dedicated thread holding NO lock —
        # state is published under _lock only at the end, and
        # ``on_ready`` fires (also lock-free) so the head's dispatch
        # loop can immediately retry spawns it deferred.
        self._lock = threading.Lock()
        self._failed = False
        self._stopped = False
        self._ready = threading.Event()
        self._warming = False
        self._warm_started_at: "float | None" = None
        self._direct_spawns_this_warmup = 0
        self.on_ready: "Callable[[], None] | None" = None

    def start_async(self) -> None:
        """Warm the zygote off the caller's thread: callers that hold
        hot locks (the head's dispatch path) must never block on the
        worker-module import; spawn() falls back to a direct Popen
        once the warmup grace window passes. Must not be called while
        holding self._lock."""
        import time

        with self._lock:
            if (self._warming or self._failed or self._stopped
                    or self._ready.is_set()):
                return
            self._warming = True
            # Re-anchored on EVERY warmup start (not just the first):
            # a re-warm after a zygote death needs its own full grace
            # window or burst callers all fall back to Popen storms.
            self._warm_started_at = time.monotonic()
            self._direct_spawns_this_warmup = 0
        threading.Thread(target=self._warmup, daemon=True,
                         name="zygote-warmup").start()

    def _warmup(self) -> None:
        """Slow path, lock-free: fork the zygote and wait for READY."""
        proc = None
        try:
            os.makedirs(self._log_dir, exist_ok=True)
            err = open(os.path.join(self._log_dir, "zygote.log"), "ab")
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.zygote"],
                env=self._base_env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=err,
                cwd=os.getcwd(),
                text=True,
            )
            err.close()
            ready = proc.stdout.readline()
            if ready.strip() != "READY":
                raise RuntimeError(f"zygote failed to start: {ready!r}")
        except Exception:
            try:
                if proc is not None:
                    proc.kill()
            except Exception:
                pass
            with self._lock:
                self._failed = True
                self._warming = False
            cb = self.on_ready
            if cb is not None:
                cb()  # deferred spawns must retry (and fall back) NOW
            return
        with self._lock:
            self._warming = False
            if self._stopped:
                # stop() raced the warmup: don't publish a process
                # nobody will ever reap.
                try:
                    proc.kill()
                except Exception:
                    pass
                return
            self._proc = proc
            self._ready.set()
        cb = self.on_ready
        if cb is not None:
            cb()

    def deferral_active(self) -> bool:
        """True when a spawn arriving mid-warmup should be DEFERRED
        (retried on ``on_ready``) instead of falling back to a direct
        Popen. Policy: the first few spawns of a warmup window go direct
        — a small cold cluster must not wait out the zygote import just
        to run 4 parallel tasks — but a BURST beyond that budget defers:
        N concurrent interpreter starts thrash a small box (measured: 40
        actor creations = 12 s as a Popen storm vs ~1 s deferred-then-
        forked). The caller (the head's dispatch loop) never blocks a
        lock waiting either way. Calling this counts one direct spawn
        against the window's budget when it returns False."""
        import time

        if self._ready.is_set() or self._failed or self._stopped:
            return False
        budget = int(os.environ.get("RAY_TPU_ZYGOTE_DIRECT_SPAWN_BUDGET",
                                    "4"))
        grace = float(os.environ.get("RAY_TPU_ZYGOTE_SPAWN_GRACE_S", "6"))
        with self._lock:
            if not self._warming or self._warm_started_at is None:
                return False
            if time.monotonic() >= self._warm_started_at + grace:
                return False
            if self._direct_spawns_this_warmup < budget:
                self._direct_spawns_this_warmup += 1
                return False
            return True

    _REPLY_TIMEOUT_S = 10.0  # fork replies take ~5 ms; 10 s = dead

    def spawn(self, extra_env: dict, log_path: str) -> "int | None":
        """Never blocks on warmup: returns None when the zygote is not
        READY. Callers check ``deferral_active()`` to decide between
        deferring (warmup imminent) and a direct-Popen fallback."""
        if not self._ready.is_set():
            if not self._failed and not self._stopped:
                self.start_async()
            return None
        rewarm = False
        pid = None
        with self._lock:
            if self._proc is None or self._proc.poll() is not None:
                # Died since READY: re-warm off-thread (outside the
                # lock — start_async takes it), caller falls back.
                self._ready.clear()
                self._proc = None
                rewarm = not self._failed and not self._stopped
            else:
                try:
                    self._proc.stdin.write(
                        json.dumps({"env": extra_env,
                                    "log": log_path}) + "\n")
                    self._proc.stdin.flush()
                    # Bounded read: a zygote that accepted the request
                    # but never replies (or stalls mid-line) must not
                    # wedge this lock (and the head dispatch thread
                    # behind it) forever. Raw-fd select+read loop up to
                    # the deadline — a buffered readline would block
                    # past select() on a PARTIAL line. The warmup
                    # readline consumed exactly the READY line, so the
                    # buffered reader holds no reply bytes.
                    reply = _read_line_bounded(
                        self._proc.stdout.fileno(), self._REPLY_TIMEOUT_S)
                    pid = int(json.loads(reply)["pid"])
                except Exception:
                    # Zygote died mid-request: restart attempt next call.
                    try:
                        self._proc.kill()
                    except Exception:
                        pass
                    self._proc = None
                    self._ready.clear()
        if rewarm:
            self.start_async()
        return pid

    def exit_status(self, pid: int, wait_s: float = 0.0) -> "int | None":
        """The raw waitpid status of a zygote-forked worker, or None if
        its exit was never recorded (zygote predates the exit file, or
        the child is still alive). ``wait_s`` bounds a short poll: the
        SIGCHLD append races the supervisor noticing the death by a few
        milliseconds."""
        import time

        deadline = time.monotonic() + max(0.0, wait_s)
        while True:
            status = None
            try:
                with open(self.exit_file) as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if rec.get("pid") == pid:
                            status = rec.get("status")
            except OSError:
                pass
            if status is not None or time.monotonic() >= deadline:
                return status
            time.sleep(0.05)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._proc is not None:
                try:
                    self._proc.kill()
                except Exception:
                    pass
                self._proc = None


if __name__ == "__main__":
    main()
