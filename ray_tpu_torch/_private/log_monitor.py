"""Driver-side worker log streaming.

Counterpart of the reference's log monitor
(reference: python/ray/_private/log_monitor.py — a per-node process tails
worker log files and publishes lines to the driver, which prints them
prefixed with the worker that wrote them; ray.init(log_to_driver=True)).
Redesign: the single-node head already collects every worker's
stdout/stderr into ``<session>/logs/<worker>.log``, so a daemon thread in
the driver tails that directory directly — no pubsub hop for the local
case. Remote nodes' logs stay on their host (reachable via the dashboard
log endpoints), matching the reference's per-node monitor scope.
"""

from __future__ import annotations

import os
import sys
import threading
import time


class LogMonitor:
    """Tails ``logs_dir/*.log`` and mirrors new lines to this process's
    stdout as ``(worker-ab12ef) line``."""

    def __init__(self, logs_dir: str, interval_s: float = 0.3,
                 out=None):
        self.logs_dir = logs_dir
        self.interval_s = interval_s
        self.out = out or sys.stdout
        self._offsets: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="ray_tpu_torch-log-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                pass  # the monitor must never take the driver down
            self._stop.wait(self.interval_s)
        # Final sweep so lines written right before shutdown still show.
        try:
            self.poll_once()
        except Exception:
            pass

    def poll_once(self) -> int:
        """Read new bytes from every log file; returns lines emitted."""
        emitted = 0
        if not os.path.isdir(self.logs_dir):
            return 0
        for name in sorted(os.listdir(self.logs_dir)):
            if not name.endswith(".log"):
                continue
            path = os.path.join(self.logs_dir, name)
            tag = name[:-4]
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            offset = self._offsets.get(name, 0)
            if size < offset:
                # Truncated/recreated file: restart from the beginning.
                offset = 0
                self._offsets[name] = 0
            if size <= offset:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(size - offset)
            except OSError:
                continue
            # Only consume complete lines; partial tails wait for the
            # next poll.
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue
            self._offsets[name] = offset + last_nl + 1
            for line in chunk[: last_nl + 1].splitlines():
                text = line.decode("utf-8", errors="replace")
                self.out.write(f"({tag}) {text}\n")
                emitted += 1
        if emitted:
            try:
                self.out.flush()
            except Exception:
                pass
        return emitted
