"""Session log-directory helpers shared by the head's `log_index`/
`log_tail` RPCs and the dashboard's /api/logs endpoints (reference:
dashboard/modules/log — one log module behind both the CLI and UI)."""

from __future__ import annotations

import os

TAIL_LINE_CAP = 500


def log_index(logs_dir: "str | None") -> list[dict]:
    """[{name, bytes}] for every *.log in the session logs dir."""
    if not logs_dir or not os.path.isdir(logs_dir):
        return []
    out = []
    for name in sorted(os.listdir(logs_dir)):
        if name.endswith(".log"):
            try:
                size = os.path.getsize(os.path.join(logs_dir, name))
            except OSError:
                size = 0
            out.append({"name": name[:-4], "bytes": size})
    return out


def log_tail(logs_dir: "str | None", name: str,
             max_bytes: int = 64 * 1024) -> dict:
    """Last lines of one log. `name` is path-sanitized: log names never
    contain separators, so any traversal attempt yields an empty tail."""
    if not logs_dir or "/" in name or ".." in name:
        return {"name": name, "lines": []}
    path = os.path.join(logs_dir, f"{name}.log")
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - max_bytes))
            text = f.read().decode("utf-8", errors="replace")
    except OSError:
        return {"name": name, "lines": []}
    return {"name": name, "lines": text.splitlines()[-TAIL_LINE_CAP:]}
