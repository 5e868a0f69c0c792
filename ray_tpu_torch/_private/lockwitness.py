"""Runtime lock-order witness (``RAY_TPU_LOCK_WITNESS=1``).

The static half of deadlock defense is rtlint's RT-L003 (lexical
with-nesting order cycles); it cannot see orders composed across
callbacks, threads started late, or locks taken through function
pointers. This module is the dynamic half, in the spirit of FreeBSD's
``witness(4)``: wrap every lock the *runtime* allocates, maintain a
live acquisition-order graph keyed by the lock's allocation site, and
the first time an edge closes a cycle, capture the evidence. A cycle
in the order graph is a potential deadlock even if the interleaving
that would wedge never happened in this run — that is the whole point:
the witness turns "we got lucky" into a failing test.

Scope discipline: only locks allocated FROM ray_tpu_torch (or tools/tests)
frames are wrapped — the factory checks the caller's frame at
construction, so stdlib and third-party locks (including the RLock
``threading.Condition`` makes for itself) pay nothing. Wrapped RLocks
proxy ``_is_owned``/``_acquire_restore``/``_release_save`` so
``threading.Condition(existing_lock)`` keeps working, with the witness
stack kept honest across ``wait()`` (the condition releases the lock
while parked; the witness must not think it is still held).

Cost when armed: one frame peek per acquire plus a held-list scan
(held lists are 1-2 deep in practice); a full traceback is captured
only when a NEVER-SEEN edge appears, which converges to zero in
steady state. Cost when not armed: zero — nothing is patched.

Enabled for the whole tier-1 suite via tests/conftest.py; the session
fails if any cycle was observed anywhere in the run.
"""

from __future__ import annotations

import _thread
import contextlib
import os
import sys
import threading
import traceback

_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
# Another witness patched the factories first: ray_tpu's, in a process
# that imports both packages (the tests do). Its factory reads its
# caller's frame, so wrapping it would hide the real caller from it;
# this witness stays out of such a process and that one keeps watching.
_FOREIGN = _ORIG_LOCK is not _thread.allocate_lock

_state_lock = _ORIG_LOCK()  # guards the order graph + cycle list
# (allocation site A, allocation site B) -> sample: the stack that
# first acquired B while holding A, plus where A had been acquired.
_edges: "dict[tuple[str, str], dict]" = {}
_cycles: "list[dict]" = []
_cycle_keys: "set[frozenset]" = set()
_tls = threading.local()
_installed = False


@contextlib.contextmanager
def _state():
    """Hold _state_lock, marking this thread as inside the witness's own
    bookkeeping. What runs meanwhile can allocate, and so run a garbage
    collection whose finalizers take watched locks (ObjectRef.__del__
    does) on this very thread: those acquisitions must not record edges,
    which would take the non-reentrant _state_lock again and deadlock."""
    _tls.in_state = True
    try:
        with _state_lock:
            yield
    finally:
        _tls.in_state = False

_SEP = os.sep
_PKG_MARKERS = (f"{_SEP}ray_tpu_torch{_SEP}", f"{_SEP}tools{_SEP}",
                f"{_SEP}tests{_SEP}")


def _should_wrap(filename: str) -> bool:
    if filename.endswith("lockwitness.py"):
        return False
    return any(m in filename for m in _PKG_MARKERS)


def _held() -> "list[tuple[str, str]]":
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _note_acquired(site: str, where: str) -> None:
    held = _held()
    if any(h == site for h, _ in held):
        # re-entrant RLock acquire: the order was established by the
        # outermost acquire; inner ones add no edges
        held.append((site, where))
        return
    for h, h_where in held:
        _record_edge(h, h_where, site, where)
    held.append((site, where))


def _note_released(site: str) -> None:
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == site:
            del held[i]
            return


def _record_edge(a: str, a_where: str, b: str, b_where: str) -> None:
    if getattr(_tls, "in_state", False):
        return  # a finalizer inside the witness's bookkeeping (_state)
    key = (a, b)
    with _state():
        if key in _edges:
            return
        _edges[key] = {
            "holder_acquired_at": a_where,
            "acquiring_at": b_where,
            "stack": traceback.format_stack(sys._getframe(3), 24),
        }
        path = _path(b, a)
    if path is not None:
        _note_cycle([a] + path)


def _path(src: str, dst: str) -> "list[str] | None":
    """Order-graph path src..dst (caller holds _state_lock)."""
    adj: "dict[str, list[str]]" = {}
    for (x, y) in _edges:
        adj.setdefault(x, []).append(y)
    stack = [(src, [src])]
    seen: set = set()
    while stack:
        n, path = stack.pop()
        if n == dst:
            return path
        if n in seen:
            continue
        seen.add(n)
        for m in adj.get(n, ()):
            if m not in seen:
                stack.append((m, path + [m]))
    return None


def _note_cycle(sites: "list[str]") -> None:
    # sites is already closed: [a, b, ..., a]
    pairs = [p for p in zip(sites, sites[1:]) if p[0] != p[1]]
    key = frozenset(pairs)
    with _state():
        if key in _cycle_keys:
            return
        _cycle_keys.add(key)
        _cycles.append({
            "sites": sites,
            "edges": {f"{a} -> {b}": dict(_edges[(a, b)])
                      for a, b in pairs if (a, b) in _edges},
        })


class _WitnessLock:
    """threading.Lock wearing the witness. Attribute protocol matches
    the real lock closely enough for Condition's fallbacks (a plain
    lock has no _release_save, so Condition uses acquire/release —
    which go through us)."""

    __slots__ = ("_lock", "_site")

    def __init__(self, lock, site: str):
        self._lock = lock
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            f = sys._getframe(1)
            _note_acquired(self._site,
                           f"{f.f_code.co_filename}:{f.f_lineno}")
        return got

    def release(self):
        self._lock.release()
        _note_released(self._site)

    def locked(self):
        return self._lock.locked()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<witness({self._site}) {self._lock!r}>"


class _WitnessRLock(_WitnessLock):
    """RLock variant: proxies the Condition save/restore protocol so
    Condition(wrapped_rlock).wait() keeps the held-stack honest."""

    __slots__ = ()

    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        state = self._lock._release_save()
        _note_released(self._site)
        return state

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        f = sys._getframe(1)
        _note_acquired(self._site,
                       f"{f.f_code.co_filename}:{f.f_lineno}")


def _lock_factory():
    lock = _ORIG_LOCK()
    f = sys._getframe(1)
    if _should_wrap(f.f_code.co_filename):
        return _WitnessLock(lock,
                            f"{f.f_code.co_filename}:{f.f_lineno}")
    return lock


def _rlock_factory():
    lock = _ORIG_RLOCK()
    f = sys._getframe(1)
    if _should_wrap(f.f_code.co_filename):
        return _WitnessRLock(lock,
                             f"{f.f_code.co_filename}:{f.f_lineno}")
    return lock


def install() -> None:
    """Patch the threading lock factories. Idempotent. Must run before
    the modules whose locks should be watched allocate them — the
    package __init__ calls this first thing when the env knob is set,
    so spawned workers (which inherit the environment) arm themselves
    at import."""
    global _installed
    if _installed or _FOREIGN:
        return
    _installed = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory


def enabled_via_env() -> bool:
    return os.environ.get("RAY_TPU_LOCK_WITNESS", "").strip().lower() \
        in ("1", "true", "on", "yes")


def maybe_install() -> None:
    if enabled_via_env():
        install()


def installed() -> bool:
    return _installed


def cycles() -> "list[dict]":
    with _state():
        return list(_cycles)


def edge_count() -> int:
    with _state():
        return len(_edges)


def report() -> str:
    """Human-readable cycle report: every edge of every cycle with the
    stack that created it (the acquire of the later lock while the
    earlier one was held) and where the earlier one had been taken."""
    cs = cycles()
    if not cs:
        return "lock witness: no acquisition-order cycles observed\n"
    lines = [f"lock witness: {len(cs)} acquisition-order cycle(s) — "
             f"potential deadlock(s)\n"]
    for i, c in enumerate(cs):
        lines.append(f"cycle {i + 1}: " + " -> ".join(c["sites"]))
        for edge, info in c["edges"].items():
            lines.append(f"  edge {edge}")
            lines.append(f"    earlier lock acquired at "
                         f"{info['holder_acquired_at']}")
            lines.append(f"    later lock acquired at "
                         f"{info['acquiring_at']}, stack:")
            for frame in info["stack"]:
                for ln in frame.rstrip("\n").splitlines():
                    lines.append(f"      {ln}")
    return "\n".join(lines) + "\n"


def reset() -> None:
    """Forget all observed edges and cycles (tests)."""
    with _state():
        _edges.clear()
        _cycles.clear()
        _cycle_keys.clear()


def uninstall() -> None:
    """Restore the real factories (tests). Already-wrapped locks stay
    wrapped — they are still valid locks."""
    global _installed
    if not _installed:
        return
    _installed = False
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
