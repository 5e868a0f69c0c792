"""Loader seam for the native event-loop core (src/eventloop/).

Mirrors wirefmt's codec seam: the compiled ``_evloop.so`` is built on
demand by native_build and loaded lazily; every consumer goes through
:func:`lane_enabled` so one check gates the whole native lane. The
module is REJECTED (not just unused) if its compiled-in wire version or
kind table disagrees with wirefmt — a stale .so must never speak a
different dialect than the Python side thinks it does (the rtlint RT-W
pass enforces the same invariant statically on the C source).

Kill switches, strictest wins:
  RAY_TPU_NATIVE=0        — whole native lane (shared with specenc)
  RAY_TPU_NATIVE_LOOP=0   — just this event loop (Config.native_loop)
  RAY_TPU_WIRE_BINARY=0   — binary wire off implies no native lane
    (the lane's cast coalescer only speaks the tagged binary format)

Sharded head note (head_shards.py): sockets that reach a dispatch
shard via SCM_RIGHTS fd-passing are adopted through
``Server.adopt_socket`` and arm the lane exactly like accept()ed ones —
the lane binds by fileno(), so a router-handed fd is indistinguishable
from a locally accepted one. Each shard process loads its OWN copy of
``_evloop.so``; the wire-version handshake above keeps a stale artifact
in one shard from speaking a different dialect than its siblings.
"""

from __future__ import annotations

import atexit
import threading

from ray_tpu_torch._private import wirefmt

_lock = threading.Lock()
_mod = None
_tried = False


def _load():
    """Import build/ray_tpu_torch/native/_evloop.so; None when missing/mismatched."""
    global _mod, _tried
    with _lock:
        if _tried:
            return _mod
        _tried = True
        if wirefmt.native_disabled():
            return None
        try:
            from ray_tpu_torch._private import native_build

            native_build.ensure_native()
            import importlib.util
            import os

            path = os.path.join(native_build._OUT, "_evloop.so")
            if not os.path.exists(path):
                return None
            spec = importlib.util.spec_from_file_location("_evloop", path)
            if spec is None or spec.loader is None:
                return None
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if (getattr(mod, "WIRE_VERSION", None) != wirefmt.WIRE_VERSION
                    or mod.kind_codes() != wirefmt.KIND_CODES):
                return None  # stale artifact speaking an old dialect
            _mod = mod
            # Interpreter teardown kills GIL-seeking C threads hard
            # (PyThread_exit_thread); closing every lane first narrows
            # that window to idle threads parked in recv/cond_wait.
            atexit.register(mod.shutdown_all)
        except Exception:
            _mod = None
        return _mod


def module():
    """The loaded _evloop module, or None. Never raises."""
    return _mod if _tried else _load()


def lane_enabled() -> bool:
    """True when a new Connection should arm the native fast lane."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG as cfg

    if not (cfg.native_loop and cfg.wire_binary):
        return False
    if wirefmt.native_disabled():
        return False
    return module() is not None
