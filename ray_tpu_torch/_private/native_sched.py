"""ctypes binding for the C++ scheduler core (src/scheduler/scheduler.cc).

The Python ClusterScheduler mirrors membership and resource mutations into
this core and delegates pick_node; when the shared library is missing
(source checkout without `make -C src`) everything silently stays on the
pure-Python path.
"""

from __future__ import annotations

import ctypes
import os

from ray_tpu_torch._private.scheduler import GRANULARITY as _FP  # shared fp scale


def _load():
    from ray_tpu_torch._private.native_build import _OUT, ensure_native

    path = os.path.join(_OUT, "libsched.so")

    ensure_native()  # also rebuilds when sources are newer than the .so
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.sched_create.restype = ctypes.c_void_p
    lib.sched_create.argtypes = [ctypes.c_double]
    lib.sched_destroy.argtypes = [ctypes.c_void_p]
    lib.sched_add_node.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sched_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.sched_set_alive.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.sched_acquire.restype = ctypes.c_int
    lib.sched_acquire.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sched_release.argtypes = lib.sched_acquire.argtypes
    lib.sched_pick_node.restype = ctypes.c_int64
    lib.sched_pick_node.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.sched_utilization.restype = ctypes.c_double
    lib.sched_utilization.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.sched_num_nodes.restype = ctypes.c_int64
    lib.sched_num_nodes.argtypes = [ctypes.c_void_p]
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


class NativeScheduler:
    """One native core instance; NOT thread-safe by itself — callers hold
    the head lock (the same discipline as the Python tables it mirrors)."""

    def __init__(self, spread_threshold: float):
        if _lib is None:
            raise RuntimeError("libsched.so not built (make -C src)")
        self._h = _lib.sched_create(ctypes.c_double(spread_threshold))
        self._res_ids: dict[str, int] = {}  # interned resource names
        self._node_keys: dict[str, int] = {}
        self._key_nodes: dict[int, str] = {}
        self._next_key = 0
        self._destroy = _lib.sched_destroy  # bound for __del__ at teardown

    def _rid(self, name: str) -> int:
        rid = self._res_ids.get(name)
        if rid is None:
            rid = len(self._res_ids)
            self._res_ids[name] = rid
        return rid

    def _vec(self, resources: dict[str, float]):
        n = len(resources)
        ids = (ctypes.c_uint32 * n)()
        amts = (ctypes.c_int64 * n)()
        for i, (k, v) in enumerate(resources.items()):
            ids[i] = self._rid(k)
            amts[i] = int(round(v * _FP))
        return n, ids, amts

    def add_node(self, node_id: str, total: dict[str, float],
                 available_res: dict[str, float]) -> None:
        key = self._node_keys.get(node_id)
        if key is None:
            key = self._next_key
            self._next_key += 1
            self._node_keys[node_id] = key
            self._key_nodes[key] = node_id
        n, ids, totals = self._vec(total)
        # The available vector shares total's id layout.
        avails = (ctypes.c_int64 * n)()
        for i, k in enumerate(total.keys()):
            avails[i] = int(round(available_res.get(k, 0.0) * _FP))
        _lib.sched_add_node(self._h, key, node_id.encode(), n, ids, totals, avails)

    def remove_node(self, node_id: str) -> None:
        key = self._node_keys.pop(node_id, None)
        if key is not None:
            self._key_nodes.pop(key, None)
            _lib.sched_remove_node(self._h, key)

    def set_alive(self, node_id: str, alive: bool) -> None:
        key = self._node_keys.get(node_id)
        if key is not None:
            _lib.sched_set_alive(self._h, key, int(alive))

    def acquire(self, node_id: str, demand: dict[str, float]) -> bool:
        key = self._node_keys.get(node_id)
        if key is None:
            return False
        n, ids, amts = self._vec(demand)
        return bool(_lib.sched_acquire(self._h, key, n, ids, amts))

    def release(self, node_id: str, demand: dict[str, float]) -> None:
        key = self._node_keys.get(node_id)
        if key is None:
            return
        n, ids, amts = self._vec(demand)
        _lib.sched_release(self._h, key, n, ids, amts)

    def pick_node(self, demand: dict[str, float], spread: bool) -> str | None:
        n, ids, amts = self._vec(demand)
        key = _lib.sched_pick_node(self._h, n, ids, amts, 1 if spread else 0)
        if key < 0:
            return None
        return self._key_nodes.get(key)

    def utilization(self, node_id: str) -> float:
        key = self._node_keys.get(node_id)
        if key is None:
            return -1.0
        return _lib.sched_utilization(self._h, key)

    def num_nodes(self) -> int:
        return int(_lib.sched_num_nodes(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
