"""Identifiers for objects, tasks, actors, nodes, placement groups.

Counterpart of the reference's ID types (reference: src/ray/common/id.h,
python/ray/includes/unique_ids.pxi). 16 random bytes, hex-rendered.

ObjectRef carries an `owned` bit: the process that created the ref (the
owner, reference: src/ray/core_worker/reference_count.h:72) decrements the
owner refcount on GC. Deserialized copies are BORROWS (reference:
reference_count.h borrower bookkeeping): deserialization registers the
borrow with this process's runtime (which tells the head directory), and
the borrowed ref's GC releases it. In-flight windows — args en route to a
worker, payloads being read — are covered by head-side task/read pinning;
at-rest containment (a ref serialized inside a stored object) is covered
by the directory's container pins. Together: an object lives while any
process holds a deserialized ref, any sealed object embeds it, or any
in-flight task references it.
"""

from __future__ import annotations

import os
import threading
from typing import Callable


# Fast unique ids: a per-process random 16-hex prefix + a 16-hex counter
# renders in ~0.3 us vs ~5 us for uuid4 — at flood submission rates
# (2 ids per task) id generation alone was ~5% of the per-task budget.
# Uniqueness: prefix collisions across processes are 2^-64-scale, the
# counter handles within-process.
_ID_PREFIX = os.urandom(8).hex()
_id_counter = iter(range(1, 1 << 62)).__next__
_ID_FMT = (_ID_PREFIX + "%016x").__mod__


def _hex_id() -> str:
    return _ID_FMT(_id_counter())


def fast_hex_id() -> str:
    """32-hex unique id (shared generator with ObjectRef ids)."""
    return _ID_FMT(_id_counter())


def _reseed_after_fork() -> None:
    """A forked child inherits prefix AND counter state — both must
    change or parent and child mint identical ids."""
    global _ID_PREFIX, _id_counter, _ID_FMT
    _ID_PREFIX = os.urandom(8).hex()
    _id_counter = iter(range(1, 1 << 62)).__next__
    _ID_FMT = (_ID_PREFIX + "%016x").__mod__


os.register_at_fork(after_in_child=_reseed_after_fork)


class BaseID:
    __slots__ = ("_hex",)
    _kind = "id"

    def __init__(self, hex_str: str | None = None):
        self._hex = hex_str or _hex_id()

    def hex(self) -> str:
        return self._hex

    def __eq__(self, other):
        return type(other) is type(self) and other._hex == self._hex

    def __hash__(self):
        return hash((self._kind, self._hex))

    def __repr__(self):
        return f"{type(self).__name__}({self._hex[:12]})"

    def __reduce__(self):
        return (type(self), (self._hex,))


class TaskID(BaseID):
    _kind = "task"


class ActorID(BaseID):
    _kind = "actor"


class NodeID(BaseID):
    _kind = "node"


class PlacementGroupID(BaseID):
    _kind = "pg"


# Registered at runtime by the worker/driver core so ObjectRef GC can notify
# the owner directory without an import cycle.
_ref_removed_callback: Callable[[str], None] | None = None
_borrow_added_callback: Callable[[str], None] | None = None
_borrow_removed_callback: Callable[[str], None] | None = None
_ref_lock = threading.Lock()


def set_ref_removed_callback(cb: Callable[[str], None] | None) -> None:
    global _ref_removed_callback
    with _ref_lock:
        _ref_removed_callback = cb


def set_borrow_callbacks(added: Callable[[str], None] | None,
                         removed: Callable[[str], None] | None) -> None:
    """Installed by CoreRuntime: `added` fires when a ref is deserialized
    in this process (a borrow begins), `removed` when a borrowed ref is
    GC'd (the borrow ends). Reference: reference_count.h:72 borrower
    registration / WaitForRefRemoved."""
    global _borrow_added_callback, _borrow_removed_callback
    with _ref_lock:
        _borrow_added_callback = added
        _borrow_removed_callback = removed


def _restore_ref(hex_str: str) -> "ObjectRef":
    """Unpickle target for ObjectRef: the deserialized copy is a borrow,
    registered with the local runtime so the head keeps the object alive
    until this process drops it (or dies)."""
    with _ref_lock:
        cb = _borrow_added_callback
    if cb is None:
        # No runtime in this process (head unpickling specs, plain
        # tooling): an inert ref with no lifetime participation.
        return ObjectRef(hex_str)
    ref = ObjectRef(hex_str, _borrowed=True)
    try:
        cb(hex_str)
    except Exception:
        ref._borrowed = False  # never release a borrow that never registered
    return ref


class ObjectRef:
    """Future-like handle to an object in the cluster.

    Reference analogue: python/ray/includes/object_ref.pxi + ownership
    semantics from src/ray/core_worker/reference_count.h.
    """

    __slots__ = ("_hex", "_owned", "_borrowed", "__weakref__")

    def __init__(self, hex_str: str | None = None, *, _owned: bool = False,
                 _borrowed: bool = False):
        self._hex = hex_str or _hex_id()
        self._owned = _owned
        self._borrowed = _borrowed

    def hex(self) -> str:
        return self._hex

    def is_owned(self) -> bool:
        return self._owned

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._hex == self._hex

    def __hash__(self):
        return hash(("obj", self._hex))

    def __repr__(self):
        return f"ObjectRef({self._hex[:12]})"

    def __reduce__(self):
        # Deserialized copies are borrows: the restore hook registers
        # them with the receiving process's runtime, which keeps the
        # owner count from releasing the object while they live.
        return (_restore_ref, (self._hex,))

    def __del__(self):
        try:
            if self._owned:
                with _ref_lock:
                    cb = _ref_removed_callback
                if cb is not None:
                    cb(self._hex)
            elif self._borrowed:
                with _ref_lock:
                    cb = _borrow_removed_callback
                if cb is not None:
                    cb(self._hex)
        except Exception:
            # Interpreter teardown: module globals may already be None.
            pass

    # Allow `ray_tpu_torch.get(ref)` ergonomics in asyncio contexts later.
    def future(self):
        from ray_tpu_torch._private.worker_context import global_runtime

        return global_runtime().get_async(self)
