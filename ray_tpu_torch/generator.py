"""Streaming generator returns: ObjectRefGenerator.

Counterpart of the reference's streaming generators (reference:
src/ray/protobuf/core_worker.proto:402 ReportGeneratorItemReturns;
python/ray/_raylet.pyx:1108,1359,1402 streaming generator execution and
ObjectRefGenerator). TPU-native design: instead of a dedicated
item-report RPC stream, the executing worker ``put``s each yielded item
under a deterministic id derived from the task id
(``{task_id}:g{index}``) and finally seals the task's single return
object with the item count. The consumer side blocks on
``wait([item, done])`` so a task failure (error sealed into the done
object by the normal failure path) unblocks and raises immediately.
"""

from __future__ import annotations

from typing import Iterator

from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.worker_context import global_runtime


def item_object_id(task_id: str, index: int) -> str:
    return f"{task_id}:g{index}"


class ObjectRefGenerator:
    """Iterator of ObjectRefs produced by a streaming-generator task.

    ``next()`` returns the next item's ObjectRef as soon as the executing
    worker has produced it (before the task finishes), mirroring the
    reference's ObjectRefGenerator semantics. If the task raises, the
    error surfaces from ``next()`` once already-produced items are
    consumed.
    """

    def __init__(self, task_id: str, done_ref: ObjectRef):
        self._task_id = task_id
        self._done = done_ref
        self._index = 0
        self._count: int | None = None

    def __iter__(self) -> Iterator[ObjectRef]:
        return self

    def __next__(self) -> ObjectRef:
        rt = global_runtime()
        i = self._index
        if self._count is not None:
            if i >= self._count:
                raise StopIteration
            self._index += 1
            return ObjectRef(item_object_id(self._task_id, i), _owned=True)
        item = ObjectRef(item_object_id(self._task_id, i), _owned=True)
        while True:
            ready, _ = rt.wait([item, self._done], num_returns=1, timeout=None)
            if item in ready:
                self._index += 1
                return item
            # The done object resolved first: either the generator finished
            # (value = item count, all items already stored) or the task
            # failed (get raises the task's error).
            self._count = int(rt.get(self._done))
            if i >= self._count:
                raise StopIteration
            # count > i: the item was stored before done was sealed; the
            # next wait() round returns it.

    next = __next__

    async def next_ref_async(self) -> "ObjectRef | None":
        """Async analogue of __next__: awaits head-pushed readiness
        instead of parking a thread in wait(). Returns None at
        end-of-stream (StopIteration cannot cross a coroutine). Task
        failures raise here once produced items are consumed."""
        import asyncio

        rt = global_runtime()
        i = self._index
        if self._count is not None:
            if i >= self._count:
                return None
            self._index += 1
            return ObjectRef(item_object_id(self._task_id, i), _owned=True)
        item = ObjectRef(item_object_id(self._task_id, i), _owned=True)
        while True:
            ready = await asyncio.wrap_future(
                rt.wait_async([item, self._done], num_returns=1))
            if item in ready:
                self._index += 1
                return item
            self._count = int(await asyncio.wrap_future(
                rt.get_async(self._done)))
            if i >= self._count:
                return None

    def completed(self) -> ObjectRef:
        """Ref sealed when the generator task finishes (int item count)."""
        return self._done

    def task_id(self) -> str:
        return self._task_id

    def __reduce__(self):
        return (ObjectRefGenerator, (self._task_id, self._done))

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id}, next={self._index})"


# Back-compat aliases matching the reference's public names.
DynamicObjectRefGenerator = ObjectRefGenerator
StreamingObjectRefGenerator = ObjectRefGenerator
