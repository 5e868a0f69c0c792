"""ActorPool: load-balance tasks over a fixed set of actors.

Counterpart of the reference's ray.util.ActorPool (util/actor_pool.py:13):
submit/get_next/get_next_unordered plus map/map_unordered convenience."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: list):
        if not actors:
            raise ValueError("ActorPool requires at least one actor")
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list[tuple[Callable, Any]] = []

    # -- submission --------------------------------------------------------

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef. Queues if all actors are busy."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    # -- retrieval ---------------------------------------------------------

    def _return_actor(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order. On timeout, pool state is left
        untouched (the task is still running; retry get_next later)."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        if not self.has_next():
            raise StopIteration("no pending results")
        ref = self._index_to_future[self._next_return_index]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise TimeoutError("get_next timed out; task still running") from None
        except Exception:
            # Task FAILED (completed with error): the actor is free again.
            del self._index_to_future[self._next_return_index]
            self._next_return_index += 1
            self._return_actor(ref)
            raise
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(ref)
        return value

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Whichever pending result finishes first."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._index_to_future.values()),
                                num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut is ref or fut.hex() == ref.hex():
                del self._index_to_future[idx]
                break
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._return_actor(ref)

    # -- bulk --------------------------------------------------------------

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
