"""Distributed Queue backed by an actor.

Counterpart of the reference's ray.util.queue.Queue (util/queue.py:21):
a named-or-anonymous queue actor shared across drivers/workers, with
blocking put/get via short polling (the actor itself never blocks its
executor thread indefinitely)."""

from __future__ import annotations

import collections
import time
from typing import Any, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: collections.deque = collections.deque()

    def qsize(self) -> int:
        return len(self.items)

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def put_many(self, items: list) -> int:
        n = 0
        for it in items:
            if not self.put(it):
                break
            n += 1
        return n

    def put_many_atomic(self, items: list) -> bool:
        """All-or-nothing insert (capacity checked before mutating)."""
        if self.maxsize > 0 and len(self.items) + len(items) > self.maxsize:
            return False
        self.items.extend(items)
        return True

    def get(self, n: int = 1) -> tuple[list, bool]:
        if not self.items:
            return [], False
        out = [self.items.popleft() for _ in range(min(n, len(self.items)))]
        return out, True

    def get_exact(self, n: int) -> tuple[list, bool]:
        """All-or-nothing batch pop (reference get_nowait_batch semantics)."""
        if len(self.items) < n:
            return [], False
        return [self.items.popleft() for _ in range(n)], True


class Queue:
    def __init__(self, maxsize: int = 0, *, actor_options: dict | None = None):
        ray_tpu_torch.api.auto_init()
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self._actor = ray_tpu_torch.remote(**opts)(_QueueActor).remote(maxsize)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def put(self, item: Any, block: bool = True, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self._actor.put.remote(item)):
                return
            if not block:
                raise Full("queue is full")
            if deadline is not None and time.monotonic() > deadline:
                raise Full("queue put timed out")
            time.sleep(0.05)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            items, ok = ray_tpu_torch.get(self._actor.get.remote(1))
            if ok:
                return items[0]
            if not block:
                raise Empty("queue is empty")
            if deadline is not None and time.monotonic() > deadline:
                raise Empty("queue get timed out")
            time.sleep(0.05)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, n: int) -> list:
        items, ok = ray_tpu_torch.get(self._actor.get_exact.remote(n))
        if not ok:
            raise Empty(f"queue holds fewer than {n} items")
        return items

    def put_nowait_batch(self, items: list) -> None:
        if not ray_tpu_torch.get(self._actor.put_many_atomic.remote(list(items))):
            raise Full(f"queue lacks capacity for {len(items)} items")

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass
