"""The exceptions the port raises that callers catch by type (the port's
own copies of ray_tpu/exceptions.py's classes, of the same names and
bases, so that code written for ray_tpu catches them the same way)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskTimeoutError(RayTpuError, TimeoutError):
    """A request's deadline expired before it finished. ``where`` names
    the hop that shed it (``"llm_decode"``: AsyncLLMEngine evicted it from
    the running batch)."""

    def __init__(self, message: str, *, task_id: str | None = None,
                 where: str | None = None):
        self.task_id = task_id
        self.where = where
        super().__init__(message)

    def __reduce__(self):
        return (_rebuild_task_timeout,
                (self.args[0] if self.args else "", self.task_id, self.where))


def _rebuild_task_timeout(message, task_id, where):
    return TaskTimeoutError(message, task_id=task_id, where=where)
