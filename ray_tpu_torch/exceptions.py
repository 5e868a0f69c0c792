"""User-facing exception types: the port's own copies of
ray_tpu/exceptions.py's classes, of the same names and bases, so that
code written for ray_tpu catches them the same way.

Counterpart of the reference's python/ray/exceptions.py (RayTaskError,
RayActorError, ObjectLostError, GetTimeoutError, WorkerCrashedError, ...).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception remotely; re-raised at `get`.

    Reference analogue: ray.exceptions.RayTaskError — carries the remote
    traceback string so the user sees the true failure site.
    """

    def __init__(self, cause_repr: str, remote_traceback: str, task_name: str = ""):
        self.cause_repr = cause_repr
        self.remote_traceback = remote_traceback
        self.task_name = task_name
        super().__init__(
            f"task {task_name or '<unknown>'} failed: {cause_repr}\n"
            f"--- remote traceback ---\n{remote_traceback}"
        )

    def __reduce__(self):
        return (TaskError, (self.cause_repr, self.remote_traceback, self.task_name))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    """Base for actor-related failures."""


class ActorDiedError(ActorError):
    """The actor is dead; pending and future calls fail with this."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class ObjectLostError(RayTpuError):
    """The object's value was lost and could not be reconstructed.

    Carries provenance when the runtime knows it (reference analogue:
    ray.exceptions.ObjectLostError's object_ref_hex/owner context):
    which object, which node hosted the payload, who owned it — so a
    node-death loss reads as "lost with node-X" instead of a bare hang
    or an anonymous timeout.
    """

    def __init__(self, message: str, *, object_id: str | None = None,
                 node_id: str | None = None, owner_id: str | None = None):
        self.object_id = object_id
        self.node_id = node_id
        self.owner_id = owner_id
        prov = ", ".join(
            f"{k}={v}" for k, v in (("object", object_id),
                                    ("node", node_id),
                                    ("owner", owner_id)) if v)
        super().__init__(f"{message} [{prov}]" if prov else message)
        self._message = message

    def __reduce__(self):
        return (_rebuild_object_lost,
                (self._message, self.object_id, self.node_id,
                 self.owner_id))


def _rebuild_object_lost(message, object_id, node_id, owner_id):
    return ObjectLostError(message, object_id=object_id, node_id=node_id,
                           owner_id=owner_id)


class ObjectStoreFullError(RayTpuError):
    """Allocation failed even after spilling."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get` exceeded its timeout."""


class TaskTimeoutError(RayTpuError, TimeoutError):
    """The task's deadline (``.options(timeout_s=...)`` or the
    ``task_timeout_s_default`` knob) expired before it finished.

    Expired work is SHED at every queue hop — owner-side direct queues,
    the head's ready/dep-blocked/actor queues, and the worker executor
    queue — so a saturated cluster stops burning capacity on results
    nobody can use anymore. ``where`` names the hop that shed the task
    (``"llm_decode"``: AsyncLLMEngine evicted it from the running batch).
    """

    def __init__(self, message: str, *, task_id: str | None = None,
                 where: str | None = None):
        self.task_id = task_id
        self.where = where
        super().__init__(message)

    def __reduce__(self):
        return (_rebuild_task_timeout,
                (self.args[0] if self.args else "", self.task_id,
                 self.where))


def _rebuild_task_timeout(message, task_id, where):
    return TaskTimeoutError(message, task_id=task_id, where=where)


class PendingCallsLimitError(RayTpuError):
    """Submission rejected by admission control: the owner's (or the
    cluster's) pending-task budget is exhausted.

    Raised at ``.remote()`` in fast-fail mode (``admission_mode="fail"``
    or when blocking-submit times out), and sealed into the rejected
    task's return refs when the head's backstop gate sheds an
    over-budget submission.
    """


class PlacementGroupUnschedulableError(RayTpuError):
    """The placement group cannot fit on the cluster."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing the task/actor runtime environment failed."""
