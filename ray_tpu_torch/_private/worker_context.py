"""Process-global runtime context shared by the public API and workers.

Counterpart of the reference's global worker singleton
(reference: python/ray/_private/worker.py global_worker / Worker class).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch._private.runtime import CoreRuntime

import contextvars

_lock = threading.Lock()
_runtime: "CoreRuntime | None" = None
_head = None  # set when this process hosts the head (driver)
# ContextVar, not threading.local: plain threads each see their own
# value (fresh threads start empty, same as a thread-local), and asyncio
# preserves it per-task — async actor methods interleaving on one event
# loop each keep their own task context across awaits.
_task_context: "contextvars.ContextVar[TaskContext | None]" = (
    contextvars.ContextVar("ray_tpu_task_context", default=None))
# Ambient request-tracing context: (trace_id, parent_span_id, sampled)
# or None. Minted at the serve proxy (or a tracing.span), stamped onto
# every TaskSpec at submit (runtime.submit_task), adopted by the worker
# around task execution with the task's own span as the new parent —
# so nested .remote() calls chain causally with no explicit plumbing.
_trace_context: "contextvars.ContextVar[tuple | None]" = (
    contextvars.ContextVar("ray_tpu_trace_context", default=None))


def set_runtime(rt, head=None) -> None:
    global _runtime, _head
    with _lock:
        _runtime = rt
        _head = head


def global_runtime() -> "CoreRuntime":
    if _runtime is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return _runtime


def try_runtime():
    return _runtime


def get_head():
    return _head


_default_runtime_env: dict | None = None
_process_env_lock = threading.Lock()
_process_base_env: dict | None = None  # actor-lifetime env
_active_task_envs: dict[int, "dict | None"] = {}  # in-flight task envs
_env_token_counter = 0


def set_process_base_runtime_env(env: "dict | None") -> None:
    """Actor-lifetime env: the fallback that outlives any single method
    call (set once at become_actor)."""
    global _process_base_env
    with _process_env_lock:
        _process_base_env = env


def push_process_runtime_env(env: "dict | None") -> int:
    """Worker-side fallback for nested submissions from user-spawned
    threads (the task context is thread-local): record the env of a task
    this process started executing. Returns a token for the matching
    pop. Under actor max_concurrency>1 with heterogeneous per-call envs
    the 'current' env is ambiguous for user threads — last-started wins
    while in flight; when the last task finishes the actor-lifetime env
    (or None) is restored, so no per-call env can leak past its task."""
    global _env_token_counter
    with _process_env_lock:
        _env_token_counter += 1
        token = _env_token_counter
        _active_task_envs[token] = env
        return token


def pop_process_runtime_env(token: int) -> None:
    with _process_env_lock:
        _active_task_envs.pop(token, None)


def get_process_runtime_env() -> "dict | None":
    with _process_env_lock:
        if _active_task_envs:
            # Most recently started in-flight task.
            return _active_task_envs[max(_active_task_envs)]
        return _process_base_env


def set_default_runtime_env(env: "dict | None") -> None:
    """Driver-level runtime env applied under every task/actor env
    (reference: ray.init(runtime_env=...) via JobConfig)."""
    global _default_runtime_env
    _default_runtime_env = env


def get_default_runtime_env() -> "dict | None":
    return _default_runtime_env


def is_initialized() -> bool:
    return _runtime is not None


class TaskContext:
    """Per-task runtime context (reference: ray.get_runtime_context())."""

    def __init__(self, task_id: str = "", actor_id: str | None = None,
                 node_id: str = "", runtime_env: "dict | None" = None):
        self.task_id = task_id
        self.actor_id = actor_id
        self.node_id = node_id
        # The executing task's (already merged) runtime env — the default
        # that nested submissions inherit (reference: parent runtime_env
        # inheritance via JobConfig/worker context).
        self.runtime_env = runtime_env


def set_task_context(ctx: TaskContext | None) -> None:
    _task_context.set(ctx)


def get_task_context() -> TaskContext:
    return _task_context.get() or TaskContext()


def set_trace_context(ctx: "tuple | None") -> None:
    """Set the ambient (trace_id, parent_span_id, sampled) context."""
    _trace_context.set(ctx)


def push_trace_context(ctx: "tuple | None"):
    """Token-returning variant for scoped sets on shared executor
    threads (the proxy's submit hop): reset with pop_trace_context so
    the context can't leak to the thread's next unrelated request."""
    return _trace_context.set(ctx)


def pop_trace_context(token) -> None:
    _trace_context.reset(token)


def get_trace_context() -> "tuple | None":
    return _trace_context.get()
