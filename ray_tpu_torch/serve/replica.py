"""Replica: the actor hosting one copy of a deployment's user class.

Counterpart of the reference's serve/_private/replica.py — wraps the user
callable, counts ongoing requests (the autoscaling signal), exposes a
health check. The replica is an ASYNC actor (its handler methods are
coroutines), so requests overlap on one event loop up to the actor's
concurrency bound — the reference's asyncio replica event loop. Async
user methods await natively; sync user methods run in a thread pool so
they cannot stall the loop (reference: sync methods offloaded to the
replica's executor).

Serving-plane duties on top of that (the overload discipline applied at
the replica hop):

* deadline check at pickup — a request whose handle-stamped deadline
  already passed sheds with a typed ``TaskTimeoutError`` instead of
  burning replica capacity on a result nobody can use;
* bounded admission — past ``max_ongoing + max_queued_requests`` the
  replica sheds with ``PendingCallsLimitError`` (HTTP 503);
* ``drain()`` — scale-down path: stop admitting, let in-flight requests
  finish, then shut the batch schedulers down;
* ``get_metrics`` — queue depth, shed counts, and continuous-batching
  stats (plus the servable's own ``serve_batch_stats()`` when it
  declares one, e.g. the LLM engine's token-level batch view) feed
  handle routing and controller autoscaling.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from ray_tpu_torch.exceptions import PendingCallsLimitError, TaskTimeoutError

_STOP = object()


class ReplicaContext:
    """Metadata about the replica hosting the current code (reference:
    serve/api.py get_replica_context / ReplicaContext)."""

    def __init__(self, deployment: str, replica_id: str, servable_object):
        self.deployment = deployment
        self.replica_id = replica_id
        self.servable_object = servable_object


_replica_context: "ReplicaContext | None" = None


def get_replica_context() -> ReplicaContext:
    if _replica_context is None:
        raise RuntimeError(
            "get_replica_context() may only be called inside a Serve "
            "replica (deployment __init__ or request handling)")
    return _replica_context


class Replica:
    def __init__(self, cls_or_fn, init_args: tuple, init_kwargs: dict,
                 deployment_name: str, replica_id: str,
                 max_ongoing_requests: int = 16,
                 max_queued_requests: "int | None" = None):
        self.deployment_name = deployment_name
        self.replica_id = replica_id
        # Visible to user code from __init__ onward (the context is set
        # BEFORE the servable constructs, matching reference timing; the
        # servable_object field is filled in right after construction).
        global _replica_context
        _replica_context = ReplicaContext(deployment_name, replica_id, None)
        self._ongoing = 0
        self._total = 0
        self._shed = 0
        self._draining = False
        self._max_ongoing = max(1, int(max_ongoing_requests))
        self._max_queued = (None if max_queued_requests is None
                            else max(0, int(max_queued_requests)))
        self._lock = threading.Lock()
        # Sync user code runs here, off the replica event loop — sized by
        # max_ongoing_requests so the knob governs sync parallelism the
        # way it did for threaded replicas.
        self._user_pool = ThreadPoolExecutor(
            max_workers=max(2, int(max_ongoing_requests)),
            thread_name_prefix="replica-user")
        # A constructor that raises is kept for ready() to report (an
        # actor whose own constructor raises dies without its error).
        self._init_error: "str | None" = None
        if isinstance(cls_or_fn, type):
            try:
                self.instance = cls_or_fn(*init_args, **init_kwargs)
            except Exception as e:  # noqa: BLE001 — reported by ready()
                self.instance = None
                self._init_error = f"{type(e).__name__}: {e}"
        else:
            self.instance = cls_or_fn  # plain function deployment
        _replica_context.servable_object = self.instance

    def _admit(self, deadline: "float | None") -> None:
        """Shed-before-work gate, mirrored from the direct plane's
        pop-time deadline check: expired or over-budget requests never
        touch user code. Raises inside the actor method, so callers see
        the typed reason in the TaskError cause."""
        if self._draining:
            from ray_tpu_torch.exceptions import ActorUnavailableError

            raise ActorUnavailableError(
                f"replica {self.replica_id} is draining for scale-down")
        if deadline is not None and time.time() > deadline:
            with self._lock:
                self._shed += 1
            raise TaskTimeoutError(
                "TaskTimeoutError: request exceeded its deadline before "
                f"replica {self.replica_id} picked it up (shed)",
                where="replica_pickup")
        if self._max_queued is not None:
            with self._lock:
                over = self._ongoing >= self._max_ongoing + self._max_queued
                if over:
                    self._shed += 1
            if over:
                raise PendingCallsLimitError(
                    f"PendingCallsLimitError: replica {self.replica_id} "
                    f"is saturated ({self._ongoing} ongoing, limit "
                    f"{self._max_ongoing}+{self._max_queued} queued)")

    def _resolve_call(self, method: str, args: tuple, kwargs: dict):
        """Shared request plumbing: await composed upstream ObjectRefs
        (handle.remote unwraps .ref) and resolve the target callable."""
        import ray_tpu_torch
        from ray_tpu_torch._private.ids import ObjectRef

        args = tuple(ray_tpu_torch.get(a) if isinstance(a, ObjectRef) else a for a in args)
        kwargs = {k: (ray_tpu_torch.get(v) if isinstance(v, ObjectRef) else v)
                  for k, v in kwargs.items()}
        target = (self.instance if method in ("__call__", "")
                  else getattr(self.instance, method))
        return target, args, kwargs

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             multiplexed_model_id: str = "",
                             deadline: "float | None" = None) -> Any:
        import contextvars

        from ray_tpu_torch.serve.multiplex import _set_request_model_id
        from ray_tpu_torch.serve.scheduler import set_request_deadline

        self._admit(deadline)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        _set_request_model_id(multiplexed_model_id)
        # Batched methods read this to shed queued work whose caller's
        # deadline expires while waiting for batch assembly.
        set_request_deadline(deadline)
        try:
            loop = asyncio.get_running_loop()
            target, args, kwargs = await loop.run_in_executor(
                self._user_pool, self._resolve_call, method, args, kwargs)
            if inspect.iscoroutinefunction(getattr(target, "__call__", target)) \
                    or inspect.iscoroutinefunction(target):
                return await target(*args, **kwargs)
            # ctx.run: sync user code in the pool still sees
            # serve.get_multiplexed_model_id() (run_in_executor does not
            # propagate contextvars by itself).
            ctx = contextvars.copy_context()
            result = await loop.run_in_executor(
                self._user_pool, lambda: ctx.run(target, *args, **kwargs))
            if inspect.iscoroutine(result):
                return await result
            return result
        finally:
            with self._lock:
                self._ongoing -= 1

    async def handle_request_streaming(self, method: str, args: tuple,
                                       kwargs: dict,
                                       multiplexed_model_id: str = "",
                                       deadline: "float | None" = None):
        """Streaming variant: an async generator either way — async user
        generators are consumed natively, sync ones are stepped in the
        user pool so a slow producer never blocks the replica loop
        (reference: streaming deployment responses, serve/_private/proxy
        response streaming)."""
        import contextvars

        from ray_tpu_torch.serve.multiplex import _set_request_model_id
        from ray_tpu_torch.serve.scheduler import set_request_deadline

        self._admit(deadline)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        _set_request_model_id(multiplexed_model_id)
        set_request_deadline(deadline)
        try:
            loop = asyncio.get_running_loop()
            target, args, kwargs = await loop.run_in_executor(
                self._user_pool, self._resolve_call, method, args, kwargs)
            # Invoke off-loop: a sync method doing real work before
            # returning its iterable (e.g. computing a full list) must
            # not stall every other request on this replica. Generator
            # functions return instantly either way.
            ctx = contextvars.copy_context()
            out = await loop.run_in_executor(
                self._user_pool, lambda: ctx.run(target, *args, **kwargs))
            if inspect.iscoroutine(out):
                out = await out
            if hasattr(out, "__anext__"):
                async for item in out:
                    yield item
                return
            it = iter(out)

            def step():
                try:
                    return next(it)
                except StopIteration:
                    return _STOP

            while True:
                # ctx.run so generator-body steps see the request's
                # multiplexed model id too (steps are sequential, so
                # re-entering the copied context each time is safe).
                item = await loop.run_in_executor(
                    self._user_pool, ctx.run, step)
                if item is _STOP:
                    return
                yield item
        finally:
            with self._lock:
                self._ongoing -= 1

    async def ready(self) -> bool:
        """Answers once the constructor has returned (an actor runs no
        method before it), so the controller counts a replica as running
        only when it can serve; a constructor that raised makes this call
        raise with its error."""
        if self._init_error is not None:
            raise RuntimeError(f"the constructor raised {self._init_error}")
        return True

    async def get_metrics(self) -> dict:
        from ray_tpu_torch.serve import batching

        snaps = [b.snapshot() for b in batching.batchers_of(self.instance)]
        with self._lock:
            out = {
                "replica_id": self.replica_id,
                "ongoing": self._ongoing,
                "total": self._total,
                "draining": self._draining,
            }
        out["qdepth"] = sum(s["queued"] for s in snaps)
        out["shed_total"] = self._shed + sum(
            s["shed_deadline"] + s["shed_queue_full"] for s in snaps)
        if snaps:
            out["batch_size_p50"] = max(s["batch_size_p50"] for s in snaps)
            out["batchers"] = snaps
        # Token-level continuous batching: servables driving their own
        # engine loop (llm/serving.LLMServer) report it here.
        hook = getattr(self.instance, "serve_batch_stats", None)
        if callable(hook):
            try:
                stats = hook()
                if inspect.iscoroutine(stats):
                    stats = await stats
                out["engine"] = stats
            except Exception:  # noqa: BLE001 — telemetry must not fail
                pass
        return out

    async def drain(self, timeout_s: float = 10.0) -> bool:
        """Scale-down path: stop admitting (new requests shed and the
        handle re-routes them), wait for in-flight requests to finish,
        then cancel the batch schedulers. True = drained clean within
        the timeout; the controller kills the actor either way."""
        from ray_tpu_torch.serve import batching

        self._draining = True
        deadline = time.monotonic() + max(0.0, float(timeout_s))
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    break
            await asyncio.sleep(0.05)
        batching.shutdown_batchers(self.instance)
        with self._lock:
            return self._ongoing == 0

    async def check_health(self) -> bool:
        user_check = getattr(self.instance, "check_health", None)
        if callable(user_check):
            result = user_check()
            if inspect.iscoroutine(result):
                await result
        return True

    async def reconfigure(self, user_config: Any) -> None:
        hook = getattr(self.instance, "reconfigure", None)
        if callable(hook):
            result = hook(user_config)
            if inspect.iscoroutine(result):
                await result
