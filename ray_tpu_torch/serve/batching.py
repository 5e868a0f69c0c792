"""@serve.batch — transparent request coalescing, continuously batched.

Counterpart of the reference's python/ray/serve/batching.py: an async
method decorated with ``@serve.batch`` receives LISTS of the items its
callers passed individually; concurrent calls enqueue and a per-instance
``ContinuousBatcher`` (serve/scheduler.py) assembles batches. Unlike the
old one-shot flusher there is NO drain barrier: batch N+1 admits and
launches while batch N still executes, batch size adapts to the observed
exec p95 under ``target_latency_slo_s``, deadline-expired requests are
shed from the queue with a typed ``TaskTimeoutError``, and a bounded
queue sheds with ``PendingCallsLimitError`` (HTTP 503 at the proxy). On
the card this is the serving throughput lever: one batched forward pass
feeds the tensor cores a [B, ...] product instead of B vector ones.

    @serve.deployment
    class Model:
        @serve.batch(max_batch_size=8, target_latency_slo_s=0.1)
        async def __call__(self, inputs: list) -> list:
            return self.model(np.stack(inputs)).tolist()
"""

from __future__ import annotations

import asyncio
import functools
import weakref
from typing import Callable

from ray_tpu_torch.serve.scheduler import ContinuousBatcher, get_request_deadline

_FREE = object()  # key for free-function (unbound) batch state


def batch(_fn: Callable | None = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01,
          target_latency_slo_s: "float | None" = None,
          max_concurrent_batches: "int | None" = None,
          max_queue_len: "int | None" = None):
    """Decorate an async function/method taking a LIST of items and
    returning a list of results of the same length. Callers invoke it
    with a SINGLE item and await their own result (reference:
    serve/batching.py @serve.batch).

    ``target_latency_slo_s`` turns on SLO-aware sizing: batch size
    adapts to the largest size whose observed exec p95 fits the SLO.
    ``max_concurrent_batches`` bounds overlapping batches (None =
    unbounded, the legacy flusher's behavior). ``max_queue_len`` bounds
    the wait queue — past it submissions shed with
    ``PendingCallsLimitError`` instead of queueing unboundedly."""

    def decorator(fn):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError(
                "@serve.batch requires an async def function (it awaits "
                f"the batch on the replica event loop); got {fn!r}"
            )
        # Keyed by id(instance) for IDENTITY semantics (a WeakKeyDict
        # would collapse __eq__-equal instances into one shared state and
        # reject __slots__ classes), with a weakref finalizer shutting
        # the batcher down and removing the entry at collection — the
        # finalizer runs before the id can be recycled, so a new
        # instance at the same address can never inherit a dead
        # instance's pending items/futures. Instances that cannot be
        # weak-referenced are pinned instead (bounded leak beats a
        # wrong-self flush).
        batchers: dict = {}
        pins: dict = {}

        def _batcher_for(inst) -> ContinuousBatcher:
            key = _FREE if inst is _FREE else id(inst)
            b = batchers.get(key)
            if b is None:
                call = fn if inst is _FREE else functools.partial(fn, inst)
                b = batchers[key] = ContinuousBatcher(
                    call,
                    max_batch_size=max_batch_size,
                    batch_wait_timeout_s=batch_wait_timeout_s,
                    target_latency_slo_s=target_latency_slo_s,
                    max_concurrent_batches=max_concurrent_batches,
                    max_queue_len=max_queue_len,
                    name=fn.__name__)
                if inst is not _FREE:
                    def _finalize(key=key):
                        gone = batchers.pop(key, None)
                        if gone is not None:
                            gone.shutdown_threadsafe()
                    try:
                        weakref.finalize(inst, _finalize)
                    except TypeError:
                        pins[key] = inst
            return b

        @functools.wraps(fn)
        async def wrapper(*args):
            # Bound method: args = (self, item); free function: (item,).
            if len(args) == 2:
                inst, item = args
            elif len(args) == 1:
                inst, item = _FREE, args[0]
            else:
                raise TypeError(
                    "@serve.batch methods take exactly one request item"
                )
            batcher = _batcher_for(inst)
            # The caller's deadline (handle timeout_s → TaskSpec
            # deadline → replica contextvar) rides into the queue so
            # assembly can shed expired work; the ambient trace context
            # (adopted from the spec around task execution) rides along
            # so each coalesced item keeps its own span inside the
            # shared batch-exec span.
            from ray_tpu_torch._private import worker_context

            fut = batcher.submit(item, deadline=get_request_deadline(),
                                 trace_ctx=worker_context
                                 .get_trace_context())
            return await fut

        wrapper._ray_tpu_serve_batch = True  # introspection/testing
        wrapper._ray_tpu_batchers = batchers
        return wrapper

    if _fn is not None:  # bare @serve.batch
        return decorator(_fn)
    return decorator


def batchers_of(instance) -> "list[ContinuousBatcher]":
    """Every live ContinuousBatcher owned by ``instance`` (one per
    decorated method that has been called). Used by the replica for
    telemetry (queue depth, batch-size p50) and teardown."""
    out = []
    seen = set()
    for name in dir(type(instance)):
        fn = getattr(type(instance), name, None)
        states = getattr(fn, "_ray_tpu_batchers", None)
        if states:
            b = states.get(id(instance))
            if b is not None and id(b) not in seen:
                seen.add(id(b))
                out.append(b)
    return out


def shutdown_batchers(instance) -> None:
    """Cancel scheduler/batch tasks and queued futures for every batcher
    of ``instance`` — replica teardown calls this so no orphaned asyncio
    task survives the event loop (pytest teardown warnings)."""
    for b in batchers_of(instance):
        b.shutdown()
