"""User-level tracing spans, merged into the cluster timeline.

Counterpart of the reference's tracing/profiling helpers
(reference: python/ray/util/tracing/tracing_helper.py:34-127 — opt-in
OpenTelemetry spans around task/actor calls — and _private/profiling.py:84
``profile`` events buffered through TaskEventBuffer into `ray timeline`).
Here spans are lightweight dicts buffered into the traceplane's bounded
span buffer and flushed on the next amortized ``rpc_report`` cast — a
``span()`` inside a hot loop never produces per-span frames to the head.
At the head they land in both the task-event buffer (so
``ray_tpu_torch.util.state.timeline()`` renders user spans alongside task
execution spans) and, when a request-trace context is ambient, in the
trace table as causal children of the enclosing request. OpenTelemetry
export is attached on top when the package is importable.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading
import time
from typing import Any

_local = threading.local()


def _emit(event: dict) -> None:
    """Buffer a span for the next amortized rpc_report flush (never a
    per-span cast — see traceplane.buffer_span). Spans emitted before
    the runtime exists are dropped, same as the old cast path."""
    from ray_tpu_torch._private import traceplane
    from ray_tpu_torch._private.worker_context import try_runtime

    if try_runtime() is None:
        return
    traceplane.buffer_span(event)


@contextlib.contextmanager
def span(name: str, **attributes: Any):
    """Record a named span:

        with tracing.span("preprocess", rows=123):
            ...

    Nesting is tracked per-thread; child spans carry their parent's name
    in ``parent`` so trace viewers can reconstruct the hierarchy. When a
    request-trace context is ambient (inside a traced task, or under an
    outer span that minted one) the span also joins that causal trace —
    it gets its own span id, parents to the enclosing span, and any
    ``.remote()`` submitted inside the block chains under it."""
    from ray_tpu_torch._private import traceplane, worker_context

    parent = getattr(_local, "span_name", None)
    _local.span_name = name
    start = time.time()
    error = None
    # Request-trace linkage: take a span id in the ambient trace (if
    # any) and make this span the parent for the duration of the block.
    tc = worker_context.get_trace_context()
    span_id = traceplane.new_span_id() if tc else None
    tc_token = (worker_context.push_trace_context((tc[0], span_id, tc[2]))
                if tc else None)
    # Optional OpenTelemetry bridge.
    otel_cm = None
    try:
        from opentelemetry import trace as otel_trace  # type: ignore

        otel_cm = otel_trace.get_tracer("ray_tpu_torch").start_as_current_span(name)
        otel_cm.__enter__()
    except Exception:
        otel_cm = None
    try:
        yield
    except BaseException as e:
        error = repr(e)
        raise
    finally:
        if otel_cm is not None:
            try:
                otel_cm.__exit__(None, None, None)
            except Exception:
                pass
        _local.span_name = parent
        if tc_token is not None:
            worker_context.pop_trace_context(tc_token)
        end = time.time()
        ctx = worker_context.get_task_context()
        # Worker/actor identity from the runtime context (a worker
        # runtime's client id IS its worker id) — without it user spans
        # emitted from tasks carried "worker_id": None and refused to
        # group with their task's lifecycle spans in the timeline.
        rt = worker_context.try_runtime()
        worker_id = (rt.client_id if rt is not None
                     and rt.client_type == "worker" else None)
        ev = {
            "event": "span",
            "name": name,
            "parent": parent,
            "task_id": getattr(ctx, "task_id", None),
            "worker_id": worker_id,
            "actor_id": getattr(ctx, "actor_id", None),
            "node_id": (getattr(ctx, "node_id", None)
                        or (rt.node_id if rt is not None else None)),
            "pid": os.getpid(),
            "start": start,
            "end": end,
            "failed": error is not None,
            "attributes": {**attributes, **({"error": error} if error else {})},
        }
        if tc and int(tc[2] or 0):
            ev["trace_id"] = tc[0]
            ev["span_id"] = span_id
            ev["parent_span_id"] = tc[1]
        _emit(ev)


def trace(fn=None, *, name: str | None = None):
    """Decorator form of span()."""
    def wrap(f):
        @functools.wraps(f)
        def inner(*args, **kwargs):
            with span(name or f.__qualname__):
                return f(*args, **kwargs)

        return inner

    return wrap(fn) if fn is not None else wrap


# ---------------------------------------------- trace-correlated logs


class TraceIdFilter(logging.Filter):
    """Stamps ``[trace=<id>]`` into log records made while a traced task
    (or span) executes. A filter rather than a formatter so it composes
    with whatever format the handler already has — worker stderr is
    plain-formatted into ``{worker_id}.log`` and the prefix makes those
    lines greppable by ``ray-tpu logs --trace <id>``."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            from ray_tpu_torch._private import worker_context

            tc = worker_context.get_trace_context()
            if tc and not str(record.msg).startswith("[trace="):
                record.msg = f"[trace={tc[0]}] {record.msg}"
        except Exception:
            pass
        return True


def install_log_correlation() -> None:
    """Attach the trace-id filter where every record passes: the root
    logger's handlers (logger-level filters don't see records propagated
    from child loggers; handler-level ones do) plus the lastResort
    handler that catches unconfigured logging. Idempotent. Installed by
    worker main() when the trace plane is enabled; drivers embedding a
    serve proxy can call it too."""
    filt = TraceIdFilter()
    root = logging.getLogger()
    targets = [root, *root.handlers]
    if logging.lastResort is not None:
        targets.append(logging.lastResort)
    for t in targets:
        if not any(isinstance(f, TraceIdFilter) for f in t.filters):
            t.addFilter(filt)
