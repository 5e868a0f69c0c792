"""Continuous batch scheduler: the serving plane's core.

Counterpart of the reference's request-batching loop in
serve/batching.py's _BatchQueue plus the dynamic batch sizing the
serving literature calls continuous batching: instead of a one-shot
"collect-then-drain" flusher, a per-instance scheduler ADMITS requests
into the next batch as slots free — batch N+1 assembles and launches
while batch N is still executing (no drain barrier), so the accelerator
never idles between batches.

Two pieces:

* ``LatencyModel`` — per-batch-size exec-latency histograms (the
  flight-recorder ``PhaseHistogram``), bucketed by power of two. The
  p95 estimate per bucket drives SLO-aware sizing: ``pick_batch_size``
  returns the largest size whose observed p95 stays under
  ``target_latency_slo_s`` (cold start is optimistic: unobserved sizes
  are explored so the model learns the envelope).

* ``ContinuousBatcher`` — the per-(instance, method) scheduler behind
  ``@serve.batch``. Submissions carry the request deadline (stamped by
  the DeploymentHandle via ``timeout_s`` → TaskSpec deadline, surfaced
  here through a contextvar); expired items are SHED from the queue
  with a typed ``TaskTimeoutError`` before user code ever sees them —
  the same discipline the overload plane applies at the owner,
  head, and worker hops. A bounded queue sheds with
  ``PendingCallsLimitError`` (HTTP 503 at the proxy).

The scheduler task is SELF-TERMINATING: it exists only while work is
queued or in flight, so replica teardown under pytest never strands a
parked asyncio task (the orphaned-flusher warning the old design had).
"""

from __future__ import annotations

import asyncio
import contextvars
import time
from collections import deque
from typing import Any, Callable, Optional

from ray_tpu_torch._private.events import PhaseHistogram
from ray_tpu_torch.exceptions import PendingCallsLimitError, TaskTimeoutError

# Request deadline (wall clock) for the request currently being handled
# on this replica: set by Replica.handle_request, read by the batching
# wrapper so queued items inherit their caller's deadline.
_REQUEST_DEADLINE: contextvars.ContextVar[Optional[float]] = \
    contextvars.ContextVar("ray_tpu_serve_request_deadline", default=None)


def set_request_deadline(deadline: "float | None") -> None:
    _REQUEST_DEADLINE.set(deadline)


def get_request_deadline() -> "float | None":
    return _REQUEST_DEADLINE.get()


class LatencyModel:
    """Observed exec latency per batch size, power-of-two bucketed.

    Reuses the flight recorder's PhaseHistogram so the p95 estimate is
    the same conservative upper-boundary read the tracing plane
    exposes — a bucket only "fits" the SLO when its whole observed
    range does."""

    MIN_OBSERVATIONS = 3  # below this a bucket is cold (optimistic)

    def __init__(self):
        self._hists: dict[int, PhaseHistogram] = {}

    @staticmethod
    def bucket(batch_size: int) -> int:
        """Smallest power of two >= batch_size (1 for size 1)."""
        n = max(1, int(batch_size))
        return 1 << (n - 1).bit_length()

    def observe(self, batch_size: int, exec_s: float) -> None:
        b = self.bucket(batch_size)
        h = self._hists.get(b)
        if h is None:
            h = self._hists[b] = PhaseHistogram()
        h.observe(exec_s)

    def p95(self, bucket: int) -> "float | None":
        """Upper-boundary p95 estimate for one bucket; None while the
        bucket is cold (too few observations to trust)."""
        h = self._hists.get(bucket)
        if h is None or h.count < self.MIN_OBSERVATIONS:
            return None
        target = 0.95 * h.count
        cum = 0
        for i, c in enumerate(h.buckets):
            cum += c
            if cum >= target:
                if i < len(h.boundaries):
                    return h.boundaries[i]
                return h.boundaries[-1] * 2  # overflow bucket
        return h.boundaries[-1] * 2

    def pick_batch_size(self, max_batch_size: int,
                        slo_s: "float | None") -> int:
        """Largest batch size whose observed p95 fits under the SLO.

        Walks size candidates upward and stops at the first OBSERVED
        violation (exec latency is monotone in batch size, so nothing
        larger can fit either). Unobserved sizes below the first
        violation are trusted — that is the exploration path: cold
        start picks ``max_batch_size`` and the model tightens as real
        batches are measured."""
        if not slo_s:
            return max_batch_size
        candidates = []
        b = 1
        while b < max_batch_size:
            candidates.append(b)
            b <<= 1
        candidates.append(max_batch_size)
        chosen = 1
        for size in candidates:
            p = self.p95(self.bucket(size))
            if p is not None and p > slo_s:
                break
            chosen = size
        return chosen

    def snapshot(self) -> dict:
        return {
            str(b): {"count": h.count,
                     "mean_s": (h.sum / h.count) if h.count else 0.0,
                     "p95_s": self.p95(b)}
            for b, h in sorted(self._hists.items())
        }


class ContinuousBatcher:
    """SLO-aware continuous batching over one async batch function.

    ``fn`` is an async callable taking a list of items and returning a
    list of results of the same length (the ``@serve.batch`` contract).
    ``submit`` enqueues one item and returns an asyncio future; the
    scheduler assembles batches dynamically:

      * batch size = ``LatencyModel.pick_batch_size`` under
        ``target_latency_slo_s`` (or ``max_batch_size`` with no SLO);
      * an assembly window of ``batch_wait_timeout_s`` lets a partial
        batch fill before launching;
      * batches launch as independent tasks — up to
        ``max_concurrent_batches`` overlap (None = unbounded), so new
        requests are admitted while earlier batches still execute;
      * deadline-expired and caller-cancelled items are shed at
        assembly, never dispatched.

    Must be driven from a single event loop (the replica loop)."""

    def __init__(self, fn: Callable, *, max_batch_size: int = 10,
                 batch_wait_timeout_s: float = 0.01,
                 target_latency_slo_s: "float | None" = None,
                 max_concurrent_batches: "int | None" = None,
                 max_queue_len: "int | None" = None,
                 name: str = "batch"):
        self._fn = fn
        self._name = name
        self._max_batch_size = max(1, int(max_batch_size))
        self._batch_wait_timeout_s = float(batch_wait_timeout_s)
        self._target_latency_slo_s = target_latency_slo_s
        self._max_concurrent_batches = max_concurrent_batches
        self._max_queue_len = max_queue_len
        self.model = LatencyModel()
        self._queue: deque = deque()  # (item, future, deadline, trace_ctx)
        self._wakeup: "asyncio.Event | None" = None
        self._scheduler: "asyncio.Task | None" = None
        self._batches: set = set()
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._closed = False
        self._recent_sizes: deque = deque(maxlen=128)
        self.stats = {
            "submitted": 0, "batches": 0, "items": 0,
            "shed_deadline": 0, "shed_queue_full": 0,
            "shed_cancelled": 0, "batch_errors": 0,
        }

    # -- submission --------------------------------------------------------

    def submit(self, item: Any, deadline: "float | None" = None,
               trace_ctx: "tuple | None" = None) -> "asyncio.Future":
        loop = asyncio.get_running_loop()
        if self._closed:
            raise RuntimeError(f"batcher {self._name} is shut down")
        self._loop = loop
        if (self._max_queue_len is not None
                and len(self._queue) >= self._max_queue_len):
            self.stats["shed_queue_full"] += 1
            raise PendingCallsLimitError(
                f"PendingCallsLimitError: @serve.batch queue for "
                f"{self._name} is full ({self._max_queue_len} waiting)")
        fut = loop.create_future()
        self._queue.append((item, fut, deadline, trace_ctx))
        self.stats["submitted"] += 1
        if self._wakeup is None:
            self._wakeup = asyncio.Event()
        self._wakeup.set()
        if self._scheduler is None or self._scheduler.done():
            self._scheduler = loop.create_task(self._run_scheduler())
        return fut

    # -- scheduler loop ----------------------------------------------------

    async def _run_scheduler(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while self._queue and not self._closed:
                # Concurrency gate — NOT a drain barrier: with room for
                # another batch, assembly proceeds while earlier
                # batches are still executing.
                while (self._max_concurrent_batches is not None
                       and len(self._batches)
                       >= self._max_concurrent_batches):
                    await asyncio.wait(set(self._batches),
                                       return_when=asyncio.FIRST_COMPLETED)
                self._shed_unservable()
                if not self._queue:
                    break
                target = self.model.pick_batch_size(
                    self._max_batch_size, self._target_latency_slo_s)
                # Assembly window: let the batch fill, but never hold a
                # partial batch past the wait timeout.
                window_end = loop.time() + self._batch_wait_timeout_s
                while len(self._queue) < target and not self._closed:
                    remaining = window_end - loop.time()
                    if remaining <= 0:
                        break
                    self._wakeup.clear()
                    try:
                        await asyncio.wait_for(self._wakeup.wait(),
                                               remaining)
                    except asyncio.TimeoutError:
                        break
                self._shed_unservable()
                n = min(target, len(self._queue))
                batch = [self._queue.popleft() for _ in range(n)]
                if not batch:
                    continue
                t = loop.create_task(self._run_batch(batch))
                self._batches.add(t)
                t.add_done_callback(self._batches.discard)
        except asyncio.CancelledError:
            pass

    def _shed_unservable(self) -> None:
        """Drop deadline-expired items (typed TaskTimeoutError — the
        overload plane's shed-at-every-hop discipline applied to the
        batch queue) and items whose caller already cancelled."""
        if not self._queue:
            return
        now = time.time()
        kept: deque = deque()
        for item, fut, dl, tc in self._queue:
            if fut.done():  # caller gone (cancelled/disconnected)
                self.stats["shed_cancelled"] += 1
                continue
            if dl is not None and now > dl:
                self.stats["shed_deadline"] += 1
                fut.set_exception(TaskTimeoutError(
                    "TaskTimeoutError: request exceeded its deadline "
                    "while queued for batching (shed before execution)",
                    where="serve_batcher"))
                # Shed span: failed + shed attribute makes the trace a
                # tail exemplar at the head (never folded first).
                self._emit_span(tc, f"{self._name}.shed", now, now,
                                failed=True,
                                attributes={"shed": "serve_batcher"})
                continue
            kept.append((item, fut, dl, tc))
        self._queue = kept

    async def _run_batch(self, batch: list) -> None:
        items = [b[0] for b in batch]
        futures = [b[1] for b in batch]
        self.stats["batches"] += 1
        self.stats["items"] += len(items)
        self._recent_sizes.append(len(items))
        t0 = time.perf_counter()
        wall0 = time.time()
        failed = False
        try:
            results = await self._fn(items)
            self.model.observe(len(items), time.perf_counter() - t0)
            if results is None or len(results) != len(items):
                raise ValueError(
                    f"@serve.batch function {self._name} returned "
                    f"{0 if results is None else len(results)} results "
                    f"for a batch of {len(items)}")
            for f, r in zip(futures, results):
                if not f.done():
                    f.set_result(r)
        except asyncio.CancelledError:
            for f in futures:
                if not f.done():
                    f.cancel()
            raise
        except Exception as e:  # noqa: BLE001 — propagate to every caller
            failed = True
            self.stats["batch_errors"] += 1
            for f in futures:
                if not f.done():
                    f.set_exception(e)
        self._trace_batch(batch, wall0, time.time(), failed)

    def _trace_batch(self, batch: list, start: float, end: float,
                     failed: bool) -> None:
        """Per-trace view of a coalesced batch: each distinct sampled
        trace in the batch gets a "batch_exec" span under its own
        caller span (a shared batch_id attribute ties the copies
        together), and every item keeps its own "batch_item" child —
        so one request's trace shows exactly its share of the shared
        execution, including who it was coalesced with."""
        traced = [tc for _i, _f, _d, tc in batch if tc and int(tc[2] or 0)]
        if not traced:
            return
        from ray_tpu_torch._private import traceplane

        batch_id = traceplane.new_span_id()
        exec_span_of: dict[str, str] = {}
        for tc in traced:
            if tc[0] in exec_span_of:
                continue
            sid = traceplane.new_span_id()
            exec_span_of[tc[0]] = sid
            self._emit_span(
                tc, f"{self._name}.batch_exec", start, end, failed=failed,
                span_id=sid,
                attributes={"batch_id": batch_id,
                            "batch_size": len(batch)})
        for idx, (_item, _fut, _dl, tc) in enumerate(batch):
            if not (tc and int(tc[2] or 0)):
                continue
            self._emit_span(
                tc, f"{self._name}.batch_item", start, end, failed=failed,
                parent_span_id=exec_span_of[tc[0]],
                attributes={"batch_id": batch_id, "index": idx})

    def _emit_span(self, tc: "tuple | None", name: str, start: float,
                   end: float, *, failed: bool = False,
                   span_id: "str | None" = None,
                   parent_span_id: "str | None" = None,
                   attributes: "dict | None" = None) -> None:
        """Buffer one serve-plane span into the request's trace (rides
        the next amortized rpc_report — zero per-span frames)."""
        if not (tc and int(tc[2] or 0)):
            return
        import os

        from ray_tpu_torch._private import traceplane

        traceplane.buffer_span({
            "event": "span",
            "name": name,
            "kind": "serve",
            "trace_id": tc[0],
            "span_id": span_id or traceplane.new_span_id(),
            "parent_span_id": parent_span_id or tc[1],
            "pid": os.getpid(),
            "start": start,
            "end": end,
            "failed": failed,
            "attributes": attributes or {},
        })

    # -- introspection / teardown ------------------------------------------

    def batch_size_p50(self) -> float:
        if not self._recent_sizes:
            return 0.0
        s = sorted(self._recent_sizes)
        return float(s[len(s) // 2])

    def snapshot(self) -> dict:
        return {
            "name": self._name,
            "queued": len(self._queue),
            "inflight_batches": len(self._batches),
            "batch_size_p50": self.batch_size_p50(),
            "picked_batch_size": self.model.pick_batch_size(
                self._max_batch_size, self._target_latency_slo_s),
            **self.stats,
            "latency_model": self.model.snapshot(),
        }

    def shutdown(self) -> None:
        """Cancel the scheduler and in-flight batch tasks, cancel every
        queued future. Must run on the owning event loop; idempotent."""
        self._closed = True
        t, self._scheduler = self._scheduler, None
        if t is not None and not t.done():
            t.cancel()
        for b in list(self._batches):
            if not b.done():
                b.cancel()
        while self._queue:
            _item, fut, _dl, _tc = self._queue.popleft()
            if not fut.done():
                fut.cancel()
        if self._wakeup is not None:
            self._wakeup.set()

    def shutdown_threadsafe(self) -> None:
        """Teardown entry for finalizers running off-loop (instance GC):
        hops onto the owning loop when it is still alive."""
        loop = self._loop
        if loop is None or loop.is_closed():
            self._closed = True
            return
        try:
            loop.call_soon_threadsafe(self.shutdown)
        except RuntimeError:
            self._closed = True  # loop shut down between checks
