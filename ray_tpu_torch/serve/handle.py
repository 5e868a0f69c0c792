"""DeploymentHandle: client-side router to a deployment's replicas.

Counterpart of the reference's DeploymentHandle (serve/handle.py:625) and
the power-of-two-choices replica scheduler
(serve/_private/replica_scheduler/pow_2_scheduler.py): pick two random
replicas, route to the one with the lower load score. Replica-set changes
propagate by version polling against the controller — the long-poll
(long_poll.py:204) analogue with a pull cadence.

Load-aware routing (serving plane): the score is NOT just this handle's
submitted count. It folds in

* the direct plane's owner-side view (``DirectPlane.route_load``):
  calls pushed but not yet delivery-ACKED weigh heavily — a dead or
  restarting replica stops acking within one RTT, so power-of-two
  deprioritizes it immediately instead of letting it absorb half the
  flood until the next controller refresh; owner-queued calls behind
  the direct window count too;
* replica-reported queue depth from the controller's telemetry table
  (batch queues the owner cannot see).

``options(timeout_s=...)`` stamps a per-request deadline onto the
TaskSpec: expired requests are shed at every hop — owner queue,
worker pickup, replica pickup, batch assembly — with a typed
``TaskTimeoutError`` instead of queueing unboundedly."""

from __future__ import annotations

import random
import threading
import time
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorError, RayTpuError

# Weight of an unacked pushed call in the routing score: one unacked
# call outweighs several submitted-and-acked ones, so a replica that
# stopped acking (dead, wedged, restarting) loses power-of-two contests
# right away.
_UNACKED_WEIGHT = 8


class DeploymentResponse:
    """Future for one request (reference: handle.py DeploymentResponse).

    If the routed-to replica died before completing, `result()` transparently
    re-issues the request through the handle (the reference router's
    retry-on-replica-death behavior)."""

    def __init__(self, ref, on_done=None, retry=None):
        self._ref = ref
        self._on_done = on_done
        self._retry = retry
        self._done = False

    def result(self, timeout_s: float | None = None) -> Any:
        try:
            value = ray_tpu_torch.get(self._ref, timeout=timeout_s)
        except ActorError:
            if self._finish() and self._retry is not None:
                nxt = self._retry()
                if nxt is not None:
                    return nxt.result(timeout_s=timeout_s)
            raise
        self._finish()
        return value

    def _finish(self) -> bool:
        if not self._done:
            self._done = True
            if self._on_done is not None:
                self._on_done()
            return True
        return False

    @property
    def ref(self):
        """The underlying ObjectRef (composition: pass to other calls)."""
        return self._ref

    def cancel(self) -> None:
        """Best-effort cancel of the in-flight replica call (direct-plane
        cancel first, head fallback). The proxy maps client disconnects
        here so abandoned requests stop burning replica capacity."""
        self._finish()
        try:
            ray_tpu_torch.cancel(self._ref)
        except Exception:  # noqa: BLE001 — cancel is advisory
            pass

    async def _result_async(self, timeout_s: float | None = None) -> Any:
        """Truly async result: awaits the head-pushed object resolution
        (runtime.get_async) — no thread parked for the request's
        lifetime, which is what lets one proxy process hold hundreds of
        in-flight requests (reference: serve/_private/proxy.py:754 fully
        async proxy). Replica-death retry re-routes like result()."""
        import asyncio

        from ray_tpu_torch._private.worker_context import global_runtime

        try:
            fut = asyncio.wrap_future(global_runtime().get_async(self._ref))
            value = await asyncio.wait_for(fut, timeout_s)
        except ActorError:
            if self._finish() and self._retry is not None:
                # retry() may force-refresh against the controller
                # (blocking RPC): keep it off the loop.
                loop = asyncio.get_running_loop()
                nxt = await loop.run_in_executor(None, self._retry)
                if nxt is not None:
                    return await nxt._result_async(timeout_s)
            raise
        self._finish()
        return value

    def __await__(self):
        """Awaitable inside async deployments and the proxy (reference:
        DeploymentHandle responses are awaitable in replica code)."""
        return self._result_async().__await__()


_ASTOP = object()  # end-of-stream sentinel for async iteration


class DeploymentResponseGenerator:
    """Streaming response: iterate to receive items as the replica's
    generator produces them (reference: DeploymentResponseGenerator,
    serve/handle.py — streaming handle results)."""

    def __init__(self, ref_gen, on_done=None):
        self._gen = ref_gen
        self._on_done = on_done
        self._finished = False

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch

        try:
            return ray_tpu_torch.get(next(self._gen))
        except StopIteration:
            self._finish()
            raise
        except Exception:
            self._finish()
            raise

    def _finish(self):
        if not self._finished:
            self._finished = True
            if self._on_done is not None:
                self._on_done()

    def __aiter__(self):
        return self

    async def __anext__(self):
        """Async iteration for async deployments and the SSE proxy:
        awaits head-pushed item readiness (no thread parked per item).
        Falls back to an executor step for generators lacking the async
        protocol (e.g. a plain iterator injected in tests)."""
        import asyncio

        next_async = getattr(self._gen, "next_ref_async", None)
        if next_async is None:
            def step():
                try:
                    return self.__next__()
                except StopIteration:
                    return _ASTOP

            loop = asyncio.get_event_loop()
            item = await loop.run_in_executor(None, step)
            if item is _ASTOP:
                raise StopAsyncIteration
            return item
        from ray_tpu_torch._private.worker_context import global_runtime

        try:
            ref = await next_async()
        except Exception:
            self._finish()
            raise
        if ref is None:
            self._finish()
            raise StopAsyncIteration
        try:
            return await asyncio.wrap_future(global_runtime().get_async(ref))
        except Exception:
            self._finish()
            raise

    def close(self):
        """Release routing accounting when abandoning the stream early
        (for ... break). Also fired by GC as a backstop."""
        self._finish()

    def __del__(self):
        try:
            self._finish()
        except Exception:
            pass


class DeploymentHandle:
    _REFRESH_S = 1.0

    def __init__(self, deployment_name: str, controller=None, method: str = "__call__"):
        self.deployment_name = deployment_name
        self._method = method
        self._controller = controller
        self._replicas: list = []
        self._version = -1
        self._last_refresh = 0.0
        self._inflight: dict[str, int] = {}
        self._reported: dict[str, int] = {}  # rid -> controller-reported qdepth
        self._lock = threading.Lock()
        self._stream = False
        self._model_id = ""  # multiplexing (serve/multiplex.py)
        self._timeout_s: "float | None" = None
        self._max_retries = 2

    # -- controller discovery (lazy: handles are cheap to pickle) ----------

    def _get_controller(self):
        if self._controller is None:
            self._controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
        return self._controller

    def _refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and self._replicas and now - self._last_refresh < self._REFRESH_S:
            return
        info = ray_tpu_torch.get(
            self._get_controller().get_replicas.remote(self.deployment_name)
        )
        with self._lock:
            self._replicas = info["replicas"]
            self._version = info["version"]
            self._last_refresh = now
            self._inflight = {
                rid: self._inflight.get(rid, 0) for rid, _ in self._replicas
            }
            self._reported = {
                rid: int(t.get("qdepth", 0))
                for rid, t in (info.get("telemetry") or {}).items()
            }

    # -- routing -----------------------------------------------------------

    def _load(self, rid: str, actor) -> int:
        """Routing score for one replica: this handle's submitted count
        + controller-reported batch queue depth + the direct plane's
        owner-side view, with UNACKED pushes weighted heavily (acked
        inflight is the real signal — a dead replica's submitted count
        would otherwise drain to zero on error callbacks and make it
        look idle)."""
        load = self._inflight.get(rid, 0) + self._reported.get(rid, 0)
        try:
            from ray_tpu_torch._private.worker_context import global_runtime

            plane = getattr(global_runtime(), "_direct", None)
            if plane is not None:
                rl = plane.route_load(actor._actor_id)
                load += rl["queued"] + _UNACKED_WEIGHT * rl["unacked"]
        except Exception:  # noqa: BLE001 — scoring must never fail a route
            pass
        return load

    def _pick(self):
        """Power-of-two-choices over per-replica load scores; a
        multiplexed model id instead routes by rendezvous hashing so the
        model's replica-local cache keeps hitting (serve/multiplex.py)."""
        with self._lock:
            reps = list(self._replicas)
        if not reps:
            raise RayTpuError(
                f"deployment {self.deployment_name!r} has no running replicas"
            )
        if self._model_id:
            from ray_tpu_torch.serve.multiplex import rendezvous_pick

            return rendezvous_pick(reps, self._model_id)
        if len(reps) == 1:
            return reps[0]
        a, b = random.sample(reps, 2)
        return a if self._load(a[0], a[1]) <= self._load(b[0], b[1]) else b

    def options(self, *, method_name: str | None = None,
                stream: bool | None = None,
                multiplexed_model_id: str | None = None,
                timeout_s: float | None = None,
                max_retries: int | None = None) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, self._controller,
                             method_name or self._method)
        h._stream = self._stream if stream is None else stream
        h._model_id = (self._model_id if multiplexed_model_id is None
                       else multiplexed_model_id)
        h._timeout_s = self._timeout_s if timeout_s is None else timeout_s
        h._max_retries = (self._max_retries if max_retries is None
                          else max(0, int(max_retries)))
        # Share router state with the parent: the replica cache stays warm
        # (no per-call controller RPC) and power-of-two choices sees ALL
        # in-flight requests, not just this method-view's.
        h._replicas, h._version = self._replicas, self._version
        h._last_refresh = self._last_refresh
        h._inflight = self._inflight
        h._reported = self._reported
        h._lock = self._lock
        return h

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        # Cache the method view: repeated h.method.remote() calls reuse one
        # child handle, so its replica cache warms up instead of being
        # rebuilt (and re-fetched from the controller) per call.
        child = self.options(method_name=name)
        self.__dict__[name] = child
        return child

    def remote(self, *args, _retries_left: "int | None" = None,
               **kwargs) -> DeploymentResponse:
        self._refresh()
        if _retries_left is None:
            _retries_left = self._max_retries
        # Unwrap response objects for composition: pass the underlying ref
        # so the downstream task consumes the upstream output directly.
        args = tuple(a.ref if isinstance(a, DeploymentResponse) else a for a in args)
        kwargs = {k: (v.ref if isinstance(v, DeploymentResponse) else v)
                  for k, v in kwargs.items()}
        # timeout_s → TaskSpec deadline: the wall-clock deadline rides
        # BOTH the spec (owner/head/worker hops shed expired work) and
        # the replica call payload (replica pickup + batch assembly).
        deadline = (time.time() + self._timeout_s
                    if self._timeout_s else None)

        def retry() -> "DeploymentResponse | None":
            if _retries_left <= 0:
                return None
            self._refresh(force=True)
            return self.remote(*args, _retries_left=_retries_left - 1, **kwargs)
        last_err: Exception | None = None
        for _ in range(3):  # retry across replica death
            try:
                rid, actor = self._pick()
            except RayTpuError as e:
                # Replica set may be mid-rollout: force-refresh and retry.
                last_err = e
                time.sleep(0.2)
                self._refresh(force=True)
                continue
            with self._lock:
                self._inflight[rid] = self._inflight.get(rid, 0) + 1

            def done(rid=rid):
                with self._lock:
                    self._inflight[rid] = max(0, self._inflight.get(rid, 0) - 1)

            try:
                if self._stream:
                    # Streaming: the replica's generator method returns an
                    # ObjectRefGenerator; items surface as produced.
                    m = actor.handle_request_streaming
                    if self._timeout_s:
                        m = m.options(timeout_s=self._timeout_s)
                    gen = m.remote(
                        self._method, args, kwargs, self._model_id, deadline
                    )
                    return DeploymentResponseGenerator(gen, on_done=done)
                m = actor.handle_request
                if self._timeout_s:
                    m = m.options(timeout_s=self._timeout_s)
                ref = m.remote(
                    self._method, args, kwargs, self._model_id, deadline)
                return DeploymentResponse(
                    ref, on_done=done,
                    retry=retry if _retries_left > 0 else None)
            except ActorError as e:
                done()
                last_err = e
                self._refresh(force=True)
        raise last_err or RayTpuError("routing failed")

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, None, self._method))
