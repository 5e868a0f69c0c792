"""ServeController: deployment state reconciliation.

Counterpart of the reference's ServeController actor
(serve/_private/controller.py:84) with the DeploymentState FSM
(deployment_state.py:1249,2330): a background reconcile loop drives each
deployment's replica set toward its target (scale up/down, replace dead
replicas, autoscale from ongoing-request metrics). Handles/proxies read
the versioned routing table (`get_replicas`) — the pull analogue of the
reference's LongPollHost config pushdown (long_poll.py:204).

Serving-plane additions:

* metrics-driven autoscaling — the target follows ongoing requests AND
  replica-reported batch queue depth, with ingress QPS tracked from
  replica totals; upscale is HELD while the overload plane reports
  memory-pressured nodes (adding replicas to a cluster already shedding
  by watermark makes the spiral worse);
* scale-down DRAINS — a doomed replica stops admitting, finishes its
  in-flight requests (``Replica.drain``), and only then is killed;
* device-cache-aware placement — when a deployment's init args
  carry ObjectRefs (model weights by reference), new replicas prefer
  the node already holding the payload (soft node affinity), so scale-up
  hits the zero-copy host arena instead of re-pulling weights;
* ``ray_tpu_serve_*`` gauges pushed every reconcile tick (qps, queue
  depth, batch size p50, shed total, replicas) for the Prometheus
  exposition (``util.metrics.prometheus_text``).

The reference also hints its cluster autoscaler when the replica target
grows (``autoscaler.sdk.request_resources``); the port has no cluster
autoscaler yet (ROADMAP item 6g), so replicas wait for capacity.
A replica counts as running once its constructor has returned: the
controller keeps a new replica under ``starting`` until its ``ready()``
call answers, and only then routes to it and probes its health. A
constructor that raises is reported (``readiness``) and the replica is
killed and not counted. The reference counts a replica once its actor
has started, so its ``serve.run`` can return while a slow constructor
(a model loading onto the card) still runs, and the first requests wait
on it or time out. serve.run waits for every deployment of the app.
While a deployment has no built replica (all still starting, or the
last one died and its successor is building), a request to it fails at
once ("has no running replicas"), where the reference's would wait on a
replica still constructing.
A replica's actor options are the deployment's ``ray_actor_options``:
a replica that serves on the card asks for ``num_gpus`` (whole, or a
fraction that shares a device), since a worker without a GPU lease
sees no card.
"""

from __future__ import annotations

import math
import threading
import time
import uuid
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.serve.deployment import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.replica import Replica

# Bound on how long a scale-down drain may hold a doomed replica alive.
DRAIN_TIMEOUT_S = 10.0


class _HandleMarker:
    """Placeholder for a child deployment in init args (resolved to a
    DeploymentHandle inside the replica process)."""

    def __init__(self, name: str):
        self.name = name


class _DeploymentState:
    def __init__(self, spec: dict):
        self.spec = spec
        self.config: DeploymentConfig = spec["config"]
        self.replicas: dict[str, Any] = {}  # rid -> ActorHandle, constructed
        # rid -> (actor, ref of its ready() call): constructor still running.
        self.starting: dict[str, tuple] = {}
        # The last constructor failure, until a replica comes up.
        self.error: "str | None" = None
        self.draining: dict[str, tuple] = {}  # rid -> (actor, ref, deadline)
        self.version = 0
        self.last_metrics: dict[str, dict] = {}
        self.target = self.config.num_replicas
        asc = self.config.autoscaling_config
        if asc is not None:
            self.target = max(asc.min_replicas, min(self.config.num_replicas, asc.max_replicas))
        self._last_downscale = time.monotonic()
        # Ingress QPS estimated from replica request totals.
        self.qps = 0.0
        self._prev_total = 0
        self._prev_total_t = time.monotonic()

    def status(self) -> dict:
        return {
            "name": self.spec["name"],
            "target_replicas": self.target,
            "running_replicas": len(self.replicas),
            "draining_replicas": len(self.draining),
            "version": self.version,
            "qps": round(self.qps, 2),
            "qdepth": sum(m.get("qdepth", 0)
                          for m in self.last_metrics.values()),
        }


class ServeController:
    """Runs as a named actor (SERVE_CONTROLLER @ namespace 'serve')."""

    RECONCILE_PERIOD_S = 0.25

    def __init__(self):
        self._deployments: dict[str, _DeploymentState] = {}
        # Named applications (reference: multi-app serve): app name ->
        # ingress deployment name. Deployment specs carry their owning
        # app under spec["app"].
        self._apps: dict[str, str] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._mem_checked = 0.0
        self._mem_pressured_cached = False
        self._gauges = None
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._thread.start()

    # -- API (called by serve.run / handles / proxy) -----------------------

    def deploy_application(self, specs: list[dict]) -> None:
        """Deploy/refresh deployments (children-first order from
        Application.flatten)."""
        with self._lock:
            for spec in specs:
                existing = self._deployments.get(spec["name"])
                if existing is not None:
                    # Config update: keep replicas, adopt new target;
                    # code changes take effect on replica replacement.
                    existing.spec = spec
                    existing.config = spec["config"]
                    existing.target = spec["config"].num_replicas
                else:
                    self._deployments[spec["name"]] = _DeploymentState(spec)
        self._reconcile_once()  # synchronous first pass: fast readiness

    def get_replicas(self, deployment_name: str) -> dict:
        with self._lock:
            st = self._deployments.get(deployment_name)
            if st is None:
                raise RayTpuError(f"no deployment named {deployment_name!r}")
            return {
                "version": st.version,
                "replicas": [(rid, actor) for rid, actor in st.replicas.items()],
                # Per-replica load view for the handle's routing score
                # (queue depth the owner-side direct plane cannot see).
                "telemetry": {
                    rid: {"qdepth": m.get("qdepth", 0),
                          "ongoing": m.get("ongoing", 0)}
                    for rid, m in st.last_metrics.items()
                    if rid in st.replicas
                },
            }

    def get_routes(self) -> dict[str, dict]:
        """prefix -> {"name", "sse_method", "ws_method", "ws_stream"}.

        ``sse_method`` names an async-generator method the HTTP proxy
        should dispatch Accept: text/event-stream requests to (e.g. the
        OpenAI ``stream_events`` protocol handler); None = stream
        __call__. ``ws_method`` names a ``ws_message`` handler that
        makes the route WebSocket-upgradable (reference: serve's
        FastAPI websocket ingress — serve/_private/http_util.py ASGI
        passthrough); ``ws_stream`` is True when it is an async
        generator (each yielded item becomes one outbound frame per
        inbound message)."""
        import inspect

        with self._lock:
            routes = {}
            for st in self._deployments.values():
                prefix = st.spec.get("route_prefix")
                if not prefix:
                    continue
                cls = st.spec.get("cls")
                sse = None
                if cls is not None and inspect.isasyncgenfunction(
                        getattr(cls, "stream_events", None)):
                    sse = "stream_events"
                ws = getattr(cls, "ws_message", None) if cls else None
                pathm = getattr(cls, "route_request", None) if cls else None
                routes[prefix] = {
                    "name": st.spec["name"],
                    "sse_method": sse,
                    "ws_method": "ws_message" if callable(ws) else None,
                    "ws_stream": bool(ws) and inspect.isasyncgenfunction(ws),
                    # Path-aware ingress (reference: real URL routing in
                    # the serve ASGI app): non-streaming requests go to
                    # route_request(subpath, payload) when declared.
                    "path_method": "route_request" if callable(pathm)
                    else None,
                }
            return routes

    def readiness(self, deployment_name: str) -> "dict | None":
        """Replicas constructed, replicas still constructing, and the
        last constructor error of a deployment (None if it is unknown)."""
        with self._lock:
            st = self._deployments.get(deployment_name)
            if st is None:
                return None
            return {"running": len(st.replicas), "starting": len(st.starting),
                    "error": st.error}

    def status(self) -> dict:
        with self._lock:
            out = {}
            for name, st in self._deployments.items():
                s = st.status()
                s["app"] = st.spec.get("app")
                out[name] = s
            return out

    def set_app_ingress(self, app: str, ingress: str) -> None:
        with self._lock:
            self._apps[app] = ingress

    def get_app_ingress(self, app: str) -> "str | None":
        with self._lock:
            return self._apps.get(app)

    def list_applications(self) -> dict:
        with self._lock:
            return {
                app: {
                    "ingress": ingress,
                    "deployments": [n for n, st in self._deployments.items()
                                    if st.spec.get("app") == app],
                }
                for app, ingress in self._apps.items()
            }

    def delete_application(self, app: str) -> None:
        with self._lock:
            names = [n for n, st in self._deployments.items()
                     if st.spec.get("app") == app]
            self._apps.pop(app, None)
        for n in names:
            self.delete_deployment(n)

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            st = self._deployments.pop(name, None)
        if st is not None:
            for actor in st.replicas.values():
                self._kill(actor)
            for actor, _ref in st.starting.values():
                self._kill(actor)
            for actor, _ref, _dl in st.draining.values():
                self._kill(actor)

    def shutdown_deployments(self) -> None:
        with self._lock:
            names = list(self._deployments)
        for n in names:
            self.delete_deployment(n)
        self._stop.set()

    def ping(self) -> str:
        return "pong"

    # -- reconciliation ----------------------------------------------------

    def _reconcile_loop(self) -> None:
        while not self._stop.wait(self.RECONCILE_PERIOD_S):
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                import traceback

                traceback.print_exc()

    def _reconcile_once(self) -> None:
        with self._lock:
            states = list(self._deployments.values())
        for st in states:
            self._promote_started(st)
            self._probe_health(st)
            self._autoscale(st)
            self._scale_to_target(st)
            self._reap_draining(st)
        self._export_metrics(states)

    def _promote_started(self, st: _DeploymentState) -> None:
        """Move each replica whose ``ready()`` answered from ``starting``
        to ``replicas``; a replica whose constructor raised is killed and
        its error kept for ``readiness``."""
        with self._lock:
            items = list(st.starting.items())
        if not items:
            return
        ready, _ = ray_tpu_torch.wait([ref for _, (_, ref) in items],
                                      num_returns=len(items), timeout=0)
        ready_set = {r.hex() for r in ready}
        for rid, (actor, ref) in items:
            if ref.hex() not in ready_set:
                continue
            try:
                ray_tpu_torch.get(ref, timeout=5.0)
            except Exception as e:  # noqa: BLE001 — the constructor's error
                with self._lock:
                    st.starting.pop(rid, None)
                    st.error = f"replica {rid} failed to start: {e}"
                self._kill(actor)
                continue
            with self._lock:
                if st.starting.pop(rid, None) is not None:
                    st.replicas[rid] = actor
                    st.error = None

    def _probe_health(self, st: _DeploymentState) -> None:
        dead = []
        refs = []
        with self._lock:
            items = list(st.replicas.items())
        for rid, actor in items:
            try:
                refs.append((rid, actor.get_metrics.remote()))
            except RayTpuError:
                dead.append(rid)
        # One bounded wait for the whole replica set — a saturated replica
        # costs the loop at most the deadline, not deadline × replicas.
        if refs:
            ready, _ = ray_tpu_torch.wait(
                [ref for _, ref in refs], num_returns=len(refs), timeout=5.0
            )
            ready_set = {r.hex() for r in ready}
            for rid, ref in refs:
                if ref.hex() not in ready_set:
                    # Slow ≠ dead (a busy replica; constructing ones are
                    # under ``starting``, not probed here). Dead workers
                    # fail fast — the head errors their pending calls on
                    # disconnect.
                    continue
                try:
                    st.last_metrics[rid] = ray_tpu_torch.get(ref)
                except RayTpuError:
                    dead.append(rid)
        if dead:
            with self._lock:
                for rid in dead:
                    actor = st.replicas.pop(rid, None)
                    st.last_metrics.pop(rid, None)
                    if actor is not None:
                        self._kill(actor)
                st.version += 1
        # Ingress QPS from replica totals (cumulative, so replica death
        # can dip the sum — clamp at zero and resync).
        total = sum(m.get("total", 0) for m in st.last_metrics.values())
        now = time.monotonic()
        dt = now - st._prev_total_t
        if dt >= 1.0:
            st.qps = max(0.0, (total - st._prev_total) / dt)
            st._prev_total, st._prev_total_t = total, now

    def _mem_pressured(self) -> bool:
        """Overload signal, cached ~1 s: any node over the soft
        memory watermark. While pressured, upscale is held — more
        replicas on a spilling cluster amplify the pressure."""
        now = time.monotonic()
        if now - self._mem_checked < 1.0:
            return self._mem_pressured_cached
        self._mem_checked = now
        try:
            from ray_tpu_torch._private.worker_context import global_runtime

            stats = global_runtime().conn.call("runtime_stats", {}, timeout=5)
            gauges = stats.get("gauges") or {}
            self._mem_pressured_cached = bool(
                gauges.get("mem_pressured_nodes", 0))
        except Exception:  # noqa: BLE001 — no signal = not pressured
            self._mem_pressured_cached = False
        return self._mem_pressured_cached

    def _autoscale(self, st: _DeploymentState) -> None:
        asc: AutoscalingConfig | None = st.config.autoscaling_config
        if asc is None:
            return
        # Load = executing requests + replica-side batch queue depth:
        # a replica admitting into a deep batch queue is loaded even
        # while its ongoing count looks tame.
        ongoing = sum(m.get("ongoing", 0) for m in st.last_metrics.values())
        qdepth = sum(m.get("qdepth", 0) for m in st.last_metrics.values())
        desired = math.ceil(
            (ongoing + qdepth) / max(asc.target_ongoing_requests, 1e-9))
        desired = max(asc.min_replicas, min(asc.max_replicas, desired))
        now = time.monotonic()
        if desired > st.target:
            if self._mem_pressured():
                return  # hold: scaling into memory pressure makes it worse
            st.target = desired  # upscale immediately
            st._last_downscale = now
        elif desired < st.target:
            if now - st._last_downscale >= asc.downscale_delay_s:
                st.target = max(desired, st.target - 1)  # step down gently
                st._last_downscale = now
        else:
            st._last_downscale = now

    def _scale_to_target(self, st: _DeploymentState) -> None:
        with self._lock:
            current = len(st.replicas) + len(st.starting)
            if current < st.target:
                for _ in range(st.target - current):
                    rid, actor = self._start_replica(st)
                    st.starting[rid] = (actor, actor.ready.remote())
                st.version += 1
            elif current > st.target:
                # Replicas still constructing serve nothing yet: they go
                # first, without a drain.
                while st.starting and current > st.target:
                    _rid, (actor, _ref) = st.starting.popitem()
                    self._kill(actor)
                    current -= 1
                doomed = list(st.replicas)[st.target - current:] if current > st.target else []
                for rid in doomed:
                    actor = st.replicas.pop(rid)
                    st.last_metrics.pop(rid, None)
                    # Drain before kill: the version bump re-routes new
                    # traffic away; in-flight requests finish on the
                    # doomed replica, which is reaped once drained (or
                    # at the drain deadline).
                    try:
                        ref = actor.drain.remote(timeout_s=DRAIN_TIMEOUT_S)
                    except RayTpuError:
                        ref = None
                    st.draining[rid] = (
                        actor, ref, time.monotonic() + DRAIN_TIMEOUT_S + 2.0)
                st.version += 1

    def _reap_draining(self, st: _DeploymentState) -> None:
        with self._lock:
            items = list(st.draining.items())
        for rid, (actor, ref, deadline) in items:
            done = time.monotonic() > deadline
            if not done and ref is not None:
                try:
                    ready, _ = ray_tpu_torch.wait([ref], timeout=0)
                    done = bool(ready)
                except RayTpuError:
                    done = True  # replica died mid-drain: just reap
            if done:
                with self._lock:
                    st.draining.pop(rid, None)
                self._kill(actor)

    def _start_replica(self, st: _DeploymentState) -> tuple[str, Any]:
        spec = st.spec
        rid = f"{spec['name']}#{uuid.uuid4().hex[:6]}"
        opts = dict(spec["config"].ray_actor_options)
        opts.setdefault("num_cpus", 0)
        opts["max_concurrency"] = max(2, spec["config"].max_ongoing_requests)
        if "scheduling_strategy" not in opts:
            node = self._weights_node(spec)
            if node:
                from ray_tpu_torch.util.scheduling_strategies import (
                    NodeAffinitySchedulingStrategy,
                )

                opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
                    node, soft=True)
        actor_cls = ray_tpu_torch.remote(**opts)(Replica)
        init_args = tuple(self._resolve(a) for a in spec["init_args"])
        init_kwargs = {k: self._resolve(v) for k, v in spec["init_kwargs"].items()}
        actor = actor_cls.remote(
            spec["cls"], init_args, init_kwargs, spec["name"], rid,
            max_ongoing_requests=spec["config"].max_ongoing_requests,
            max_queued_requests=getattr(
                spec["config"], "max_queued_requests", None))
        return rid, actor

    @staticmethod
    def _weights_node(spec: dict) -> "str | None":
        """Device-cache-aware placement: when init args carry
        ObjectRefs (model weights passed by reference), prefer the node
        already holding the payload — its host arena / device cache
        serves the weights zero-copy instead of re-pulling them."""
        from ray_tpu_torch._private.ids import ObjectRef

        for a in (list(spec.get("init_args") or ())
                  + list((spec.get("init_kwargs") or {}).values())):
            if not isinstance(a, ObjectRef):
                continue
            try:
                from ray_tpu_torch._private.worker_context import global_runtime

                row = global_runtime().conn.call(
                    "get_object", {"object_id": a.hex()}).get("object")
            except Exception:  # noqa: BLE001 — placement hint only
                return None
            if not row:
                continue
            node = row.get("node_id") or row.get("location")
            if not node:
                reps = row.get("replicas") or []
                node = reps[0] if reps else None
            if node:
                return node
        return None

    # -- metrics exposition ------------------------------------------------

    def _export_metrics(self, states: list) -> None:
        """Push the serving-plane gauges (Prometheus `ray_tpu_serve_*`)
        once per reconcile tick — cheap sets, the
        metric layer amortizes the actual head casts."""
        try:
            g = self._gauges
            if g is None:
                from ray_tpu_torch.util.metrics import Gauge

                g = self._gauges = {
                    "qps": Gauge("ray_tpu_serve_qps",
                                 "Ingress requests/s per deployment",
                                 tag_keys=("deployment",)),
                    "qdepth": Gauge("ray_tpu_serve_queue_depth",
                                    "Replica batch-queue depth",
                                    tag_keys=("deployment",)),
                    "batch_p50": Gauge("ray_tpu_serve_batch_size_p50",
                                       "Median assembled batch size",
                                       tag_keys=("deployment",)),
                    "shed": Gauge("ray_tpu_serve_shed_total",
                                  "Requests shed (deadline/queue-full)",
                                  tag_keys=("deployment",)),
                    "replicas": Gauge("ray_tpu_serve_replicas",
                                      "Running replicas",
                                      tag_keys=("deployment",)),
                    "ongoing": Gauge("ray_tpu_serve_ongoing",
                                     "Executing requests",
                                     tag_keys=("deployment",)),
                }
            for st in states:
                tags = {"deployment": st.spec["name"]}
                metrics = list(st.last_metrics.values())
                g["qps"].set(st.qps, tags)
                g["qdepth"].set(
                    sum(m.get("qdepth", 0) for m in metrics), tags)
                sizes = [m.get("batch_size_p50", 0.0) for m in metrics
                         if m.get("batch_size_p50")]
                g["batch_p50"].set(max(sizes) if sizes else 0.0, tags)
                g["shed"].set(
                    sum(m.get("shed_total", 0) for m in metrics), tags)
                g["replicas"].set(len(st.replicas), tags)
                g["ongoing"].set(
                    sum(m.get("ongoing", 0) for m in metrics), tags)
        except Exception:  # noqa: BLE001 — telemetry must not stall serving
            pass

    @staticmethod
    def _resolve(arg):
        if isinstance(arg, _HandleMarker):
            return DeploymentHandle(arg.name)
        return arg

    @staticmethod
    def _kill(actor) -> None:
        try:
            ray_tpu_torch.kill(actor)
        except RayTpuError:
            pass
