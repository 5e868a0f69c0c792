"""serve public API: run / start / shutdown / handles / status.

Counterpart of the reference's serve/api.py (serve.run :591 →
client.deploy_application → ServeController) — SURVEY.md §3.5 call stack."""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.serve.controller import ServeController, _HandleMarker
from ray_tpu_torch.serve.deployment import (Application, AutoscalingConfig,
                                      Deployment, DeploymentConfig)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.proxy import HTTPProxy

_controller = None
_proxy = None


def start(*, http_host: str = "127.0.0.1", http_port: int = 0, proxy: bool = True):
    """Ensure the controller (and optionally the HTTP proxy) are running."""
    global _controller, _proxy
    ray_tpu_torch.api.auto_init()
    if _controller is None:
        try:
            _controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER", namespace="serve")
        except (RayTpuError, ValueError):
            cls = ray_tpu_torch.remote(num_cpus=0, max_concurrency=16, name="SERVE_CONTROLLER",
                                 namespace="serve")(ServeController)
            _controller = cls.remote()
            ray_tpu_torch.get(_controller.ping.remote())  # wait until live
    if proxy and _proxy is None:
        cls = ray_tpu_torch.remote(num_cpus=0, max_concurrency=32, name="SERVE_PROXY",
                             namespace="serve")(HTTPProxy)
        _proxy = cls.remote(http_host, http_port)
        ray_tpu_torch.get(_proxy.ping.remote())
    return _controller


def _specs_from_app(app: Application, route_prefix: str | None) -> list[dict]:
    nodes = app.flatten()
    specs = []
    for node in nodes:
        dep: Deployment = node.deployment
        args = tuple(
            _HandleMarker(a.deployment.name) if isinstance(a, Application) else a
            for a in node.init_args
        )
        kwargs = {
            k: _HandleMarker(v.deployment.name) if isinstance(v, Application) else v
            for k, v in node.init_kwargs.items()
        }
        prefix = dep.route_prefix
        if node is nodes[-1]:  # ingress (root of the bind tree)
            prefix = route_prefix if route_prefix is not None else (prefix or "/")
        specs.append(
            {
                "name": dep.name,
                "cls": dep.cls,
                "config": dep.config,
                "init_args": args,
                "init_kwargs": kwargs,
                "route_prefix": prefix,
            }
        )
    return specs


def run(app: Application | Deployment, *, name: str | None = None,
        route_prefix: str | None = None, _blocking_ready: bool = True,
        proxy: bool = True) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment.

    An explicit ``name`` makes this a NAMED application (reference:
    multi-app serve.run(name=...)): several apps coexist on one cluster,
    each owning its deployments and route prefix; re-running a name
    REPLACES that app (its stale deployments are removed), names owned
    by other apps are protected, serve.delete(name) removes exactly it,
    and get_app_handle(name) resolves its ingress. Unnamed runs keep the
    additive single-app behavior (deployments accumulate under the
    "default" app)."""
    if isinstance(app, Deployment):
        app = app.bind()
    controller = start(proxy=proxy)
    specs = _specs_from_app(app, route_prefix)
    app_tag = name or "default"
    for s in specs:
        s["app"] = app_tag
    dep_names = {s["name"] for s in specs}
    existing = ray_tpu_torch.get(controller.status.remote())
    # Ownership guard for ALL runs: an unnamed run must not silently
    # steal (and re-tag) a named app's deployment either.
    for dn, st in existing.items():
        owner = st.get("app")
        if dn in dep_names and owner not in (None, app_tag):
            raise ValueError(
                f"deployment name {dn!r} already belongs to "
                f"application {owner!r}")
    stale: list[str] = []
    if name is not None:
        stale = [dn for dn, st in existing.items()
                 if st.get("app") == name and dn not in dep_names]
    _deploy_specs(controller, specs, wait=_blocking_ready)
    for dn in stale:
        ray_tpu_torch.get(controller.delete_deployment.remote(dn))
    ray_tpu_torch.get(controller.set_app_ingress.remote(app_tag,
                                                  app.deployment.name))
    return DeploymentHandle(app.deployment.name)


def get_app_handle(name: str) -> DeploymentHandle:
    """Handle to a named application's ingress deployment (reference:
    serve.get_app_handle)."""
    controller = _resolve_controller()
    if controller is None:
        raise RayTpuError("serve is not running")
    ingress = ray_tpu_torch.get(controller.get_app_ingress.remote(name))
    if ingress is None:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(ingress)


# How long serve.run waits for a deployment's first replica to finish
# its constructor: a replica on the card took 26.71-29 s to start, and a
# first deploy also spent ~20 s importing the deployment's module
# (NVIDIA H100 80GB HBM3).
READY_TIMEOUT_S = 180.0


def _wait_ready(controller, name: str, timeout_s: float = READY_TIMEOUT_S) -> None:
    """Return once a replica of ``name`` has finished its constructor, so
    the first request after serve.run is answered at once (full scale-out
    continues in the background). A constructor that raised raises here
    with its error."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = ray_tpu_torch.get(controller.readiness.remote(name), timeout=30)
        if st and st["running"] >= 1:
            return
        if st and st["error"]:
            raise RayTpuError(f"deployment {name}: {st['error']}")
        time.sleep(0.1)
    raise TimeoutError(f"deployment {name} not ready after {timeout_s}s")


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def get_proxy_port() -> int:
    if _proxy is None:
        raise RayTpuError("serve proxy not running")
    return ray_tpu_torch.get(_proxy.get_port.remote())


def get_grpc_port() -> int:
    """Port of the gRPC ingress (reference: gRPCProxy); -1 if disabled."""
    if _proxy is None:
        raise RayTpuError("serve proxy not running")
    return ray_tpu_torch.get(_proxy.get_grpc_port.remote())


def _resolve_controller():
    """Attach to a cluster's existing controller without creating one
    (read-only callers; cross-process CLI). Returns None if serve was
    never started."""
    global _controller
    if _controller is None:
        try:
            _controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER",
                                            namespace="serve")
        except Exception:
            return None
    return _controller


def status() -> dict:
    controller = _resolve_controller()
    if controller is None:
        return {}  # serve not running — a status query must not start it
    return ray_tpu_torch.get(controller.status.remote())


def delete(name: str) -> None:
    """Delete a named APPLICATION (all its deployments) if ``name``
    matches one (reference: serve.delete(app_name)); otherwise delete
    the single deployment of that name."""
    if _controller is not None:
        if ray_tpu_torch.get(_controller.get_app_ingress.remote(name)) is not None:
            ray_tpu_torch.get(_controller.delete_application.remote(name))
        else:
            ray_tpu_torch.get(_controller.delete_deployment.remote(name))
        if _proxy is not None:
            routes = ray_tpu_torch.get(_controller.get_routes.remote())
            ray_tpu_torch.get(_proxy.update_routes.remote(routes))


def shutdown() -> None:
    global _controller, _proxy
    # A fresh process (CLI `serve shutdown`) attaches to the cluster's
    # controller by name first — shutdown must work cross-process.
    _resolve_controller()
    if _controller is not None:
        try:
            ray_tpu_torch.get(_controller.shutdown_deployments.remote(), timeout=30)
        except RayTpuError:
            pass
        finally:
            # The controller must die even if draining timed out: its
            # reconcile loop is already stopped, and a live-but-stopped
            # named actor would be reused as a zombie by the next start().
            try:
                ray_tpu_torch.kill(_controller)
            except RayTpuError:
                pass
        _controller = None
    if _proxy is None:
        # Cross-process: the proxy is a named actor too.
        try:
            _proxy = ray_tpu_torch.get_actor("SERVE_PROXY", namespace="serve")
        except Exception:
            _proxy = None
    if _proxy is not None:
        try:
            ray_tpu_torch.kill(_proxy)
        except RayTpuError:
            pass
        _proxy = None


# -- declarative config (reference: serve/schema.py ServeDeploySchema,
#    `serve build` / `serve deploy` config files) -------------------------


def _import_path(path: str):
    """Resolve a dotted path where the module/attribute boundary is
    unknown (nested classes: 'pkg.mod.Outer.Inner'): import the longest
    importable module prefix, then getattr the rest."""
    import importlib

    parts = path.split(".")
    for i in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:i])
        try:
            obj = importlib.import_module(mod_name)
        except ModuleNotFoundError as e:
            # Only swallow "this prefix is not a module"; a missing
            # dependency INSIDE a located module is the user's real error.
            if e.name == mod_name or (e.name and mod_name.startswith(e.name + ".")):
                continue
            raise
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"cannot resolve import path {path!r}")


def _deploy_specs(controller, specs: list[dict], *, wait: bool = True) -> None:
    """Shared deploy + proxy-route push + readiness wait (used by run()
    and run_from_config())."""
    ray_tpu_torch.get(controller.deploy_application.remote(specs))
    if _proxy is not None:
        routes = ray_tpu_torch.get(controller.get_routes.remote())
        ray_tpu_torch.get(_proxy.update_routes.remote(routes))
    if wait:
        # Every deployment of the app, children first: a request reaches
        # the children through the ingress, and a child's replicas take
        # requests only once built.
        for spec in specs:
            _wait_ready(controller, spec["name"])


def build(app: "Application | Deployment", *, route_prefix: str | None = None,
          name: str = "default") -> dict:
    """Emit a declarative, JSON/YAML-serializable config for an app
    (reference: serve build — serve/scripts.py). Deployment classes must
    be importable (module.ClassName); handles between deployments are
    encoded as {"__handle__": name} markers."""
    if isinstance(app, Deployment):
        app = app.bind()
    specs = _specs_from_app(app, route_prefix)
    deployments = []
    for spec in specs:
        cls = spec["cls"]
        if cls.__module__ in ("__main__", None) or "<locals>" in cls.__qualname__:
            raise ValueError(
                f"deployment {spec['name']!r} class must be importable "
                f"(module.ClassName) to build a config; move it out of "
                f"__main__ / function scope"
            )
        cfg = spec["config"]

        def enc(v):
            if isinstance(v, _HandleMarker):
                return {"__handle__": v.name}
            return v

        deployments.append({
            "name": spec["name"],
            "import_path": f"{cls.__module__}.{cls.__qualname__}",
            "num_replicas": cfg.num_replicas,
            "max_ongoing_requests": cfg.max_ongoing_requests,
            "autoscaling_config": (
                dataclasses.asdict(cfg.autoscaling_config)
                if cfg.autoscaling_config else None
            ),
            "ray_actor_options": dict(cfg.ray_actor_options),
            "route_prefix": spec["route_prefix"],
            "init_args": [enc(a) for a in spec["init_args"]],
            "init_kwargs": {k: enc(v) for k, v in spec["init_kwargs"].items()},
        })
    return {"applications": [{"name": name, "deployments": deployments}]}


def run_from_config(config: dict | str, *, proxy: bool = True) -> None:
    """Deploy from a config produced by ``build`` (or hand-written YAML/
    JSON; reference: `serve deploy config.yaml`). ``config`` may be a
    dict, a path to a .yaml/.json file, or a JSON string."""
    import json as _json
    import os as _os

    if isinstance(config, str):
        if _os.path.exists(config):
            with open(config) as f:
                text = f.read()
            if config.endswith((".yaml", ".yml")):
                import yaml

                config = yaml.safe_load(text)
            else:
                config = _json.loads(text)
        else:
            config = _json.loads(config)
    controller = start(proxy=proxy)
    for app in config["applications"]:
        specs = []
        for d in app["deployments"]:
            cls = _import_path(d["import_path"])
            if isinstance(cls, Deployment):
                # Import paths usually name the @serve.deployment-decorated
                # module attribute; the replica needs the inner class.
                cls = cls.cls

            def dec(v):
                if isinstance(v, dict) and set(v) == {"__handle__"}:
                    return _HandleMarker(v["__handle__"])
                return v

            auto = d.get("autoscaling_config")
            cfg = DeploymentConfig(
                num_replicas=d.get("num_replicas", 1),
                max_ongoing_requests=d.get("max_ongoing_requests", 16),
                autoscaling_config=(AutoscalingConfig(**auto) if auto else None),
                ray_actor_options=d.get("ray_actor_options", {}),
            )
            specs.append({
                "name": d["name"],
                "cls": cls,
                "config": cfg,
                "init_args": tuple(dec(a) for a in d.get("init_args", [])),
                "init_kwargs": {k: dec(v)
                                for k, v in d.get("init_kwargs", {}).items()},
                "route_prefix": d.get("route_prefix"),
            })
        app_name = app.get("name", "default")
        for s in specs:
            s["app"] = app_name
        # Same semantics as run(name=...): a declarative deploy must not
        # steal another app's deployments, and REPLACES its own app —
        # deployments dropped from the config are removed.
        dep_names = {s["name"] for s in specs}
        existing = ray_tpu_torch.get(controller.status.remote())
        for dn, st in existing.items():
            owner = st.get("app")
            if dn in dep_names and owner not in (None, app_name):
                raise ValueError(
                    f"deployment name {dn!r} already belongs to "
                    f"application {owner!r}")
        stale = [dn for dn, st in existing.items()
                 if st.get("app") == app_name and dn not in dep_names]
        _deploy_specs(controller, specs)
        for dn in stale:
            ray_tpu_torch.get(controller.delete_deployment.remote(dn))
        if specs:
            # Ingress = the routed deployment (or the last listed one),
            # registered so get_app_handle(name) works for declarative
            # deploys too.
            ingress = next((s["name"] for s in specs
                            if s.get("route_prefix")), specs[-1]["name"])
            ray_tpu_torch.get(controller.set_app_ingress.remote(app_name, ingress))
