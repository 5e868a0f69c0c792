"""Deployment descriptors: @serve.deployment, .bind(), .options().

Counterpart of the reference's serve/deployment.py (Deployment dataclass +
decorator) and the DAG-building `.bind()` API (serve/api.py). A bound
deployment (Application) is a tree: init args may themselves be bound
deployments — the controller materializes children first and injects
DeploymentHandles (model composition, reference: handle.py:625)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Reference: serve/config.py AutoscalingConfig."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0


@dataclasses.dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # Bounded replica-side admission: past max_ongoing + max_queued the
    # replica sheds with PendingCallsLimitError (HTTP 503). None =
    # unbounded queueing (legacy behavior).
    max_queued_requests: Optional[int] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 2.0


class Deployment:
    """An undeployed class + config (reference: serve/deployment.py)."""

    def __init__(self, cls: type, name: str, config: DeploymentConfig,
                 route_prefix: str | None = None):
        self.cls = cls
        self.name = name
        self.config = config
        self.route_prefix = route_prefix
        self.__name__ = name

    def options(self, *, num_replicas: int | None = None, name: str | None = None,
                max_ongoing_requests: int | None = None,
                max_queued_requests: int | None = None,
                autoscaling_config: AutoscalingConfig | dict | None = None,
                ray_actor_options: dict | None = None,
                route_prefix: str | None = None) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        return Deployment(self.cls, name or self.name, cfg,
                          route_prefix if route_prefix is not None else self.route_prefix)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name}, replicas={self.config.num_replicas})"


class Application:
    """A bound deployment graph node (reference: serve/_private/build_app —
    the result of .bind(), accepted by serve.run)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs

    def children(self) -> list["Application"]:
        out = []
        for a in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(a, Application):
                out.append(a)
        return out

    def flatten(self) -> list["Application"]:
        """Post-order: children before parents (deploy order)."""
        seen: list[Application] = []

        def visit(node: "Application"):
            for c in node.children():
                visit(c)
            if node not in seen:
                seen.append(node)

        visit(self)
        return seen


def deployment(cls: type | None = None, *, name: str | None = None,
               num_replicas: int = 1, max_ongoing_requests: int = 16,
               max_queued_requests: int | None = None,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               ray_actor_options: dict | None = None,
               route_prefix: str | None = None) -> Any:
    """``@serve.deployment`` / ``@serve.deployment(num_replicas=3)``."""

    def wrap(c: type) -> Deployment:
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            autoscaling_config=asc,
            ray_actor_options=ray_actor_options or {},
        )
        return Deployment(c, name or c.__name__, cfg, route_prefix)

    if cls is not None:
        return wrap(cls)
    return wrap
