"""ray_tpu_torch.util: placement groups, scheduling strategies, custom
serializers, user trace spans, actor pools, queues, host collective
groups (``util.collective``), user metrics (``util.metrics``: Counter,
Gauge, Histogram, the Prometheus text), the state API (``util.state``)
and the Prometheus/Grafana exporter (``util.metrics_export``);
reference: ray.util. The rest of ray_tpu.util (check_serialize,
multiprocessing, dask, joblib) waits for ROADMAP item 6g."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.placement_group import (
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.queue import Empty, Full, Queue
from ray_tpu_torch.util.serialization import deregister_serializer, register_serializer


def list_named_actors(all_namespaces: bool = False) -> list:
    """Names of live named actors (reference: util/__init__.py:29).

    With ``all_namespaces``, returns [{"namespace": ..., "name": ...}]
    dicts; otherwise the names in the CURRENT namespace."""
    from ray_tpu_torch import api
    from ray_tpu_torch._private.worker_context import global_runtime

    api.auto_init()
    return global_runtime().conn.call(
        "list_named_actors",
        {"all_namespaces": all_namespaces,
         "namespace": api._namespace},
    )["actors"]


__all__ = [
    "ActorPool",
    "Empty",
    "Full",
    "Queue",
    "deregister_serializer",
    "register_serializer",
    "list_named_actors",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
]
