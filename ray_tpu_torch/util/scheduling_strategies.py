"""Public scheduling strategies (reference:
python/ray/util/scheduling_strategies.py — NodeAffinitySchedulingStrategy,
PlacementGroupSchedulingStrategy, plus the "DEFAULT"/"SPREAD" string
strategies). The dataclasses live with the cluster scheduler; this module
is the user-facing import path:

    from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy
    f.options(scheduling_strategy=NodeAffinitySchedulingStrategy(node_id, soft=True))
"""

from ray_tpu_torch._private.scheduler import (
    DoesNotExist,
    Exists,
    In,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    NotIn,
    PlacementGroupSchedulingStrategy,
)

DEFAULT_SCHEDULING_STRATEGY = "DEFAULT"
SPREAD_SCHEDULING_STRATEGY = "SPREAD"

__all__ = [
    "DEFAULT_SCHEDULING_STRATEGY",
    "SPREAD_SCHEDULING_STRATEGY",
    "NodeAffinitySchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "PlacementGroupSchedulingStrategy",
    "In",
    "NotIn",
    "Exists",
    "DoesNotExist",
]
