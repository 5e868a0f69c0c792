"""Placement groups: gang-scheduled resource bundles.

Counterpart of the reference's placement group API (reference:
python/ray/util/placement_group.py:41 PlacementGroup, :145 placement_group();
GCS-side 2PC scheduler gcs_placement_group_scheduler.h). On GPU clusters a
``{"GPU": k}`` bundle per host pins a gang to each host's NVLink domain
(SURVEY.md §7 "mesh-aware placement groups").
"""

from __future__ import annotations

from typing import Sequence

from ray_tpu_torch._private.ids import ObjectRef
from ray_tpu_torch._private.worker_context import global_runtime

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: list[dict[str, float]]):
        self.id = pg_id
        self.bundle_specs = bundles

    def ready(self) -> ObjectRef:
        """ObjectRef sealed when all bundles are reserved; use with get()."""
        return ObjectRef(self.id + ":ready")

    def wait(self, timeout_seconds: float | None = None) -> bool:
        from ray_tpu_torch import api

        try:
            api.get(self.ready(), timeout=timeout_seconds)
            return True
        except Exception:
            return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs))


def placement_group(
    bundles: Sequence[dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    bundles = [dict(b) for b in bundles]
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    rt = global_runtime()
    reply = rt.conn.call(
        "create_pg", {"bundles": bundles, "strategy": strategy, "name": name}
    )
    return PlacementGroup(reply["pg_id"], bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    global_runtime().conn.call("remove_pg", {"pg_id": pg.id})


def placement_group_table() -> dict:
    rt = global_runtime()
    nodes = rt.conn.call("get_nodes", {})["nodes"]
    return {"nodes": nodes}
