"""Usage stats: opt-out, local-file only.

Counterpart of the reference's usage_lib
(reference: python/ray/_private/usage/usage_lib.py:220,390 — opt-out
telemetry reporting cluster metadata). This build never egresses:
a summary JSON is written under the session dir so operators can see
exactly what WOULD be reported; RAY_TPU_USAGE_STATS_ENABLED=0 disables
even that.
"""

from __future__ import annotations

import json
import os
import time


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_ENABLED", "1") not in ("0", "false")


def record_cluster_usage(head) -> str | None:
    """Write the local usage summary; returns the path (or None if off)."""
    if not usage_stats_enabled():
        return None
    # NEVER import torch here: this runs inside Head startup, and
    # initializing CUDA in the head daemon would hold a context on the
    # devices the workers lease (the head detects GPUs from device
    # files and env only — see gcs._detect_resources).
    num_gpus = int(head.node_resources.get("GPU", 0))
    backend = "cuda" if num_gpus else "cpu"
    from ray_tpu_torch._version import __version__

    payload = {
        "schema_version": 1,
        "ray_tpu_version": __version__,
        "session_id": head.session_id,
        "collected_at": time.time(),
        "total_num_cpus": head.node_resources.get("CPU", 0),
        "total_num_gpus": num_gpus,
        "accelerator_backend": backend,
        "os": os.uname().sysname.lower(),
    }
    path = os.path.join(head.session_dir, "usage_stats.json")
    try:
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
    except OSError:
        return None
    return path
