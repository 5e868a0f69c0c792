"""The same script (tests/torch_core_parity_cases.py) under ray_tpu and
under ray_tpu_torch, each in its own process, run side by side: their
JSON outcomes must be equal (results, exception class names, wait
partitions, actor call order and named-actor lookups, the cluster's
resource keys with TPU and GPU mapped to each other)."""

import json
import os
import subprocess
import sys
import threading

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tests", "torch_core_parity_cases.py")


@pytest.fixture(scope="module")
def outcomes():
    results, threads = {}, []

    def run(pkg):
        env = dict(os.environ, PYTHONPATH=ROOT)
        try:
            results[pkg] = subprocess.run(
                [sys.executable, SCRIPT, pkg], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired as e:
            results[pkg] = subprocess.CompletedProcess(
                e.cmd, "timeout", e.stdout, e.stderr)

    for pkg in ("ray_tpu", "ray_tpu_torch"):
        threads.append(threading.Thread(target=run, args=(pkg,)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=150)
        assert not t.is_alive()
    out = {}
    for pkg, proc in results.items():
        assert proc.returncode == 0, (
            f"{pkg} ({proc.returncode}):\n{(proc.stderr or '')[-4000:]}\n"
            f"{(proc.stdout or '')[-2000:]}")
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


KEYS = ["chain", "multi_return", "nested", "stream", "put_get", "task_error",
        "dep_error", "get_timeout", "worker_crash", "not_an_objectref", "wait",
        "wait_all", "actor_counts", "actor_order", "named_lookup",
        "named_missing", "actor_error", "after_kill", "resource_keys",
        "resource_counts"]


@pytest.mark.parametrize("key", KEYS)
def test_outcome_matches(outcomes, key):
    assert outcomes["ray_tpu_torch"][key] == outcomes["ray_tpu"][key]


def test_outcomes_cover_the_script(outcomes):
    assert set(outcomes["ray_tpu"]) == set(KEYS) | {"foreign_modules"}
    assert outcomes["ray_tpu"]["task_error"] == {"raised": "TaskError"}
    assert outcomes["ray_tpu"]["resource_counts"] == {"CPU": 4.0, "CHIP": 2.0}
    # the port's driver loaded neither jax nor any ray_tpu module
    assert outcomes["ray_tpu_torch"]["foreign_modules"] == []
