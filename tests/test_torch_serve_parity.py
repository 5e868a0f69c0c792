"""The same Serve script (tests/torch_serve_parity_cases.py) under ray_tpu
and under ray_tpu_torch, each in its own process (head_shards=1 in
both), run side by side: their JSON outcomes must be equal (status
dicts, HTTP codes and bodies, an SSE stream, routes and applications,
the overload code, batch sizes, multiplexed routing, refusals)."""

import json
import os
import subprocess
import sys
import threading

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tests", "torch_serve_parity_cases.py")


@pytest.fixture(scope="module")
def outcomes():
    results, threads = {}, []

    def run(pkg):
        env = dict(os.environ, PYTHONPATH=ROOT)
        try:
            results[pkg] = subprocess.run(
                [sys.executable, SCRIPT, pkg], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=150)
        except subprocess.TimeoutExpired as e:
            results[pkg] = subprocess.CompletedProcess(e.cmd, "timeout", e.stdout, e.stderr)

    for pkg in ("ray_tpu", "ray_tpu_torch"):
        threads.append(threading.Thread(target=run, args=(pkg,)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive()
    out = {}
    for pkg, proc in results.items():
        assert proc.returncode == 0, (
            f"{pkg} ({proc.returncode}):\n{(proc.stderr or '')[-4000:]}\n"
            f"{(proc.stdout or '')[-2000:]}")
        out[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    return out


KEYS = ["handle", "status_after_run", "missing_app", "http", "sse", "stream_handle",
        "routes", "apps", "gate_first", "overload", "batched", "batch_sizes",
        "multiplex_sticky", "rendezvous", "multiplex_missing_id", "deleted_route",
        "status_before_shutdown", "build_refused", "status_after_shutdown"]


@pytest.mark.parametrize("key", KEYS)
def test_outcome_matches(outcomes, key):
    assert outcomes["ray_tpu_torch"][key] == outcomes["ray_tpu"][key]


def test_outcomes_cover_the_script(outcomes):
    ref = outcomes["ray_tpu"]
    assert set(ref) == set(KEYS) | {"foreign_modules"}
    assert ref["batch_sizes"] == [4, 4]
    assert ref["overload"]["code"] == 503
    # an unknown path falls to "/", the unnamed Echo app's prefix
    assert ref["http"]["missing"] == {"code": 200, "body": {}, "type": "application/json"}
    assert all(v["replicas"] == 1 for v in ref["multiplex_sticky"].values())
    # the port's driver loaded neither jax nor any ray_tpu module
    assert outcomes["ray_tpu_torch"]["foreign_modules"] == []
