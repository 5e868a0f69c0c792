"""The same script (tests/torch_dag_parity_cases.py) under ray_tpu and
under ray_tpu_torch, each in its own process, run side by side: their
JSON outcomes must be equal. Compiled DAGs (pipelines, fan-out, errors,
local memo, a revisited actor, stream alignment, out-of-order gets, the
fallbacks, a diamond), AllReduceNode, a device edge, util.collective and
the trainer (JaxTrainer against TorchTrainer: reports, iterations,
checkpoints kept and best, a restart after an injected failure, the
Result)."""

import json
import os
import subprocess
import sys
import threading

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tests", "torch_dag_parity_cases.py")


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
            results[pkg] = subprocess.CompletedProcess(
                e.cmd, "timeout", e.stdout, e.stderr)

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


KEYS = ["pipeline", "after_teardown", "fanout", "error_survives", "local_memo",
        "revisited", "stream_aligned", "out_of_order", "const_only",
        "function_fallback", "function_dag", "function_multi_output", "diamond",
        "allreduce", "allreduce_bad_op", "nccl_transport", "device_edge",
        "device_tree_and_driver_read", "device_repeated", "coll_allreduce",
        "coll_barrier", "coll_broadcast", "coll_slow_joiner", "coll_allgather",
        "coll_reducescatter", "coll_p2p", "train_plain", "train_restart",
        "train_failure_raises"]


@pytest.mark.parametrize("key", KEYS)
def test_outcome_matches(outcomes, key):
    assert outcomes["ray_tpu_torch"][key] == outcomes["ray_tpu"][key]


def test_outcomes_cover_the_script(outcomes):
    ref = outcomes["ray_tpu"]
    assert set(ref) == set(KEYS) | {"foreign_modules"}
    # the compiled cases took the channel path, the fallbacks did not
    assert ref["pipeline"][0] == ref["device_edge"][0] == "channels"
    assert ref["const_only"][0] == ref["function_fallback"][0] == "legacy"
    assert ref["device_edge"][1][0][0] is True  # a device array arrived
    assert len(ref["train_restart"]["history"]) == 7
    # the port's driver loaded neither jax nor any ray_tpu module
    assert outcomes["ray_tpu_torch"]["foreign_modules"] == []
