"""The same Data pipelines (tests/torch_data_parity_cases.py) under
ray_tpu and under ray_tpu_torch, each in its own process on its own
cluster (head_shards=1), side by side: equal rows from take_all, sort,
a seeded shuffle, groupby aggregates, unions, zips and splits, and from
files written and read back (parquet, csv, json, numpy, tfrecords);
preprocessors' fitted statistics and transformed rows within 1e-6."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tests", "torch_data_parity_cases.py")


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    results, threads = {}, []

    def run(pkg):
        out_dir = str(tmp_path_factory.mktemp(pkg))
        env = dict(os.environ, PYTHONPATH=ROOT)
        try:
            results[pkg] = subprocess.run(
                [sys.executable, SCRIPT, pkg, out_dir], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired as e:
            results[pkg] = subprocess.CompletedProcess(e.cmd, "timeout", e.stdout, e.stderr)

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


EXACT = ["map_filter", "map_rows", "sort", "sort_desc", "shuffle", "group_count",
         "group_sum", "group_mean", "group_std", "group_agg", "stats", "union", "zip",
         "split", "split_at", "limit_repartition", "batches", "discretize", "parquet",
         "csv", "json", "numpy", "tfrecords"]
CLOSE = ["fitted", "chain_rows"]


@pytest.mark.parametrize("key", EXACT)
def test_rows_match(outcomes, key):
    assert outcomes["ray_tpu_torch"][key] == outcomes["ray_tpu"][key]


def _close(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("key", CLOSE)
def test_fitted_statistics_match(outcomes, key):
    _close(outcomes["ray_tpu_torch"][key], outcomes["ray_tpu"][key], key)


def test_outcomes_cover_the_script(outcomes):
    assert set(outcomes["ray_tpu"]) == set(EXACT) | set(CLOSE) | {"foreign_modules"}
    assert outcomes["ray_tpu_torch"]["foreign_modules"] == []
