"""The state API, job submission, metrics export and the dashboard on the
port (ray_tpu_torch.util.state, .job_submission, .util.metrics_export,
.dashboard), on one
port cluster (init(num_cpus=8, num_gpus=1): "GPU" from resources alone;
one head shard):

- tests/test_state_util.py's state scenarios: tasks and their summary,
  actor states, objects and store stats, workers and nodes, the Chrome
  trace, the object summary, placement groups and jobs;
- tests/test_dag_jobs.py's job scenarios (lifecycle, a driver joining the
  cluster, failure, a stop from another client, a supervisor's death)
  and that the entrypoint inherits its supervisor's CUDA_VISIBLE_DEVICES=""
  (a job reaches the card through num_gpus tasks), whose num_gpus task
  is counted by summarize_tasks;
- metrics_export: the scrape config, service discovery, the Grafana
  dashboard (its default panels over series the exposition emits) and
  the alert rules, equal to ray_tpu's;
- the dashboard: tests/test_dag_jobs.py's and test_dashboard_data.py's
  endpoints (serve, logs, train, nodes, drill-downs, the three profilers,
  the exposition and Grafana), and its UI with a GPU chip row.

Every get, wait and HTTP call is bounded."""

from __future__ import annotations

import json
import os
import signal
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import state as us

T = 60


@pytest.fixture(scope="module", autouse=True)
def _cluster():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=1, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1})
    yield
    rt.shutdown()


def _until(cond, timeout=10.0, every=0.1):
    """Poll ``cond`` until it is true or ``timeout`` passes; its last value."""
    deadline = time.monotonic() + timeout
    value = cond()
    while not value and time.monotonic() < deadline:
        time.sleep(every)
        value = cond()
    return value


# ---------------------------------------------------------------------------
# state API


def test_list_tasks_and_summary():
    @rt.remote
    def work(x):
        return x * 2

    rt.get([work.remote(i) for i in range(5)], timeout=T)

    def mine():
        rows = [t for t in us.list_tasks() if t["name"] == "work"]
        return rows if len(rows) == 5 and all(t["state"] == "FINISHED" for t in rows) else None

    assert _until(mine)
    summary = us.summarize_tasks()
    assert summary["work"]["total"] == 5
    assert summary["work"]["state_counts"].get("FINISHED") == 5
    assert us.get_task(mine()[0]["task_id"])["name"] == "work"


def test_list_actors_states():
    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    rt.get(a.ping.remote(), timeout=T)
    actors = us.list_actors(filters=[("state", "=", "ALIVE")])
    assert any(x["state"] == "ALIVE" for x in actors)
    assert us.get_actor(a._actor_id)["state"] == "ALIVE"
    rt.kill(a)
    assert _until(lambda: us.list_actors(filters=[("state", "=", "DEAD")]))
    assert us.summarize_actors()["state_counts"].get("DEAD", 0) >= 1


def test_list_objects_and_store_stats():
    ref = rt.put(b"x" * 1024)
    objs = us.list_objects()
    assert any(o["object_id"] == ref.hex() for o in objs)
    assert us.get_object(ref.hex())["object_id"] == ref.hex()
    stats = us.object_store_stats()
    assert stats["capacity"] > 0
    assert "in_use" in stats


def test_list_workers_and_nodes():
    nodes = us.list_nodes()
    assert len(nodes) == 1 and nodes[0]["resources"]["GPU"] == 1.0
    assert isinstance(us.list_workers(), list)


def test_timeline_chrome_trace(tmp_path):
    @rt.remote
    def traced():
        time.sleep(0.01)
        return 1

    rt.get([traced.remote() for _ in range(3)], timeout=T)

    def mine():
        path = us.timeline(str(tmp_path / "trace.json"))
        with open(path) as f:
            events = [e for e in json.load(f) if e["name"] == "traced"]
        return events if len(events) == 3 else None

    events = _until(mine)
    assert events and all(e["ph"] == "X" and e["dur"] > 0 for e in events)


def test_summarize_objects():
    import numpy as np

    ref = rt.put(np.zeros(1000))
    summary = us.summarize_objects()
    assert summary["total"] >= 1
    assert summary["total_bytes"] > 0
    assert "SEALED" in summary["state_counts"]
    del ref


def test_list_placement_groups_and_jobs():
    from ray_tpu_torch.util import placement_group, remove_placement_group

    pg = placement_group([{"CPU": 1}], strategy="PACK", name="statepg")
    rt.get(pg.ready(), timeout=30)
    rows = us.list_placement_groups()
    mine = [r for r in rows if r["name"] == "statepg"]
    assert mine and mine[0]["state"] == "CREATED"
    assert mine[0]["bundles"] == [{"CPU": 1}]
    assert us.list_placement_groups(filters=[("state", "=", "CREATED")])
    remove_placement_group(pg)
    assert isinstance(us.list_jobs(), list)


def test_health_metrics_and_alert_queries_answer():
    health = us.health_summary()
    assert {"gauges", "counters", "breakers"} <= set(health)
    assert "series" in us.query_metrics("ray_tpu_tasks_finished_total")
    assert "alerts" in us.list_alerts(history=True)
    assert isinstance(us.list_crash_reports(), list)
    assert "windows" in us.cluster_profile()


def test_flamegraph_and_speedscope_files(tmp_path):
    profile = {"worker_id": "w1", "folded": {"a.py:main;b.py:work": 3, "a.py:main": 1}}
    path = us.save_flamegraph(profile, str(tmp_path / "f.txt"))
    with open(path) as f:
        assert sorted(f.read().splitlines()) == ["a.py:main 1", "a.py:main;b.py:work 3"]
    doc = json.load(open(us.save_speedscope(profile, str(tmp_path / "s.json"))))
    assert [f["name"] for f in doc["shared"]["frames"]] == ["a.py:main", "b.py:work"]
    assert doc["profiles"][0]["samples"] == [[0, 1], [0]]
    assert doc["profiles"][0]["weights"] == [3, 1]


# ---------------------------------------------------------------------------
# jobs


def _client():
    from ray_tpu_torch.job_submission import JobSubmissionClient

    return JobSubmissionClient()


def test_job_submission_lifecycle():
    client = _client()
    job_id = client.submit_job(
        entrypoint="python -c \"import os; print('job ran ok', os.environ['MY_FLAG'])\"",
        runtime_env={"env_vars": {"MY_FLAG": "42"}},
    )
    assert client.wait_until_finished(job_id, timeout_s=T) == "SUCCEEDED"
    assert "job ran ok 42" in client.get_job_logs(job_id)
    assert any(j["job_id"] == job_id for j in client.list_jobs())
    assert any(j["job_id"] == job_id for j in us.list_jobs())


def test_job_entrypoint_sees_no_card_and_reaches_it_through_a_gpu_task():
    """The supervisor holds no lease: the entrypoint inherits
    CUDA_VISIBLE_DEVICES="" (the reference's inherits JAX_PLATFORMS=cpu);
    its num_gpus=1 task is pinned to device 0 and summarize_tasks counts
    it."""
    script = (
        "import os, ray_tpu_torch as rt; rt.init();"
        "f = rt.remote(num_gpus=1)(lambda: os.environ.get('CUDA_VISIBLE_DEVICES'));"
        "print('DRIVER', repr(os.environ.get('CUDA_VISIBLE_DEVICES')),"
        " 'TASK', repr(rt.get(f.options(name='job_gpu_task').remote(), timeout=60)))"
    )
    client = _client()
    job_id = client.submit_job(entrypoint=f'python -c "{script}"')
    status = client.wait_until_finished(job_id, timeout_s=90)
    logs = client.get_job_logs(job_id)
    assert status == "SUCCEEDED", logs
    assert "DRIVER '' TASK '0'" in logs
    assert _until(lambda: us.summarize_tasks().get("job_gpu_task", {}).get("total") == 1)


def test_job_driver_joins_cluster():
    @rt.remote(name="job_target", num_cpus=0)
    class Target:
        def hello(self):
            return "from-cluster"

    t = Target.remote()
    rt.get(t.hello.remote(), timeout=T)
    script = (
        "import ray_tpu_torch as rt; rt.init();"
        "a = rt.get_actor('job_target');"
        "print('GOT:', rt.get(a.hello.remote(), timeout=60))"
    )
    client = _client()
    job_id = client.submit_job(entrypoint=f'python -c "{script}"')
    status = client.wait_until_finished(job_id, timeout_s=90)
    logs = client.get_job_logs(job_id)
    assert status == "SUCCEEDED", logs
    assert "GOT: from-cluster" in logs
    rt.kill(t)


def test_job_failure_reported():
    client = _client()
    job_id = client.submit_job(entrypoint="python -c 'raise SystemExit(3)'")
    assert client.wait_until_finished(job_id, timeout_s=T) == "FAILED"
    assert "exited with code 3" in client.get_job_info(job_id)["message"]


def test_job_stop_from_another_client():
    a = _client()
    job_id = a.submit_job(entrypoint="python -c 'import time; time.sleep(60)'")
    _until(lambda: a.get_job_status(job_id) != "PENDING", timeout=30)
    # A different client stops it: supervisors live in the shared
    # JobManager actor, not in the submitting client.
    b = _client()
    assert b.stop_job(job_id) is True
    assert b.wait_until_finished(job_id, timeout_s=30) == "STOPPED"


def test_job_supervisor_death_marks_failed():
    client = _client()
    before = {a["actor_id"] for a in us.list_actors()}
    job_id = client.submit_job(entrypoint="python -c 'import time; time.sleep(120)'")
    _until(lambda: client.get_job_status(job_id) != "PENDING", timeout=30)
    new = [a for a in us.list_actors()
           if a["actor_id"] not in before and a["state"] == "ALIVE"]
    assert len(new) == 1  # the supervisor (the JobManager already existed)
    os.kill(new[0]["pid"], signal.SIGKILL)
    assert _until(lambda: client.get_job_status(job_id) == "FAILED", timeout=30, every=0.3)
    info = client.get_job_info(job_id)
    assert "supervisor died" in info["message"]


# ---------------------------------------------------------------------------
# metrics export


def test_scrape_config_and_service_discovery():
    from ray_tpu_torch.util import metrics_export as me

    assert me.prometheus_sd("1.2.3.4", 9999) == [{
        "targets": ["1.2.3.4:9999"],
        "labels": {"job": "ray_tpu", "__metrics_path__": "/metrics"}}]
    cfg = me.prometheus_scrape_config("h", 1)
    assert "job_name: ray_tpu\n" in cfg and "targets: ['h:1']" in cfg


def test_grafana_dashboard_reads_the_series_the_exposition_emits():
    from ray_tpu_torch.util import metrics as um
    from ray_tpu_torch.util import metrics_export as me

    @rt.remote
    def unit():
        return 1

    assert rt.get([unit.remote() for _ in range(5)], timeout=T) == [1] * 5
    text = _until(lambda: (lambda t: t if "ray_tpu_tasks_finished_total " in t else None)(
        um.prometheus_text()))
    assert "# TYPE ray_tpu_tasks_finished_total counter" in text
    dash = json.loads(me.grafana_dashboard_json(["my_metric"]))
    assert dash["uid"] == "ray-tpu-cluster"
    exprs = [t["expr"] for p in dash["panels"] for t in p.get("targets", [])]
    for expr in exprs[:6]:
        name = expr.split("(")[-1].split("[")[0].rstrip(")")
        assert name in text, (name, expr)
    assert dash["panels"][-1]["title"] == "my_metric"
    rules = json.loads(me.grafana_alert_rules_json())
    assert rules["groups"][0]["rules"] and all(
        r["uid"].startswith("ray-tpu-") for r in rules["groups"][0]["rules"])


def test_metrics_export_equals_the_references():
    """The same dashboard and alert bundle as ray_tpu's, from the same
    rule registry: a dashboard or alerting written for ray_tpu reads the
    port's cluster unchanged. (ray_tpu is imported in a subprocess:
    workers import this module, which must not load it.)"""
    import subprocess
    import sys

    from ray_tpu_torch.util import metrics_export as me

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import json; from ray_tpu.util import metrics_export as me;"
            "print(json.dumps([me.grafana_dashboard(['x']), me.grafana_alert_rules(),"
            " me.prometheus_sd('h', 1), me.prometheus_scrape_config('h', 1)]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root, env=dict(os.environ, PYTHONPATH=root,
                                                          JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    mine = json.loads(json.dumps([me.grafana_dashboard(["x"]), me.grafana_alert_rules(),
                                  me.prometheus_sd("h", 1), me.prometheus_scrape_config("h", 1)]))
    assert mine == ref


# ---------------------------------------------------------------------------
# the dashboard (tests/test_dag_jobs.py's and tests/test_dashboard_data.py's
# endpoints)


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        body = r.read().decode()
    try:
        return json.loads(body)
    except json.JSONDecodeError:
        return body


@pytest.fixture()
def dashboard():
    from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard

    yield start_dashboard()
    stop_dashboard()


def _worker_of(actor):
    from ray_tpu_torch._private.worker_context import get_head

    def find():
        return next((w.worker_id for w in get_head().workers.values()
                     if w.actor_id == actor._actor_id and w.pid is not None), None)

    return _until(find)


def test_dashboard_endpoints(dashboard):
    import urllib.error

    @rt.remote
    def traced_job():
        return 1

    rt.get(traced_job.remote(), timeout=T)
    cluster = _get(dashboard, "/api/cluster")
    assert cluster["resources_total"]["CPU"] == 8.0
    assert cluster["resources_total"]["GPU"] == 1.0
    assert _until(lambda: any(t["name"] == "traced_job"
                              for t in _get(dashboard, "/api/tasks")["tasks"]))
    assert "<html" in _get(dashboard, "/").lower()
    assert "# TYPE" in _get(dashboard, "/metrics")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(dashboard, "/api/nope")
    assert ei.value.code == 404


def test_dashboard_web_ui_served(dashboard):
    html = _get(dashboard, "/")
    assert "ray_tpu_torch dashboard" in html
    for endpoint in ("/api/cluster", "/api/tasks", "/api/actors"):
        assert endpoint in html
    # the chip row reads the GPU resource (the reference's reads TPU)
    assert '["GPU", `${avail.GPU ?? 0} / ${tot.GPU ?? 0}`]' in html
    assert "avail.TPU" not in html


def test_dashboard_serve_and_log_endpoints(dashboard):
    from ray_tpu_torch import serve
    from tests.torch_serve_helpers import Doubler

    @rt.remote
    def noisy():
        print("NOISY-LINE")
        return 1

    assert rt.get(noisy.remote(), timeout=T) == 1
    serve.run(Doubler.bind(), route_prefix="/dbl", proxy=False)
    try:
        assert "Doubler" in _get(dashboard, "/api/serve")["deployments"]
        apps = _get(dashboard, "/api/serve/apps")["apps"]
        app = next(iter(apps.values()))
        assert "Doubler" in app["deployments"]
        assert any(r["prefix"] == "/dbl" for r in app["routes"])

        def found():
            logs = _get(dashboard, "/api/logs")["logs"]
            assert logs and all("name" in entry and "bytes" in entry for entry in logs)
            return any(any("NOISY-LINE" in ln for ln in _get(
                dashboard, f"/api/logs/{entry['name']}")["lines"]) for entry in logs)

        assert _until(found, timeout=15, every=0.5)
        assert _get(dashboard, "/api/logs/..%2Fsecrets")["lines"] == []  # no traversal
    finally:
        serve.delete("Doubler")
        serve.shutdown()


def _two_reports(config):
    from ray_tpu_torch import train

    for i in range(2):
        train.report({"loss": 1.0 / (i + 1)})


def test_dashboard_train_and_node_detail(dashboard):
    from ray_tpu_torch import train

    result = train.TorchTrainer(
        _two_reports, scaling_config=train.ScalingConfig(num_workers=1),
        backend_config=train.TorchConfig(device="cpu")).fit()
    assert result.error is None
    runs = _until(lambda: _get(dashboard, "/api/train")["runs"])
    assert runs[0]["status"] == "FINISHED" and runs[0]["iterations"] == 2
    assert runs[0]["last_metrics"]["loss"] == pytest.approx(0.5)
    nodes = _get(dashboard, "/api/cluster")["nodes"]
    detail = _get(dashboard, f"/api/nodes/{nodes[0]['node_id']}")
    assert detail["node"]["node_id"] == nodes[0]["node_id"]
    assert isinstance(detail["workers"], list) and isinstance(detail["tasks"], list)
    ui = _get(dashboard, "/")
    assert 'data-view="train"' in ui and "/api/serve/apps" in ui and "/api/nodes/" in ui


def test_dashboard_task_and_actor_drilldown(dashboard):
    import urllib.error

    @rt.remote
    def drilled():
        print("DRILL-LINE")
        return 7

    assert rt.get(drilled.remote(), timeout=T) == 7

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert rt.get(c.incr.remote(), timeout=T) == 1
    row = _until(lambda: next((t for t in _get(dashboard, "/api/tasks")["tasks"]
                               if t["name"] == "drilled" and t["state"] == "FINISHED"), None))

    def detail():
        d = _get(dashboard, f"/api/tasks/{row['task_id']}")
        ok = (any(e["task_id"] == row["task_id"] for e in d["events"])
              and any("DRILL-LINE" in ln for ln in d["worker_log"].get("lines", [])))
        return d if ok else None

    d = _until(detail, timeout=15, every=0.3)
    assert d and d["task"]["state"] == "FINISHED"
    adetail = _get(dashboard, f"/api/actors/{c._actor_id}")
    assert adetail["actor"]["actor_id"] == c._actor_id and adetail["actor"]["worker_id"]
    assert isinstance(adetail["tasks"], list) and adetail["tasks"]
    assert "worker_log" in adetail
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(dashboard, "/api/tasks/nonexistent")
    assert ei.value.code == 404
    ui = _get(dashboard, "/")
    assert "/api/tasks/" in ui and "/api/actors/" in ui and "taskId" in ui
    assert 'data-view="metrics"' in ui and "spark(" in ui
    rt.kill(c)


def test_dashboard_live_profile_endpoint(dashboard):
    """/api/profile/<worker_id>: every thread's stack of a live worker."""

    @rt.remote
    class Sleeper:
        def park(self):
            time.sleep(8)

        def ping(self):
            return 1

    s = Sleeper.remote()
    rt.get(s.ping.remote(), timeout=T)
    fut = s.park.remote()  # in flight: the dump shows it on the stack
    time.sleep(0.5)
    out = _get(dashboard, f"/api/profile/{_worker_of(s)}")
    assert out.get("stacks"), out
    text = "\n".join(out["stacks"])
    assert "Thread" in text and "park" in text, text[:500]
    assert _get(dashboard, "/api/profile/worker-nope")["error"] == "unknown worker"
    del fut
    rt.kill(s)  # parked: not waited for


def test_dashboard_sampling_and_memory_profilers(dashboard):
    """?duration=N: folded stacks of a busy worker, the hot method
    dominating; &mode=memory: the allocations of the window."""

    @rt.remote
    class Busy:
        def spin_hotly(self, seconds):
            t0 = time.time()
            x = 0
            while time.time() - t0 < seconds:
                x += 1
            return x

        def churn(self, seconds):
            t0 = time.time()
            keep = []
            while time.time() - t0 < seconds:
                keep.append(bytes(64 * 1024))
                if len(keep) > 64:
                    keep.pop(0)
            return len(keep)

        def ping(self):
            return 1

    b = Busy.options(max_concurrency=2).remote()
    rt.get(b.ping.remote(), timeout=T)
    worker = _worker_of(b)
    fut = b.spin_hotly.remote(4.0)
    time.sleep(0.3)
    out = _get(dashboard, f"/api/profile/{worker}?duration=1.5")
    assert out.get("samples", 0) > 10, out
    folded = out.get("folded") or {}
    hot = sum(n for stack, n in folded.items() if "spin_hotly" in stack)
    assert hot > 0.2 * sum(folded.values()), (hot, list(folded)[:5])
    assert any(";" in stack for stack in folded)
    rt.get(fut, timeout=T)
    fut = b.churn.remote(8.0)
    time.sleep(0.3)
    for _ in range(4):
        out = _get(dashboard, f"/api/profile/{worker}?duration=1.5&mode=memory")
        allocs = out.get("allocations") or {}
        if allocs and sum(v["bytes"] for v in allocs.values()) > 64 * 1024:
            break
    else:
        raise AssertionError(f"no allocations captured in 4 windows: {out}")
    del fut
    rt.kill(b)  # still churning: not waited for


def test_dashboard_metrics_exposition_and_grafana(dashboard):
    @rt.remote
    def unit():
        return 1

    assert rt.get([unit.remote() for _ in range(5)], timeout=T) == [1] * 5

    def finished():
        text = _get(dashboard, "/metrics")
        n = next((float(ln.split()[1]) for ln in text.splitlines()
                  if ln.startswith("ray_tpu_tasks_finished_total ")), 0)
        return text if n >= 5 else None

    text = _until(finished)
    assert "ray_tpu_workers_alive" in text and "ray_tpu_object_store_used_bytes" in text
    dash = _get(dashboard, "/api/grafana_dashboard")
    assert dash["uid"] == "ray-tpu-cluster"
    sd = _get(dashboard, "/api/prometheus_sd?host=1.2.3.4&port=9999")
    assert sd[0]["targets"] == ["1.2.3.4:9999"]
    assert _get(dashboard, "/api/grafana_alerts")["groups"]
