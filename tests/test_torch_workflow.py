"""Durable workflows on the port (ray_tpu_torch.workflow): tests/
test_workflow.py's scenarios (run/resume semantics, dynamic
continuations, idempotent step replay, events, sleep, refusals) on one
port cluster (one head shard), then a step that returns a torch tensor:
stored, resumed, and loaded from storage in a worker that sees no card.
Every wait is bounded: a workflow that never finishes fails its test."""

import os
import threading
import uuid

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import workflow


@pytest.fixture(scope="module", autouse=True)
def _cluster(tmp_path_factory):
    os.environ["RAY_TPU_WORKFLOW_DIR"] = str(tmp_path_factory.mktemp("wf"))
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4, object_store_memory=64 * 1024 * 1024,
                 _system_config={"head_shards": 1})
    yield
    ray_tpu.shutdown()


def _bounded(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` within 90 s (workflow.run and resume wait on
    their steps without a bound of their own); its error re-raised."""
    box = {}

    def call():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(90)
    assert not th.is_alive(), f"{fn.__name__} did not finish in 90 s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _wid():
    return "wf-" + uuid.uuid4().hex[:8]


def test_linear_chain():
    @ray_tpu.remote
    def add(a, b):
        return a + b

    dag = add.bind(add.bind(1, 2), 10)
    assert _bounded(workflow.run, dag, workflow_id=_wid()) == 13


def test_fanout_and_join():
    @ray_tpu.remote
    def sq(x):
        return x * x

    @ray_tpu.remote
    def total(*xs):
        return sum(xs)

    dag = total.bind(*[sq.bind(i) for i in range(5)])
    assert _bounded(workflow.run, dag, workflow_id=_wid()) == sum(i * i for i in range(5))


def test_status_and_output():
    @ray_tpu.remote
    def one():
        return 1

    wid = _wid()
    assert _bounded(workflow.run, one.bind(), workflow_id=wid) == 1
    assert workflow.get_status(wid) == "SUCCESS"
    assert workflow.get_output(wid) == 1
    assert (wid, "SUCCESS") in workflow.list_all()
    workflow.delete(wid)
    assert workflow.get_status(wid) is None


def test_resume_after_failure_replays_only_missing_steps(tmp_path):
    """First run fails at step B; resume loads A from storage (A must not
    re-execute — counted via a side-effect file) and completes."""
    marker = tmp_path / "a_runs"
    flag = tmp_path / "b_ok"

    @ray_tpu.remote(max_retries=0)
    def step_a():
        with open(marker, "a") as f:
            f.write("x")
        return 7

    @ray_tpu.remote(max_retries=0)
    def step_b(x, flag_path):
        if not os.path.exists(flag_path):
            raise RuntimeError("transient failure")
        return x * 2

    wid = _wid()
    dag = step_b.bind(step_a.bind(), str(flag))
    with pytest.raises(Exception):
        _bounded(workflow.run, dag, workflow_id=wid)
    assert workflow.get_status(wid) == "FAILED"
    assert marker.read_text() == "x"

    flag.write_text("ok")
    assert _bounded(workflow.resume, wid) == 14
    assert workflow.get_status(wid) == "SUCCESS"
    assert marker.read_text() == "x"  # step A was NOT replayed


def test_continuation_dynamic_workflow():
    @ray_tpu.remote
    def fib(n):
        if n <= 1:
            return n
        return workflow.continuation(fib_sum.bind(fib.bind(n - 1), fib.bind(n - 2)))

    @ray_tpu.remote
    def fib_sum(a, b):
        return a + b

    assert _bounded(workflow.run, fib.bind(6), workflow_id=_wid()) == 8


def test_run_async():
    @ray_tpu.remote
    def slowly(x):
        import time

        time.sleep(0.2)
        return x + 1

    fut = workflow.run_async(slowly.bind(41), workflow_id=_wid())
    assert fut.result(timeout=60) == 42


def test_rerun_completed_workflow_returns_cached():
    calls = []

    @ray_tpu.remote
    def effect():
        return os.getpid()

    wid = _wid()
    first = _bounded(workflow.run, effect.bind(), workflow_id=wid)
    # Re-running the same finished workflow returns the durable result
    # without re-executing.
    again = _bounded(workflow.run, effect.bind(), workflow_id=wid)
    assert first == again


def test_actor_nodes_rejected():
    @ray_tpu.remote
    class A:
        def f(self):
            return 1

    a = A.remote()
    with pytest.raises(TypeError, match="function steps"):
        _bounded(workflow.run, a.f.bind(), workflow_id=_wid())
    ray_tpu.kill(a)


def test_failed_sibling_does_not_discard_completed_level_mates(tmp_path):
    """One step of a parallel level fails; its completed sibling must be
    persisted so resume never replays it."""
    counter = tmp_path / "good_runs"
    flag = tmp_path / "bad_ok"

    @ray_tpu.remote(max_retries=0)
    def good():
        with open(counter, "a") as f:
            f.write("x")
        return 5

    @ray_tpu.remote(max_retries=0)
    def bad(flag_path):
        if not os.path.exists(flag_path):
            raise RuntimeError("boom")
        return 6

    @ray_tpu.remote
    def join(a, b):
        return a + b

    wid = _wid()
    dag = join.bind(good.bind(), bad.bind(str(flag)))
    with pytest.raises(Exception):
        _bounded(workflow.run, dag, workflow_id=wid)
    assert counter.read_text() == "x"
    flag.write_text("ok")
    assert _bounded(workflow.resume, wid) == 11
    assert counter.read_text() == "x"  # good() ran exactly once


def test_reused_id_with_different_dag_rejected():
    @ray_tpu.remote(max_retries=0)
    def fail_then(x):
        raise RuntimeError("always fails")

    wid = _wid()
    with pytest.raises(Exception):
        _bounded(workflow.run, fail_then.bind(1), workflow_id=wid)
    with pytest.raises(ValueError, match="different DAG"):
        _bounded(workflow.run, fail_then.bind(2), workflow_id=wid)  # changed args


def test_continuation_parent_not_replayed_on_resume(tmp_path):
    """Failure INSIDE a continuation subgraph: resume finishes the
    subgraph without re-running the parent step (its side effect fired)."""
    parent_marker = tmp_path / "parent_runs"
    flag = tmp_path / "sub_ok"

    @ray_tpu.remote(max_retries=0)
    def parent(flag_path):
        with open(parent_marker, "a") as f:
            f.write("p")
        return workflow.continuation(sub.bind(flag_path))

    @ray_tpu.remote(max_retries=0)
    def sub(flag_path):
        if not os.path.exists(flag_path):
            raise RuntimeError("sub fails first time")
        return "done"

    wid = _wid()
    with pytest.raises(Exception):
        _bounded(workflow.run, parent.bind(str(flag)), workflow_id=wid)
    assert parent_marker.read_text() == "p"
    flag.write_text("ok")
    assert _bounded(workflow.resume, wid) == "done"
    assert parent_marker.read_text() == "p"  # parent ran exactly once


def test_success_id_with_different_dag_raises():
    @ray_tpu.remote
    def val(x):
        return x

    wid = _wid()
    assert _bounded(workflow.run, val.bind(1), workflow_id=wid) == 1
    with pytest.raises(ValueError, match="different DAG"):
        _bounded(workflow.run, val.bind(2), workflow_id=wid)
    # Same DAG still returns the cached result.
    assert _bounded(workflow.run, val.bind(1), workflow_id=wid) == 1


def test_run_rerun_resumes_continuation(tmp_path):
    """run() (not resume) re-invoked after a failure inside a continuation
    must pick up the merged spec, not clobber it (regression)."""
    flag = tmp_path / "go"

    @ray_tpu.remote(max_retries=0)
    def parent(flag_path):
        return workflow.continuation(child.bind(flag_path))

    @ray_tpu.remote(max_retries=0)
    def child(flag_path):
        if not os.path.exists(flag_path):
            raise RuntimeError("first attempt fails")
        return 99

    wid = _wid()
    with pytest.raises(Exception):
        _bounded(workflow.run, parent.bind(str(flag)), workflow_id=wid)
    flag.write_text("ok")
    assert _bounded(workflow.run, parent.bind(str(flag)), workflow_id=wid) == 99


def test_wait_for_event_kv(tmp_path):
    """Events gate workflow steps; checkpointed exactly-once (reference:
    workflow/api.py wait_for_event + event system tests)."""
    import time

    @ray_tpu.remote
    def finalize(payload):
        return f"done:{payload}"

    key = "evt-" + uuid.uuid4().hex[:6]
    dag = finalize.bind(workflow.wait_for_event(key, timeout_s=30))
    wid = _wid()

    def fire():
        time.sleep(0.5)
        workflow.trigger_event(key, "approved")

    t = threading.Thread(target=fire)
    t.start()
    out = _bounded(workflow.run, dag, workflow_id=wid)
    t.join(timeout=30)
    assert out == "done:approved"
    # Resume replays the checkpointed event without waiting again (the
    # event key is NOT re-fired; a re-wait would block 30s and time out).
    assert _bounded(workflow.resume, wid) == "done:approved"


def test_wait_for_event_timeout():
    @ray_tpu.remote
    def use(x):
        return x

    dag = use.bind(workflow.wait_for_event("never-" + uuid.uuid4().hex[:6],
                                           timeout_s=0.3))
    with pytest.raises(Exception, match="no event"):
        _bounded(workflow.run, dag, workflow_id=_wid())


def test_wait_for_event_custom_listener():
    class Instant(workflow.EventListener):
        def poll_for_event(self):
            return 42

    @ray_tpu.remote
    def use(x):
        return x + 1

    dag = use.bind(workflow.wait_for_event(Instant))
    assert _bounded(workflow.run, dag, workflow_id=_wid()) == 43

    with pytest.raises(TypeError, match="EventListener"):
        workflow.wait_for_event(123)


def test_workflow_sleep_resumes_original_deadline(tmp_path):
    """workflow.sleep computes its deadline in a checkpointed step
    (reference: workflow/api.py sleep + TimerListener): the wait is
    against wall-clock, and completes promptly once the deadline has
    passed."""
    import time

    @ray_tpu.remote
    def stamp(ts):
        return ("done", float(ts))

    t0 = time.time()
    out = _bounded(workflow.run, stamp.bind(workflow.sleep(0.8)),
                       workflow_id=f"wf-sleep-{os.getpid()}")
    waited = time.time() - t0
    assert out[0] == "done"
    assert out[1] >= t0 + 0.75
    assert waited >= 0.75


def test_default_storage_is_the_ports_own(monkeypatch, tmp_path):
    """Without RAY_TPU_WORKFLOW_DIR, workflows live under
    $TMPDIR/ray_tpu_torch/workflows, beside the port's sessions."""
    monkeypatch.delenv("RAY_TPU_WORKFLOW_DIR")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert workflow._base_dir() == str(tmp_path / "ray_tpu_torch" / "workflows")


def test_tensor_step_is_stored_resumed_and_loads_without_a_card(tmp_path):
    """A step's torch tensor is stored as host bytes: the failed run keeps
    it, resume replays it from storage (the step does not run again), and
    a worker that sees no card loads the stored value as a CPU tensor."""
    import numpy as np
    import torch

    marker = tmp_path / "tensor_runs"
    flag = tmp_path / "finalize_ok"

    @ray_tpu.remote(max_retries=0)
    def make(n):
        with open(marker, "a") as f:
            f.write("x")
        g = torch.Generator().manual_seed(n)
        return torch.randn(4, 8, generator=g, dtype=torch.float32).to(torch.bfloat16)

    @ray_tpu.remote(max_retries=0)
    def finalize(t, flag_path):
        if not os.path.exists(flag_path):
            raise RuntimeError("finalize fails first")
        return t.float().sum(dim=1)

    wid = _wid()
    with pytest.raises(Exception):
        _bounded(workflow.run, finalize.bind(make.bind(3), str(flag)), workflow_id=wid)
    flag.write_text("ok")
    out = _bounded(workflow.resume, wid)
    want = torch.randn(4, 8, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    assert torch.equal(out, want.float().sum(dim=1))
    assert marker.read_text() == "x"  # make() ran once
    store = workflow._Store(wid)
    sid = next(s for s in os.listdir(store.steps_dir) if "make" in s)

    @ray_tpu.remote
    def load_stored(path):
        import os as _os

        import cloudpickle

        with open(path, "rb") as f:
            t = cloudpickle.loads(f.read())
        return (_os.environ.get("CUDA_VISIBLE_DEVICES"), t.device.type, str(t.dtype),
                t.float().numpy())

    visible, device, dtype, values = ray_tpu.get(
        load_stored.remote(os.path.join(store.steps_dir, sid)), timeout=60)
    assert (visible, device, dtype) == ("", "cpu", "torch.bfloat16")
    np.testing.assert_array_equal(values, want.float().numpy())
