"""The serving plane of the port's Serve on one module cluster: the
scenarios of tests/test_serve_plane.py (the continuous batcher, deadline
sheds at the handle, the replica and the batch queue, overload and
deadline codes at the proxy, client disconnects, replica death and
drain, queue-depth autoscaling, the controller's telemetry and gauges)
run against ray_tpu_torch.serve.

Every get, handle result and HTTP call has a timeout. The module
imports neither torch nor ray_tpu.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import threading
import time
import urllib.error

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import PendingCallsLimitError, TaskTimeoutError
from ray_tpu_torch.serve.scheduler import ContinuousBatcher, LatencyModel
from tests.torch_serve_helpers import T, http, http_error, wait_until


@pytest.fixture(scope="module", autouse=True)
def _cluster():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, object_store_memory=128 * 1024 * 1024,
            _system_config={"head_shards": 1})
    yield
    serve.shutdown()
    rt.shutdown()


@pytest.fixture(autouse=True)
def _clean_apps():
    yield
    try:
        for name in list(serve.status()):
            serve.delete(name)
    except Exception:
        pass


def test_routing_survives_a_killed_replica():
    """SIGKILL one of two replicas mid-traffic: retries re-route to the
    survivor, and the controller restores the replica set."""

    @serve.deployment(num_replicas=2)
    class Pid:
        def __call__(self, _):
            return os.getpid()

    h = serve.run(Pid.bind(), proxy=False)
    wait_until(lambda: serve.status()["Pid"]["running_replicas"] == 2, msg="2 replicas")
    pids = {h.remote({}).result(timeout_s=T) for _ in range(20)}
    assert len(pids) == 2
    os.kill(sorted(pids)[0], signal.SIGKILL)
    ok = 0
    for _ in range(20):
        try:
            h.remote({}).result(timeout_s=T)
            ok += 1
        except Exception:  # noqa: BLE001 — a straggler may exhaust retries
            pass
    assert ok >= 15, f"only {ok}/20 requests survived the replica's death"
    wait_until(lambda: serve.status()["Pid"]["running_replicas"] == 2, timeout=30,
          msg="the controller never restored 2 replicas")


def test_replica_death_without_retries_surfaces_died_error():
    @serve.deployment
    class Victim:
        def __call__(self, _):
            time.sleep(1.5)
            return os.getpid()

    h = serve.run(Victim.bind(), proxy=False)
    pid = h.remote({}).result(timeout_s=T)
    resp = h.options(max_retries=0).remote({})
    time.sleep(0.3)  # the call is in flight on the replica
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(Exception) as ei:
        resp.result(timeout_s=T)
    msg = str(ei.value) + repr(ei.value)
    assert "ActorDiedError" in msg or "died" in msg.lower()


def test_scale_down_drains_inflight_requests():
    @serve.deployment(num_replicas=2)
    class Steady:
        def __call__(self, payload):
            time.sleep(float(payload.get("sleep", 0)))
            return "done"

    h = serve.run(Steady.bind(), proxy=False)
    wait_until(lambda: serve.status()["Steady"]["running_replicas"] == 2, msg="2 replicas")
    inflight = [h.remote({"sleep": 1.5}) for _ in range(6)]
    time.sleep(0.3)
    serve.run(Steady.options(num_replicas=1).bind(), proxy=False)
    assert [r.result(timeout_s=T) for r in inflight] == ["done"] * 6
    wait_until(lambda: serve.status()["Steady"]["running_replicas"] == 1, timeout=30,
          msg="never scaled down to 1")
    wait_until(lambda: serve.status()["Steady"]["draining_replicas"] == 0, timeout=30,
          msg="the drained replica was never reaped")
    assert h.remote({}).result(timeout_s=T) == "done"


def test_autoscale_counts_batch_queue_depth():
    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3,
        "target_ongoing_requests": 2.0, "downscale_delay_s": 60.0})
    class QueueHeavy:
        @serve.batch(max_batch_size=1, batch_wait_timeout_s=0.001,
                     max_concurrent_batches=1)
        async def __call__(self, items):
            await asyncio.sleep(0.4)
            return items

    h = serve.run(QueueHeavy.bind(), proxy=False)
    resps = [h.remote(i) for i in range(14)]
    wait_until(lambda: serve.status()["QueueHeavy"]["running_replicas"] >= 2, timeout=30,
          msg="queue depth never triggered an upscale")
    for r in resps:
        try:
            r.result(timeout_s=60)
        except Exception:
            pass  # retried requests may land anywhere; scaling is what is tested


def test_controller_telemetry_and_status():
    @serve.deployment
    class Tele:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.01)
        async def __call__(self, items):
            return items

    h = serve.run(Tele.bind(), proxy=False)
    assert [h.remote(i).result(timeout_s=T) for i in range(6)] == list(range(6))
    controller = rt.get_actor("SERVE_CONTROLLER", namespace="serve")
    info = rt.get(controller.get_replicas.remote("Tele"), timeout=T)
    assert set(info) >= {"version", "replicas", "telemetry"}
    wait_until(lambda: rt.get(controller.get_replicas.remote("Tele"), timeout=T)["telemetry"],
          msg="telemetry never populated")
    tele = rt.get(controller.get_replicas.remote("Tele"), timeout=T)["telemetry"]
    assert all(set(t) >= {"qdepth", "ongoing"} for t in tele.values())
    assert {"qps", "qdepth", "draining_replicas"} <= set(serve.status()["Tele"])


def test_serve_gauges_reach_prometheus():
    """The controller's ray_tpu_serve_* gauges are set and reach the
    head's metric table (its error handler would hide a broken
    util.metrics otherwise)."""
    from ray_tpu_torch.util import metrics

    @serve.deployment
    class M:
        def __call__(self, _):
            return 1

    h = serve.run(M.bind(), proxy=False)
    assert [h.remote({}).result(timeout_s=T) for _ in range(5)] == [1] * 5

    def exported():
        report = metrics.get_metrics_report()
        rep = report.get("ray_tpu_serve_replicas", {}).get("series", {})
        return any(dict(k).get("deployment") == "M" and v == 1.0 for k, v in rep.items())

    wait_until(exported, timeout=20, msg="the serve gauges never reached the head")
    text = metrics.prometheus_text()
    assert "ray_tpu_serve_replicas" in text and "ray_tpu_serve_qps" in text


def test_serve_batch_continuous_under_load():
    @serve.deployment
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def __call__(self, items):
            self.batch_sizes.append(len(items))
            await asyncio.sleep(0.05)
            return [i * 2 for i in items]

        def sizes(self, _):
            return list(self.batch_sizes)

    h = serve.run(Batched.bind(), proxy=False)
    assert sorted(r.result(timeout_s=T) for r in [h.remote(i) for i in range(16)]) \
        == [i * 2 for i in range(16)]
    sizes = h.sizes.remote(0).result(timeout_s=T)
    assert sum(sizes) == 16 and max(sizes) > 1, sizes


def test_batcher_no_drain_barrier():
    async def main():
        running = {"now": 0, "max": 0}

        async def fn(items):
            running["now"] += 1
            running["max"] = max(running["max"], running["now"])
            await asyncio.sleep(0.15)
            running["now"] -= 1
            return items

        b = ContinuousBatcher(fn, max_batch_size=2, batch_wait_timeout_s=0.005)
        t0 = time.perf_counter()
        out = await asyncio.gather(*[b.submit(i) for i in range(6)])
        elapsed = time.perf_counter() - t0
        assert sorted(out) == list(range(6))
        assert running["max"] >= 2, "batches never overlapped"
        assert elapsed < 0.40, f"continuous batching serialized: {elapsed:.3f}s"
        b.shutdown()

    asyncio.run(main())


def test_batcher_slo_shrinks_batch_size():
    lm = LatencyModel()
    assert lm.pick_batch_size(8, 0.1) == 8  # cold: explore the largest size
    for _ in range(4):
        lm.observe(8, 0.2)
        lm.observe(4, 0.12)
        lm.observe(2, 0.02)
    assert lm.pick_batch_size(8, 0.1) == 2
    assert lm.pick_batch_size(8, 1.0) == 8


def test_batcher_sheds_expired_deadline():
    async def main():
        started, release = asyncio.Event(), asyncio.Event()

        async def fn(items):
            started.set()
            await release.wait()
            return items

        b = ContinuousBatcher(fn, max_batch_size=1, batch_wait_timeout_s=0.001,
                              max_concurrent_batches=1)
        f1 = b.submit("a")
        await started.wait()
        f2 = b.submit("b", deadline=time.time() - 1.0)
        release.set()
        assert await f1 == "a"
        with pytest.raises(TaskTimeoutError, match="deadline"):
            await f2
        assert b.stats["shed_deadline"] == 1 and b.stats["items"] == 1
        b.shutdown()

    asyncio.run(main())


def test_batcher_bounded_queue_sheds():
    async def main():
        release = asyncio.Event()

        async def fn(items):
            await release.wait()
            return items

        b = ContinuousBatcher(fn, max_batch_size=1, batch_wait_timeout_s=0.001,
                              max_concurrent_batches=1, max_queue_len=2)
        b.submit("a")
        await asyncio.sleep(0.05)
        b.submit("b")
        b.submit("c")
        with pytest.raises(PendingCallsLimitError):
            b.submit("d")
        assert b.stats["shed_queue_full"] == 1
        release.set()
        b.shutdown()

    asyncio.run(main())


def test_batcher_leaves_no_task_behind():
    async def main():
        async def fn(items):
            return items

        b = ContinuousBatcher(fn, max_batch_size=4, batch_wait_timeout_s=0.001)
        assert await asyncio.gather(*[b.submit(i) for i in range(8)]) == list(range(8))
        await asyncio.sleep(0.05)
        assert (b._scheduler is None or b._scheduler.done()) and not b._batches
        assert not [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        b.shutdown()

        release = asyncio.Event()

        async def slow(items):
            await release.wait()
            return items

        b = ContinuousBatcher(slow, max_batch_size=1, batch_wait_timeout_s=0.001,
                              max_concurrent_batches=1)
        f1 = b.submit("a")
        await asyncio.sleep(0.05)
        f2 = b.submit("b")
        b.shutdown()
        await asyncio.sleep(0.05)
        assert (f1.cancelled() or f1.done()) and f2.cancelled()
        with pytest.raises(RuntimeError, match="shut down"):
            b.submit("c")

    asyncio.run(main())


def test_handle_timeout_sheds_with_typed_error():
    @serve.deployment(max_ongoing_requests=1)
    class Slow:
        def __call__(self, payload):
            time.sleep(float(payload.get("sleep", 0)))
            return "done"

    h = serve.run(Slow.bind(), proxy=False)
    assert h.remote({}).result(timeout_s=T) == "done"
    blockers = [h.remote({"sleep": 2.0}) for _ in range(2)]
    time.sleep(0.3)
    with pytest.raises(Exception) as ei:
        h.options(timeout_s=0.4).remote({}).result(timeout_s=15)
    assert isinstance(ei.value, TaskTimeoutError) or "TaskTimeoutError" in str(ei.value)
    assert [b.result(timeout_s=15) for b in blockers] == ["done"] * 2


def test_batched_queue_sheds_expired_deadline_server_side():
    @serve.deployment
    class SlowBatch:
        def __init__(self):
            self.executed = []

        @serve.batch(max_batch_size=1, batch_wait_timeout_s=0.001,
                     max_concurrent_batches=1)
        async def __call__(self, items):
            self.executed.extend(items)
            await asyncio.sleep(1.0)
            return items

        def executed_items(self, _):
            return list(self.executed)

    h = serve.run(SlowBatch.bind(), proxy=False)
    blocker = h.remote("warm")
    time.sleep(0.3)
    with pytest.raises(Exception, match="TaskTimeoutError"):
        h.options(timeout_s=0.5).remote("shed-me").result(timeout_s=15)
    assert blocker.result(timeout_s=15) == "warm"
    assert "shed-me" not in h.executed_items.remote(0).result(timeout_s=T)


def test_proxy_maps_overload_to_503():
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class Gate:
        def __call__(self, payload):
            time.sleep(float(payload.get("sleep", 0)))
            return "ok"

    serve.run(Gate.bind(), route_prefix="/")
    port = serve.get_proxy_port()
    assert http(port, "/", {}) == (200, "ok")
    t = threading.Thread(target=lambda: http(port, "/", {"sleep": 2.5}))
    t.start()
    time.sleep(0.5)
    saw_503 = False
    for _ in range(10):
        try:
            http(port, "/", {"sleep": 2.0})
        except urllib.error.HTTPError as e:
            if e.code == 503:
                body = json.loads(e.read())
                assert body["type"] == "PendingCallsLimitError"
                assert "retry_after_s" in body and e.headers.get("Retry-After")
                saw_503 = True
                break
        time.sleep(0.1)
    t.join(timeout=T)
    assert saw_503, "a saturated deployment never shed with 503"


def test_proxy_maps_deadline_to_408():
    @serve.deployment(max_ongoing_requests=1)
    class SlowGate:
        def __call__(self, payload):
            time.sleep(float(payload.get("sleep", 0)))
            return "ok"

    serve.run(SlowGate.bind(), route_prefix="/")
    port = serve.get_proxy_port()
    assert http(port, "/", {})[0] == 200
    blockers = [threading.Thread(target=lambda: http(port, "/", {"sleep": 2.0}))
                for _ in range(2)]
    for t in blockers:
        t.start()
    time.sleep(0.5)
    code, body = http_error(port, "/", {}, headers={"X-Request-Timeout-S": "0.4"})
    assert code == 408 and body["type"] == "TaskTimeoutError"
    for t in blockers:
        t.join(timeout=T)


def test_proxy_client_disconnect_cancels_queued_request():
    @serve.deployment
    class Counting:
        def __init__(self):
            self.done = 0

        def __call__(self, payload):
            time.sleep(float(payload.get("sleep", 0)))
            self.done += 1
            return self.done

        def count(self, _):
            return self.done

    h = serve.run(Counting.bind(), route_prefix="/")
    port = serve.get_proxy_port()
    assert http(port, "/", {})[0] == 200
    base = h.count.remote(0).result(timeout_s=T)
    occupiers = [threading.Thread(target=lambda: http(port, "/", {"sleep": 2.0}))
                 for _ in range(16)]
    for t in occupiers:
        t.start()
    time.sleep(0.3)
    body = json.dumps({"sleep": 0.0, "tag": "abandoned"}).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    time.sleep(0.3)
    s.close()
    for t in occupiers:
        t.join(timeout=T)
    time.sleep(1.0)
    assert h.count.remote(0).result(timeout_s=T) - base == 16
