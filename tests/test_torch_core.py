"""The port's task/actor core on one single-node cluster: the scenarios
of tests/test_core.py run against ray_tpu_torch, plus what the port
adds — its processes load neither jax nor ray_tpu (and a plain-task
worker no torch), a tensor result is immutable across gets, and GPU
leases pin CUDA_VISIBLE_DEVICES (the cluster counts two GPUs from
resources alone; nothing here calls CUDA).

The module imports neither torch nor ray_tpu at its top: workers that
import it by reference must stay free of both.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    TaskError,
    WorkerCrashedError,
)

T = 30  # seconds: every get and wait below is bounded


@pytest.fixture(scope="module")
def cluster():
    before = set(_descendants(os.getpid()))  # what earlier tests left
    ray_tpu_torch.init(num_cpus=4, num_gpus=2,
                       object_store_memory=64 * 1024 * 1024)
    yield before
    ray_tpu_torch.shutdown()
    from ray_tpu_torch._private import lockwitness

    if lockwitness.installed() and lockwitness.cycles():
        raise AssertionError(lockwitness.report())


# ------------------------------------------------- what the processes load

def test_processes_load_no_jax_no_ray_tpu_and_plain_workers_no_torch(cluster):
    """Runs first in the file: the pool's workers have run nothing but
    these plain tasks, so none has a reason to load torch."""

    @ray_tpu_torch.remote
    def probe():
        import sys

        return (os.getpid(), sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "ray_tpu")),
                "torch" in sys.modules)

    @ray_tpu_torch.remote
    class Probe:
        def probe(self):
            import sys

            return (os.getpid(), sorted(m for m in sys.modules if m.split(".")[0]
                                        in ("jax", "ray_tpu")),
                    "torch" in sys.modules)

    outs = ray_tpu_torch.get([probe.remote() for _ in range(8)], timeout=T)
    outs.append(ray_tpu_torch.get(Probe.remote().probe.remote(), timeout=T))
    for pid, foreign, torch_loaded in outs:
        assert pid != os.getpid()
        assert foreign == [] and not torch_loaded
    # Every process the cluster started runs the port's modules: the
    # head shards, the zygote and the workers it forked, and any worker
    # started as a fresh interpreter.
    children = {p: a for p, a in _descendants(os.getpid()).items()
                if p not in cluster}
    assert children
    for pid, argv in children.items():
        if argv and "python" in os.path.basename(argv[0]):
            assert any(a.startswith("ray_tpu_torch._private.") for a in argv), argv
            assert not any(a.startswith("ray_tpu._private") for a in argv), argv
            maps = open(f"/proc/{pid}/maps").read()
            assert "jaxlib" not in maps and "ray_tpu/_native" not in maps


def _descendants(root: int) -> dict:
    parent = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                stat = open(f"/proc/{d}/stat").read()
                parent[int(d)] = int(stat.rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                pass
    out, frontier = {}, {root}
    while frontier:
        frontier = {p for p, pp in parent.items() if pp in frontier} - set(out)
        for p in frontier:
            try:
                out[p] = open(f"/proc/{p}/cmdline").read().split("\0")
            except OSError:
                out[p] = []
    return out


# ---------------------------------------------------------------- objects


@pytest.mark.parametrize("value", [1, "hello", {"a": [1, 2]}, (None, True),
                                   b"\x00\xff" * 100],
                         ids=["int", "str", "dict", "tuple", "bytes"])
def test_put_get_roundtrip(cluster, value):
    assert ray_tpu_torch.get(ray_tpu_torch.put(value), timeout=T) == value


def test_put_get_numpy_large(cluster):
    arr = np.random.rand(512, 1024)  # 4 MiB -> shm path
    out = ray_tpu_torch.get(ray_tpu_torch.put(arr), timeout=T)
    np.testing.assert_array_equal(arr, out)
    assert not out.flags.writeable  # the reference's read-only zero copy


def test_get_many(cluster):
    refs = [ray_tpu_torch.put(i) for i in range(50)]
    assert ray_tpu_torch.get(refs, timeout=T) == list(range(50))


def test_get_timeout(cluster):
    @ray_tpu_torch.remote
    def late():
        time.sleep(1)
        return "late"

    ref = late.remote()
    with pytest.raises(GetTimeoutError):
        ray_tpu_torch.get(ref, timeout=0.2)
    assert ray_tpu_torch.get(ref, timeout=T) == "late"


# ---------------------------------------------------------------- tasks


def test_simple_task(cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    assert ray_tpu_torch.get(f.remote(21), timeout=T) == 42


def test_task_dependencies(cluster):
    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    ref = f.remote(0)
    for _ in range(5):
        ref = f.remote(ref)
    assert ray_tpu_torch.get(ref, timeout=T) == 6


def test_task_numpy_arg(cluster):
    @ray_tpu_torch.remote
    def total(a):
        return float(a.sum())

    big = np.ones((256, 1024))
    assert ray_tpu_torch.get(total.remote(ray_tpu_torch.put(big)),
                             timeout=T) == big.size


def test_multi_return(cluster):
    @ray_tpu_torch.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray_tpu_torch.get([a, b, c], timeout=T) == [1, 2, 3]


def test_streaming_generator(cluster):
    @ray_tpu_torch.remote
    def gen(n):
        for i in range(n):
            yield i * i

    assert [ray_tpu_torch.get(r, timeout=T) for r in gen.remote(5)] == [
        0, 1, 4, 9, 16]


@pytest.mark.parametrize("through_dependency", [False, True],
                         ids=["direct", "through_dependency"])
def test_task_error_propagates(cluster, through_dependency):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("root cause")

    @ray_tpu_torch.remote
    def consume(x):
        return x

    ref = consume.remote(boom.remote()) if through_dependency else boom.remote()
    with pytest.raises(TaskError, match="root cause"):
        ray_tpu_torch.get(ref, timeout=T)


def test_parallel_execution(cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(0.5)
        return 1

    t0 = time.time()
    assert sum(ray_tpu_torch.get([slow.remote() for _ in range(4)],
                                 timeout=T)) == 4
    assert time.time() - t0 < 1.9  # 4 serial would be >= 2.0


def test_task_options(cluster):
    @ray_tpu_torch.remote
    def whoami():
        return os.getpid()

    assert isinstance(ray_tpu_torch.get(whoami.options(num_cpus=2).remote(),
                                        timeout=T), int)


def test_runtime_env_env_vars(cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"MY_TEST_VAR": "abc"}})
    def read_env():
        return os.environ.get("MY_TEST_VAR")

    assert ray_tpu_torch.get(read_env.remote(), timeout=T) == "abc"


def test_nested_tasks(cluster):
    @ray_tpu_torch.remote
    def inner(x):
        return x + 1

    @ray_tpu_torch.remote
    def outer(x):
        return ray_tpu_torch.get(inner.remote(x), timeout=T) + 10

    assert ray_tpu_torch.get(outer.remote(0), timeout=T) == 11


# ---------------------------------------------------------------- wait


def test_wait_basic(cluster):
    @ray_tpu_torch.remote
    def quick(i):
        return i

    refs = [quick.remote(i) for i in range(4)]
    ready, not_ready = ray_tpu_torch.wait(refs, num_returns=4, timeout=10)
    assert len(ready) == 4 and not not_ready


def test_wait_partial(cluster):
    @ray_tpu_torch.remote
    def slow():
        time.sleep(1)
        return 0

    @ray_tpu_torch.remote
    def quick():
        return 1

    r_slow, r_quick = slow.remote(), quick.remote()
    ready, not_ready = ray_tpu_torch.wait([r_slow, r_quick], num_returns=1,
                                          timeout=10)
    assert ready == [r_quick] and not_ready == [r_slow]
    assert ray_tpu_torch.get(r_slow, timeout=T) == 0


# ---------------------------------------------------------------- actors


def test_actor_basic(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def inc(self, k=1):
            self.v += k
            return self.v

    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.inc.remote(), timeout=T) == 101
    assert ray_tpu_torch.get(c.inc.remote(9), timeout=T) == 110


def test_actor_ordering(cluster):
    @ray_tpu_torch.remote
    class Log:
        def __init__(self):
            self.items = []

        def append(self, x):
            self.items.append(x)

        def get(self):
            return self.items

    log = Log.remote()
    for i in range(20):
        log.append.remote(i)
    assert ray_tpu_torch.get(log.get.remote(), timeout=T) == list(range(20))


def test_named_actor(cluster):
    @ray_tpu_torch.remote
    class Svc:
        def ping(self):
            return "pong"

    Svc.options(name="svc-test").remote()
    handle = ray_tpu_torch.get_actor("svc-test")
    assert ray_tpu_torch.get(handle.ping.remote(), timeout=T) == "pong"


def test_actor_handle_passing(cluster):
    @ray_tpu_torch.remote
    class Store:
        def __init__(self):
            self.v = {}

        def set(self, k, v):
            self.v[k] = v

        def get(self, k):
            return self.v.get(k)

    @ray_tpu_torch.remote
    def writer(store):
        ray_tpu_torch.get(store.set.remote("from", "task"), timeout=T)
        return True

    s = Store.remote()
    assert ray_tpu_torch.get(writer.remote(s), timeout=T)
    assert ray_tpu_torch.get(s.get.remote("from"), timeout=T) == "task"


def test_actor_error(cluster):
    @ray_tpu_torch.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor method failed")

    b = Bad.remote()
    with pytest.raises(TaskError, match="actor method failed"):
        ray_tpu_torch.get(b.fail.remote(), timeout=T)


def test_actor_death_and_restart(cluster):
    @ray_tpu_torch.remote(max_restarts=1)
    class Fragile:
        def crash(self):
            os._exit(1)

        def ping(self):
            return "ok"

    f = Fragile.remote()
    assert ray_tpu_torch.get(f.ping.remote(), timeout=T) == "ok"
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(f.crash.remote(), timeout=20)
    assert ray_tpu_torch.get(f.ping.remote(), timeout=T) == "ok"


def test_kill_actor(cluster):
    @ray_tpu_torch.remote
    class Victim:
        def ping(self):
            return 1

    v = Victim.remote()
    assert ray_tpu_torch.get(v.ping.remote(), timeout=T) == 1
    ray_tpu_torch.kill(v)
    time.sleep(0.5)
    with pytest.raises(ActorDiedError):
        ray_tpu_torch.get(v.ping.remote(), timeout=20)


def test_actor_max_concurrency(cluster):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Conc:
        def ready(self):
            return True

        def slow(self):
            time.sleep(0.6)
            return 1

    c = Conc.remote()
    ray_tpu_torch.get(c.ready.remote(), timeout=20)  # wait for startup
    t0 = time.time()
    assert sum(ray_tpu_torch.get([c.slow.remote() for _ in range(4)],
                                 timeout=20)) == 4
    assert time.time() - t0 < 2.0  # serial would be 2.4s


# ---------------------------------------------------------------- fault tolerance


def test_task_retry_on_worker_crash(cluster, tmp_path):
    marker = str(tmp_path / "marker")

    @ray_tpu_torch.remote(max_retries=2)
    def flaky():
        if not os.path.exists(marker):
            open(marker, "w").write("x")
            os._exit(1)
        return "recovered"

    assert ray_tpu_torch.get(flaky.remote(), timeout=40) == "recovered"


def test_no_retry_fails(cluster):
    @ray_tpu_torch.remote(max_retries=0)
    def die():
        os._exit(1)

    with pytest.raises(WorkerCrashedError):
        ray_tpu_torch.get(die.remote(), timeout=40)


# ---------------------------------------------------------------- cluster info


def test_cluster_resources(cluster):
    total = ray_tpu_torch.cluster_resources()
    assert total["CPU"] == 4.0 and total["GPU"] == 2.0
    assert "memory" in total and "TPU" not in total


def test_nodes(cluster):
    nodes = ray_tpu_torch.nodes()
    assert len(nodes) == 1 and nodes[0]["alive"]  # one head shard: GPUs


def test_runtime_context_in_task(cluster):
    @ray_tpu_torch.remote
    def ctx():
        c = ray_tpu_torch.get_runtime_context()
        return c.get_task_id(), c.get_node_id()

    task_id, node_id = ray_tpu_torch.get(ctx.remote(), timeout=T)
    assert task_id.startswith("task-") and node_id.startswith("node-")


def test_runtime_context_surface(cluster):
    ctx = ray_tpu_torch.get_runtime_context()
    assert ctx.get_worker_id() == "driver"
    assert ctx.get_job_id() == "driver"
    assert ":" in ctx.gcs_address

    @ray_tpu_torch.remote
    def probe():
        c = ray_tpu_torch.get_runtime_context()
        return {"worker": c.get_worker_id(), "task": c.get_task_id(),
                "env": c.get_runtime_env()}

    out = ray_tpu_torch.get(probe.options(
        runtime_env={"env_vars": {"X": "1"}}).remote(), timeout=T)
    assert out["worker"].startswith("worker-")
    assert out["task"].startswith("task-")
    assert out["env"].get("env_vars") == {"X": "1"}


# ----------------------------------------------------- out-of-order actors


@pytest.mark.parametrize("out_of_order", [True, False],
                         ids=["opt_in", "default_ordered"])
def test_out_of_order_actor_execution(cluster, out_of_order):
    """Opt-in out-of-order execution: a call parked on an unresolved
    arg does not block later dep-ready calls; the default stays strict
    submission order."""

    @ray_tpu_torch.remote
    def slow_dep():
        time.sleep(2.0)
        return "late"

    @ray_tpu_torch.remote(allow_out_of_order_execution=out_of_order)
    class A:
        def eat(self, x):
            return x

        def quick(self):
            return "quick"

    a = A.remote()
    ray_tpu_torch.get(a.quick.remote(), timeout=T)  # created
    blocked = a.eat.remote(slow_dep.remote())  # parked on the slow dep
    t0 = time.time()
    assert ray_tpu_torch.get(a.quick.remote(), timeout=T) == "quick"
    if out_of_order:
        assert time.time() - t0 < 1.5  # overtook the parked call
    else:
        assert time.time() - t0 > 1.0  # waited behind the parked call
    assert ray_tpu_torch.get(blocked, timeout=T) == "late"


def test_duplicate_pending_dep_runs_once(cluster):
    """f.remote(x, x) with x still pending executes once when x seals."""

    @ray_tpu_torch.remote
    def slow():
        time.sleep(0.5)
        return 3

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    x = slow.remote()
    assert ray_tpu_torch.get(add.remote(x, x), timeout=T) == 6
    y = slow.remote()
    rs = [add.remote(y, y) for _ in range(4)]
    assert ray_tpu_torch.get(rs, timeout=T) == [6, 6, 6, 6]


def test_list_named_actors(cluster):
    from ray_tpu_torch.util import list_named_actors

    @ray_tpu_torch.remote
    class N:
        def ping(self):
            return 1

    h = N.options(name="alpha").remote()
    ray_tpu_torch.get(h.ping.remote(), timeout=T)
    assert "alpha" in list_named_actors()
    both = list_named_actors(all_namespaces=True)
    assert any(e["name"] == "alpha" for e in both)
    ray_tpu_torch.kill(h)


def test_max_calls_recycles_worker(cluster):
    @ray_tpu_torch.remote(max_calls=2)
    def pid():
        return os.getpid()

    pids = [ray_tpu_torch.get(pid.remote(), timeout=T) for _ in range(6)]
    assert len(set(pids)) >= 3, pids
    from collections import Counter

    assert max(Counter(pids).values()) <= 2, pids


def test_placement_group(cluster):
    from ray_tpu_torch.util import placement_group, remove_placement_group

    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=T)

    @ray_tpu_torch.remote
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(pg, 1)
    assert ray_tpu_torch.get(where.options(
        scheduling_strategy=strat).remote(), timeout=T).startswith("node-")
    remove_placement_group(pg)


def test_accelerator_manager_vendors(monkeypatch):
    from ray_tpu_torch.accelerators import (
        AMDGPUAcceleratorManager,
        CUDAAcceleratorManager,
        HPUAcceleratorManager,
        IntelGPUAcceleratorManager,
        NPUAcceleratorManager,
        get_accelerator_manager,
    )

    assert get_accelerator_manager("GPU") is CUDAAcceleratorManager
    assert get_accelerator_manager("TPU") is None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert CUDAAcceleratorManager.get_current_node_num_accelerators() == 2
    assert CUDAAcceleratorManager.node_device_ids(2) == [2, 5]
    assert CUDAAcceleratorManager.node_device_ids(3) == [0, 1, 2]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert CUDAAcceleratorManager.get_current_node_num_accelerators() == 0

    monkeypatch.setenv("HIP_VISIBLE_DEVICES", "0,1")
    assert AMDGPUAcceleratorManager.get_current_node_num_accelerators() == 2
    AMDGPUAcceleratorManager.set_current_process_visible_accelerator_ids(["3"])
    assert os.environ["HIP_VISIBLE_DEVICES"] == "3"
    monkeypatch.setenv("HABANA_VISIBLE_MODULES", "0,1,2")
    assert HPUAcceleratorManager.get_current_node_num_accelerators() == 3
    monkeypatch.setenv("ASCEND_RT_VISIBLE_DEVICES", "")
    assert NPUAcceleratorManager.get_current_node_num_accelerators() == 0
    monkeypatch.setenv("ONEAPI_DEVICE_SELECTOR", "level_zero:0,1")
    assert IntelGPUAcceleratorManager.get_current_node_num_accelerators() == 2


# ------------------------------------------------------- tensors, leases


def test_tensor_result_is_immutable_across_gets(cluster):
    import torch

    @ray_tpu_torch.remote
    def make(n):
        import torch

        return {"w": torch.arange(n, dtype=torch.float32),
                "b": torch.ones(2, 3, dtype=torch.bfloat16)}

    for n in (8, 64 * 1024):  # an inline result and a shared-memory one
        ref = make.remote(n)
        first = ray_tpu_torch.get(ref, timeout=T)
        first["w"].add_(100)
        first["b"].zero_()
        second = ray_tpu_torch.get(ref, timeout=T)
        assert torch.equal(second["w"], torch.arange(n, dtype=torch.float32))
        assert second["b"].dtype == torch.bfloat16
        assert torch.equal(second["b"], torch.ones(2, 3, dtype=torch.bfloat16))
    t = torch.randn(256, 256)
    orig = t.clone()
    ref = ray_tpu_torch.put(t)
    t.add_(1)  # the producer's later write does not reach the object
    assert torch.equal(ray_tpu_torch.get(ref, timeout=T), orig)


def test_gpu_leases_pin_cuda_visible_devices(cluster, tmp_path):
    @ray_tpu_torch.remote(num_gpus=1)
    def leased(barrier):
        # Both leases held at once: each task waits until the other has
        # started (a sleep let a slow second worker start after the first
        # task ended, and take its device).
        open(os.path.join(barrier, str(os.getpid())), "w").close()
        deadline = time.monotonic() + T / 2
        while len(os.listdir(barrier)) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote
    def chipless():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote(num_tpus=1)  # the alias of num_gpus
    def alias():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def __init__(self):
            self.at_init = os.environ.get("CUDA_VISIBLE_DEVICES")

        def visible(self):
            return self.at_init, os.environ.get("CUDA_VISIBLE_DEVICES")

    seen = ray_tpu_torch.get([leased.remote(str(tmp_path)), leased.remote(str(tmp_path))],
                             timeout=T)
    assert sorted(seen) == ["0", "1"]
    assert ray_tpu_torch.get(chipless.remote(), timeout=T) == ""
    assert ray_tpu_torch.get(alias.remote(), timeout=T) in ("0", "1")
    h = Holder.remote()
    at_init, now = ray_tpu_torch.get(h.visible.remote(), timeout=T)
    assert at_init == now and now in ("0", "1")  # the constructor too
    ray_tpu_torch.kill(h)
