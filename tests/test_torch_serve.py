"""The port's Serve (ray_tpu_torch.serve) on one module cluster: the
scenarios of tests/test_serve*.py (deploy and handle, composition,
autoscaling, replica recovery, batching, multiplexing, declarative
configs, HTTP and SSE, WebSocket, gRPC, the serving plane's deadlines,
overload codes, drain and gauges) run against the port.

Every get, handle result and HTTP call has a timeout. The module
imports neither torch nor ray_tpu: its deployments are defined inside
the tests (shipped by value) or in tests/torch_serve_helpers.py.
"""

from __future__ import annotations

import asyncio
import json
import os
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from tests.torch_serve_helpers import T, http, http_error, sse, wait_until


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


@serve.deployment
class Echo:
    def __call__(self, payload):
        return payload

    def shout(self, text):
        return str(text).upper()


# ------------------------------------------------ deployments and handles


@pytest.mark.parametrize("payload", [{"a": 1}, [1, 2, 3], "text"])
def test_deploy_and_handle_call(payload):
    h = serve.run(Echo.bind(), proxy=False)
    assert h.remote(payload).result(timeout_s=T) == payload
    assert h.shout.remote("hi").result(timeout_s=T) == "HI"
    assert serve.status()["Echo"]["running_replicas"] == 1


def test_multiple_replicas_share_load():
    @serve.deployment(num_replicas=3)
    class PidReporter:
        def __call__(self, _):
            return os.getpid()

    h = serve.run(PidReporter.bind(), proxy=False)
    pids = {h.remote({}).result(timeout_s=T) for _ in range(30)}
    assert len(pids) >= 2  # power-of-two routing spreads across replicas
    assert serve.status()["PidReporter"]["running_replicas"] == 3


def test_composition_handle_injection():
    @serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre  # a DeploymentHandle injected by the controller

        def __call__(self, payload):
            return {"y": self.pre.remote(payload["x"]).result(timeout_s=T) + 1}

    h = serve.run(Model.bind(Preprocessor.bind()), proxy=False)
    assert h.remote({"x": 10}).result(timeout_s=T) == {"y": 21}
    assert set(serve.status()) >= {"Preprocessor", "Model"}


def test_response_chaining_passes_ref():
    @serve.deployment
    class Stage1:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Stage2:
        def __call__(self, x):
            return x * 10

    h1 = serve.run(Stage1.bind(), proxy=False)
    h2 = serve.run(Stage2.bind(), proxy=False)
    assert h2.remote(h1.remote(4)).result(timeout_s=T) == 50


def test_options_and_delete():
    serve.run(Echo.options(name="Echo2", num_replicas=2).bind(), proxy=False)
    assert serve.status()["Echo2"]["running_replicas"] == 2
    serve.delete("Echo2")
    assert "Echo2" not in serve.status()


def test_get_replica_context():
    @serve.deployment
    class WhoAmI:
        def __init__(self):
            self.boot = serve.get_replica_context().deployment

        def __call__(self):
            ctx = serve.get_replica_context()
            return {"deployment": ctx.deployment, "replica_id": ctx.replica_id,
                    "boot": self.boot, "servable_is_self": ctx.servable_object is self}

    out = serve.run(WhoAmI.bind(), proxy=False).remote().result(timeout_s=T)
    assert out["deployment"] == out["boot"] == "WhoAmI"
    assert out["replica_id"].startswith("WhoAmI") and out["servable_is_self"] is True


def test_async_deployment_single_replica_concurrency():
    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class AsyncD:
        async def __call__(self, x):
            await asyncio.sleep(0.3)
            return x * 2

        async def stream(self, n):
            for i in range(n):
                await asyncio.sleep(0.02)
                yield i

    h = serve.run(AsyncD.bind(), proxy=False)
    t0 = time.time()
    outs = [r.result(timeout_s=T) for r in [h.remote(i) for i in range(10)]]
    assert outs == [2 * i for i in range(10)]
    assert time.time() - t0 < 2.0  # ten 0.3 s awaits overlap on one replica
    assert list(h.options(method_name="stream", stream=True).remote(5)) == [0, 1, 2, 3, 4]


def test_async_deployment_composition_await():
    @serve.deployment
    class Down:
        async def __call__(self, x):
            return x + 1

    @serve.deployment
    class Up:
        def __init__(self, down):
            self.down = down

        async def __call__(self, x):
            return await self.down.remote(await self.down.remote(x))

    assert serve.run(Up.bind(Down.bind()), proxy=False).remote(40).result(timeout_s=T) == 42


def test_streaming_deployment_handle():
    @serve.deployment(name="streamer")
    class Streamer:
        def __call__(self, payload):
            for i in range(int(payload.get("n", 3))):
                yield {"i": i}

    serve.run(Streamer.bind(), route_prefix="/streamer")
    h = serve.get_deployment_handle("streamer")
    assert list(h.options(stream=True).remote({"n": 4})) == [{"i": i} for i in range(4)]


def test_named_multi_application():
    serve.shutdown()  # leftover unnamed deployments would collide

    @serve.deployment
    class Alpha:
        def __call__(self, x):
            return {"app": "alpha", "x": x}

    @serve.deployment
    class Beta:
        def __call__(self, x):
            return {"app": "beta", "x": x}

    serve.run(Alpha.bind(), name="alpha", route_prefix="/alpha")
    serve.run(Beta.bind(), name="beta", route_prefix="/beta")
    assert serve.get_app_handle("alpha").remote(1).result(timeout_s=T)["app"] == "alpha"
    assert http(serve.get_proxy_port(), "/beta", 7) == (200, {"app": "beta", "x": 7})
    st = serve.status()
    assert st["Alpha"]["app"] == "alpha" and st["Beta"]["app"] == "beta"

    @serve.deployment(name="Alpha")
    class Impostor:
        def __call__(self, x):
            return "stolen"

    with pytest.raises(ValueError, match="belongs to application"):
        serve.run(Impostor.bind(), name="gamma", proxy=False)
    serve.delete("alpha")
    st = serve.status()
    assert "Alpha" not in st and "Beta" in st
    with pytest.raises(ValueError, match="no application"):
        serve.get_app_handle("alpha")
    assert serve.get_app_handle("beta").remote(3).result(timeout_s=T)["x"] == 3
    serve.shutdown()


def test_unnamed_run_cannot_steal_named_app():
    serve.shutdown()

    @serve.deployment(name="Owned")
    class Owned:
        def __call__(self, x):
            return "owned"

    serve.run(Owned.bind(), name="myapp", proxy=False)

    @serve.deployment(name="Owned")
    class Thief:
        def __call__(self, x):
            return "stolen"

    with pytest.raises(ValueError, match="belongs to application"):
        serve.run(Thief.bind(), proxy=False)
    assert serve.get_app_handle("myapp").remote(0).result(timeout_s=T) == "owned"
    serve.shutdown()


# -------------------------------------------- autoscaling and recovery


def test_autoscaling_scales_up_under_load():
    @serve.deployment(autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                          "target_ongoing_requests": 1.0},
                      max_ongoing_requests=8)
    class Slow:
        def __call__(self, _):
            time.sleep(1.0)
            return "done"

    h = serve.run(Slow.bind(), proxy=False)
    assert serve.status()["Slow"]["running_replicas"] == 1
    resps = [h.remote({}) for _ in range(12)]
    deadline, peak = time.monotonic() + 15, 1
    while time.monotonic() < deadline and peak < 2:
        peak = max(peak, serve.status()["Slow"]["running_replicas"])
        time.sleep(0.2)
    for r in resps:
        r.result(timeout_s=T)
    assert peak >= 2, f"the autoscaler never scaled up (peak {peak})"


def test_replica_death_recovers():
    @serve.deployment(num_replicas=1)
    class Fragile:
        def __call__(self, payload):
            if payload.get("die"):
                os._exit(1)
            return "alive"

    h = serve.run(Fragile.bind(), proxy=False)
    assert h.remote({}).result(timeout_s=T) == "alive"
    try:
        h.remote({"die": True}).result(timeout_s=10)
    except Exception:
        pass
    deadline, ok = time.monotonic() + 20, False
    while time.monotonic() < deadline and not ok:
        try:
            ok = h.remote({}).result(timeout_s=5) == "alive"
        except Exception:
            time.sleep(0.3)
    assert ok, "the deployment did not recover after its replica died"


# ------------------------------------------------------------ readiness


@pytest.mark.parametrize("via", ["handle", "http"])
def test_run_returns_once_a_replica_is_constructed(via):
    """serve.run returns only after a replica's constructor has returned
    (here a 3 s one), so the first request is answered on the first try
    by a replica built before serve.run returned."""

    @serve.deployment
    class SlowStart:
        def __init__(self):
            time.sleep(3.0)
            self.built_at = time.time()

        def __call__(self, _):
            return {"built_at": self.built_at}

    t0 = time.time()
    h = serve.run(SlowStart.bind(), name=f"slow_{via}", route_prefix=f"/slow_{via}")
    returned = time.time()
    assert returned - t0 >= 3.0
    assert serve.status()["SlowStart"]["running_replicas"] == 1
    if via == "handle":
        body = h.remote({}).result(timeout_s=T)
    else:
        code, body = http(serve.get_proxy_port(), f"/slow_{via}", {})
        assert code == 200
    assert body["built_at"] <= returned


def test_run_waits_for_every_deployment_of_the_app():
    """A fast ingress over a child whose constructor takes 3 s: serve.run
    returns once the child is built too, and the first request through
    the ingress reaches it."""

    @serve.deployment
    class SlowChild:
        def __init__(self):
            time.sleep(3.0)

        def __call__(self, x):
            return x + 1

    @serve.deployment
    class FastIngress:
        def __init__(self, child):
            self.child = child

        async def __call__(self, x):
            return await self.child.remote(x)

    t0 = time.time()
    h = serve.run(FastIngress.bind(SlowChild.bind()), proxy=False)
    assert time.time() - t0 >= 3.0
    assert h.remote(41).result(timeout_s=T) == 42


def test_run_reports_a_constructor_that_raises():
    @serve.deployment
    class BrokenStart:
        def __init__(self):
            raise ValueError("no weights at this path")

        def __call__(self, _):
            return "unreachable"

    with pytest.raises(Exception, match="no weights at this path"):
        serve.run(BrokenStart.bind(), proxy=False)
    assert serve.status()["BrokenStart"]["running_replicas"] == 0


# ------------------------------------------------------------ batching


def test_batch_coalesces_under_concurrent_load():
    @serve.deployment(num_replicas=1, max_ongoing_requests=64)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def __call__(self, items: list) -> list:
            self.batch_sizes.append(len(items))
            return [x * 10 for x in items]

        async def stats(self):
            return list(self.batch_sizes)

    h = serve.run(Batched.bind(), proxy=False)
    outs = [r.result(timeout_s=T) for r in [h.remote(i) for i in range(32)]]
    assert outs == [i * 10 for i in range(32)]
    sizes = h.stats.remote().result(timeout_s=T)
    assert sum(sizes) == 32 and 1 < max(sizes) <= 8 and len(sizes) < 32


def test_batch_wait_timeout_flushes_partial():
    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class B:
        @serve.batch(max_batch_size=100, batch_wait_timeout_s=0.05)
        async def __call__(self, items: list) -> list:
            return [len(items)] * len(items)

    h = serve.run(B.bind(), proxy=False)
    t0 = time.time()
    assert h.remote("x").result(timeout_s=T) == 1  # flushed alone by the timer
    assert time.time() - t0 < 5.0


@pytest.mark.parametrize("fault, match", [("raise", "batch exploded"),
                                          ("short", "returned 1 results")])
def test_batch_error_reaches_every_caller(fault, match):
    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class B:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.02)
        async def __call__(self, items: list) -> list:
            if fault == "raise":
                raise RuntimeError("batch exploded")
            return [1]  # the wrong length

    h = serve.run(B.bind(), proxy=False)
    for r in [h.remote(i) for i in range(3)]:
        with pytest.raises(Exception, match=match):
            r.result(timeout_s=T)


# -------------------------------------------------------- multiplexing


def test_multiplexed_lru_and_context():
    @serve.deployment(num_replicas=1, max_ongoing_requests=16)
    class Lora:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=1)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id}

        async def __call__(self, payload):
            mid = serve.get_multiplexed_model_id()
            return {"served_by": (await self.get_model(mid))["id"], "ctx": mid}

        async def loads_so_far(self):
            return list(self.loads)

    h = serve.run(Lora.bind(), proxy=False)
    ha, hb = (h.options(multiplexed_model_id=m) for m in ("lora-a", "lora-b"))
    assert ha.remote({}).result(timeout_s=T) == {"served_by": "lora-a", "ctx": "lora-a"}
    assert ha.remote({}).result(timeout_s=T)["served_by"] == "lora-a"
    assert hb.remote({}).result(timeout_s=T)["served_by"] == "lora-b"
    assert ha.remote({}).result(timeout_s=T)["served_by"] == "lora-a"
    assert h.loads_so_far.remote().result(timeout_s=T) == ["lora-a", "lora-b", "lora-a"]


def test_multiplexed_routing_affinity():
    @serve.deployment(num_replicas=3, max_ongoing_requests=16)
    class M:
        @serve.multiplexed(max_num_models_per_replica=4)
        async def get_model(self, model_id: str):
            return model_id

        async def __call__(self, payload):
            await self.get_model(serve.get_multiplexed_model_id())
            return os.getpid()

    h = serve.run(M.bind(), proxy=False)
    wait_until(lambda: serve.status()["M"]["running_replicas"] == 3, msg="3 replicas")
    for mid in ("m1", "m2", "m3"):
        pids = {h.options(multiplexed_model_id=mid).remote({}).result(timeout_s=T)
                for _ in range(6)}
        assert len(pids) == 1, (mid, pids)


def test_multiplexed_requires_model_id():
    @serve.deployment(num_replicas=1)
    class M:
        @serve.multiplexed()
        async def get_model(self, model_id: str):
            return model_id

        async def __call__(self, payload):
            return await self.get_model(serve.get_multiplexed_model_id())

    with pytest.raises(Exception, match="no model id"):
        serve.run(M.bind(), proxy=False).remote({}).result(timeout_s=T)


def test_multiplexed_cache_keyed_by_live_instance():
    import gc

    from ray_tpu_torch.serve.multiplex import multiplexed

    class Host:
        @multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return {"id": model_id, "owner": id(self)}

    async def main():
        a, b = Host(), Host()
        assert (await a.get_model("m"))["owner"] == id(a)
        assert (await b.get_model("m"))["owner"] == id(b)
        assert len(Host.get_model._model_caches) == 2
        del a
        gc.collect()
        assert len(Host.get_model._model_caches) == 1
        del b
        gc.collect()
        assert len(Host.get_model._model_caches) == 0

    asyncio.run(main())


def test_multiplexed_unbound_and_slotted_loaders_fall_back():
    from ray_tpu_torch.serve.multiplex import multiplexed

    loads = []

    @multiplexed(max_num_models_per_replica=2)
    async def load(model_id: str):
        loads.append(model_id)
        return model_id.upper()

    class Slotted:
        __slots__ = ()

        @multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            return model_id * 2

    async def main():
        assert await load("x") == "X" and await load("x") == "X"
        assert loads == ["x"]
        assert await Slotted().get_model("y") == "yy"
        assert len(Slotted.get_model._model_caches) == 0
        assert len(Slotted.get_model._model_caches_fallback) == 1

    asyncio.run(main())


# ------------------------------------------------ declarative configs


def test_serve_build_and_run_from_config():
    from tests.torch_serve_helpers import Chain, Doubler

    config = serve.build(Chain.bind(Doubler.bind()), route_prefix="/chain")
    text = json.dumps(config)
    deployments = config["applications"][0]["deployments"]
    assert {d["name"] for d in deployments} == {"Chain", "Doubler"}
    chain = next(d for d in deployments if d["name"] == "Chain")
    assert chain["import_path"].endswith("torch_serve_helpers.Chain")
    assert chain["init_args"] == [{"__handle__": "Doubler"}]
    assert chain["route_prefix"] == "/chain"
    serve.run_from_config(json.loads(text), proxy=False)
    assert serve.get_deployment_handle("Chain").remote(5).result(timeout_s=T) == 11


def test_run_from_config_replaces_app():
    from tests.torch_serve_helpers import Chain, Doubler

    serve.run_from_config(serve.build(Chain.bind(Doubler.bind()), name="cfgapp"),
                          proxy=False)
    assert serve.get_deployment_handle("Doubler").remote(4).result(timeout_s=T) == 8
    serve.run_from_config(serve.build(Doubler.bind(), name="cfgapp"), proxy=False)
    assert "Chain" not in serve.status(), "a stale deployment must be removed"
    with pytest.raises(Exception, match="belongs to"):
        serve.run_from_config(serve.build(Doubler.bind(), name="otherapp"), proxy=False)
    serve.delete("cfgapp")


def test_serve_build_rejects_main_classes():
    @serve.deployment
    class Local:
        def __call__(self):
            return 0

    Local.cls.__module__ = "__main__"
    with pytest.raises(ValueError, match="importable"):
        serve.build(Local.bind())


# ------------------------------------------------------ HTTP ingress


def test_http_proxy_routes():
    @serve.deployment
    class Adder:
        def __call__(self, payload):
            return {"sum": int(payload["a"]) + int(payload["b"])}

    serve.run(Adder.bind(), route_prefix="/add")
    port = serve.get_proxy_port()
    assert http(port, "/add", {"a": 2, "b": 3}) == (200, {"sum": 5})
    assert http(port, "/add?a=7&b=1") == (200, {"sum": 8})  # GET query
    code, body = http_error(port, "/nope/xyz", None, method="GET")
    assert code == 404 and "no route" in body["error"]


def test_user_error_surfaces_as_500():
    @serve.deployment
    class Boom:
        def __call__(self, _):
            raise ValueError("kaboom")

    serve.run(Boom.bind(), route_prefix="/boom")
    code, body = http_error(serve.get_proxy_port(), "/boom", {})
    assert code == 500 and "kaboom" in body["error"]


def test_deleted_route_returns_404():
    @serve.deployment
    class Gone:
        def __call__(self, _):
            return "here"

    serve.run(Gone.bind(), route_prefix="/gone")
    port = serve.get_proxy_port()
    assert http(port, "/gone", {}) == (200, "here")
    serve.delete("Gone")
    assert http_error(port, "/gone", {})[0] == 404


def test_streaming_http_sse():
    @serve.deployment(name="ssegen")
    class SSEGen:
        def __call__(self, payload):
            for i in range(3):
                yield {"chunk": i}

    serve.run(SSEGen.bind(), route_prefix="/ssegen")
    ctype, body = sse(serve.get_proxy_port(), "/ssegen", {})
    assert ctype.startswith("text/event-stream")
    assert body.count("data:") == 3 and '"chunk": 2' in body


def test_sse_100_concurrent_streams_one_proxy():
    """100 SSE streams overlap in the one proxy process: an in-flight
    stream holds no thread."""
    import concurrent.futures

    @serve.deployment(num_replicas=1, max_ongoing_requests=256)
    class Pacer:
        async def __call__(self, payload):
            for i in range(3):
                await asyncio.sleep(0.4)
                yield {"i": i}

    serve.run(Pacer.bind(), route_prefix="/pacer")
    port = serve.get_proxy_port()
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max_workers=100) as ex:
        counts = list(ex.map(lambda _: sse(port, "/pacer", {}, timeout=120)[1]
                             .count("data:"), range(100)))
    assert counts == [3] * 100
    assert time.time() - t0 < 30


# ----------------------------------------------------------- WebSocket


@serve.deployment
class EchoWS:
    def __call__(self, payload):
        return {"via": "http", "got": payload}

    async def ws_message(self, message):
        if isinstance(message, dict):
            return {"via": "ws", "sum": message.get("a", 0) + message.get("b", 0)}
        return {"via": "ws", "echo": message}


def _ws(port, path, frames, replies_each=1):
    """Send each frame (a payload, or raw bytes for a binary frame) and
    collect the replies."""
    aiohttp = pytest.importorskip("aiohttp")

    async def go():
        out = []
        async with aiohttp.ClientSession() as sess:
            async with sess.ws_connect(f"http://127.0.0.1:{port}{path}") as ws:
                for f in frames:
                    if isinstance(f, bytes):
                        await ws.send_bytes(f)
                    else:
                        await ws.send_str(json.dumps(f))
                    for _ in range(replies_each):
                        msg = await asyncio.wait_for(ws.receive(), timeout=T)
                        out.append(json.loads(msg.data))
        return out

    return asyncio.run(asyncio.wait_for(go(), 2 * T))


def test_ws_request_response_and_http_coexist():
    serve.run(EchoWS.bind(), route_prefix="/echo")
    port = serve.get_proxy_port()
    assert _ws(port, "/echo", [{"a": 2, "b": 3}, {"a": 10, "b": 1}]) == [
        {"via": "ws", "sum": 5}, {"via": "ws", "sum": 11}]
    assert http(port, "/echo", {"x": 1})[1]["via"] == "http"


def test_ws_streaming_handler_one_frame_per_item():
    @serve.deployment
    class TokenStreamWS:
        async def ws_message(self, message):
            for tok in str(message.get("text", "")).split():
                yield {"token": tok}
            yield {"done": True}

    serve.run(TokenStreamWS.bind(), route_prefix="/stream")
    assert _ws(serve.get_proxy_port(), "/stream", [{"text": "to the moon"}],
               replies_each=4) == [{"token": "to"}, {"token": "the"},
                                   {"token": "moon"}, {"done": True}]


def test_ws_binary_frame_gets_error_reply():
    serve.run(EchoWS.bind(), route_prefix="/binecho")
    err, ok = _ws(serve.get_proxy_port(), "/binecho", [b"\x00\x01", {"a": 1, "b": 1}])
    assert "binary" in err["error"] and ok == {"via": "ws", "sum": 2}


def test_ws_upgrade_without_handler_is_rejected():
    aiohttp = pytest.importorskip("aiohttp")

    @serve.deployment
    class PlainHTTP:
        def __call__(self, payload):
            return {"plain": True}

    serve.run(PlainHTTP.bind(), route_prefix="/plain")
    port = serve.get_proxy_port()

    async def go():
        async with aiohttp.ClientSession() as sess:
            try:
                async with sess.ws_connect(f"http://127.0.0.1:{port}/plain"):
                    return "connected"
            except aiohttp.WSServerHandshakeError:
                return "rejected"

    assert asyncio.run(asyncio.wait_for(go(), T)) == "rejected"


# ---------------------------------------------------------------- gRPC


def test_grpc_ingress_roundtrip():
    pytest.importorskip("grpc")
    import grpc as grpc_mod

    from ray_tpu_torch.serve.grpc_proxy import grpc_request

    @serve.deployment(name="gecho")
    class GrpcEcho:
        def __call__(self, payload):
            return {"echoed": payload}

    serve.run(GrpcEcho.bind(), route_prefix="/gecho")
    port = serve.get_grpc_port()
    assert port > 0
    addr = f"127.0.0.1:{port}"
    assert grpc_request(addr, {"x": 1}, deployment="gecho", timeout_s=T) == {"echoed": {"x": 1}}
    assert grpc_request(addr, {"deployment": "gecho", "payload": [1, 2]},
                        timeout_s=T) == {"echoed": [1, 2]}
    assert grpc_request(addr, {"x": (1, 2)}, deployment="gecho", encoding="pickle",
                        timeout_s=T) == {"echoed": {"x": (1, 2)}}
    with pytest.raises(grpc_mod.RpcError):
        grpc_request(addr, {}, deployment="nope", timeout_s=T)


def test_grpc_ingress_status_codes_and_sizes():
    pytest.importorskip("grpc")
    import concurrent.futures as cf

    import grpc as grpc_mod

    from ray_tpu_torch.serve.grpc_proxy import METHOD, SERVICE, grpc_request

    @serve.deployment(name="gconf")
    class Conf:
        def __call__(self, payload):
            if isinstance(payload, dict) and payload.get("big"):
                return {"blob": "x" * payload["big"]}
            if isinstance(payload, dict) and payload.get("boom"):
                raise ValueError("user error")
            return {"ok": payload}

    serve.run(Conf.bind(), route_prefix="/gconf")
    addr = f"127.0.0.1:{serve.get_grpc_port()}"
    channel = grpc_mod.insecure_channel(addr)
    try:
        call = channel.unary_unary(f"/{SERVICE}/{METHOD}")
        for body, dep, code in ((b"{}", "ghost", grpc_mod.StatusCode.NOT_FOUND),
                                (b"{not json", "gconf",
                                 grpc_mod.StatusCode.INVALID_ARGUMENT),
                                (b'{"boom": 1}', "gconf", grpc_mod.StatusCode.INTERNAL)):
            with pytest.raises(grpc_mod.RpcError) as ei:
                call(body, metadata=[("deployment", dep)], timeout=T)
            assert ei.value.code() == code
    finally:
        channel.close()
    assert len(grpc_request(addr, {"big": 2_000_000}, deployment="gconf",
                            timeout_s=T)["blob"]) == 2_000_000
    assert grpc_request(addr, {"pad": "y" * 2_000_000}, deployment="gconf",
                        timeout_s=T)["ok"]["pad"] == "y" * 2_000_000
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        outs = [f.result(timeout=60) for f in [
            pool.submit(grpc_request, addr, {"i": i}, deployment="gconf", timeout_s=T)
            for i in range(16)]]
    assert sorted(o["ok"]["i"] for o in outs) == list(range(16))
