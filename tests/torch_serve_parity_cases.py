"""One Serve script run under ray_tpu and under ray_tpu_torch, each in its
own process, by tests/test_torch_serve_parity.py:

    python tests/torch_serve_parity_cases.py ray_tpu|ray_tpu_torch

It prints one JSON object of outcomes (status dicts, HTTP status codes
and bodies, SSE streams, batch sizes, multiplexed routing, config
round trips, error types). It imports only the package it is given, so
the ray_tpu_torch run loads neither jax nor ray_tpu.
"""

import importlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

T = 30  # every get, result and HTTP call is bounded


def _http(port, path, payload=None, headers=None):
    """(code, body) of one HTTP call; an error code's JSON body too."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method="POST" if data is not None else "GET",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=T) as r:
            code, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        code, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    try:
        body = json.loads(raw)
    except json.JSONDecodeError:
        body = raw.decode()
    return {"code": code, "body": body, "type": (ctype or "").split(";")[0]}


def _stable(status: dict) -> dict:
    """A status dict without its rates (qps moves with the clock)."""
    return {name: {k: v for k, v in st.items() if k != "qps"}
            for name, st in sorted(status.items())}


def main(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    serve = importlib.import_module(pkg + ".serve")
    multiplex = importlib.import_module(pkg + ".serve.multiplex")
    rt.init(num_cpus=8, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1})
    out = {}

    def outcome(fn):
        try:
            return {"ok": fn()}
        except Exception as e:  # noqa: BLE001 — the class name is the outcome
            return {"raised": type(e).__name__}

    @serve.deployment
    class Echo:
        def __call__(self, payload):
            return payload

        def shout(self, text):
            return str(text).upper()

    @serve.deployment(num_replicas=2)
    class Adder:
        def __call__(self, payload):
            return {"sum": int(payload["a"]) + int(payload["b"])}

    @serve.deployment
    class Boom:
        def __call__(self, _):
            raise ValueError("kaboom")

    @serve.deployment
    class Streamer:
        def __call__(self, payload):
            for i in range(int(payload.get("n", 3))):
                yield {"i": i}

    @serve.deployment(num_replicas=1, max_ongoing_requests=64)
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=2.0)
        async def __call__(self, items):
            self.sizes.append(len(items))
            return [x * 10 for x in items]

        def batch_sizes(self, _):
            return list(self.sizes)

    @serve.deployment(num_replicas=3, max_ongoing_requests=16)
    class Lora:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=1)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return model_id

        async def __call__(self, payload):
            mid = serve.get_multiplexed_model_id()
            return {"model": await self.get_model(mid),
                    "replica": serve.get_replica_context().replica_id}

        def loads_so_far(self, _):
            return list(self.loads)

    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class Gate:
        def __call__(self, payload):
            time.sleep(float(payload.get("sleep", 0)))
            return "ok"

    # Handles and composition.
    h = serve.run(Echo.bind(), proxy=False)
    out["handle"] = [h.remote({"a": 1}).result(timeout_s=T),
                     h.shout.remote("hi").result(timeout_s=T)]
    out["status_after_run"] = _stable(serve.status())
    out["missing_app"] = outcome(lambda: serve.get_app_handle("nope"))

    # HTTP: routes, a GET query, a path no prefix but "/" takes, a user
    # error, a stream.
    serve.run(Adder.bind(), name="adder", route_prefix="/add")
    serve.run(Boom.bind(), name="boom", route_prefix="/boom")
    serve.run(Streamer.bind(), name="stream", route_prefix="/stream")
    port = serve.get_proxy_port()
    out["http"] = {
        "post": _http(port, "/add", {"a": 2, "b": 3}),
        "get": _http(port, "/add?a=7&b=1"),
        "missing": _http(port, "/nope/xyz"),
    }
    err = _http(port, "/boom", {})
    out["http"]["user_error"] = {"code": err["code"], "type": err["body"]["type"],
                                 "kaboom": "kaboom" in err["body"]["error"]}
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/stream", data=json.dumps({"n": 3}).encode(),
        headers={"Content-Type": "application/json", "Accept": "text/event-stream"},
        method="POST")
    with urllib.request.urlopen(req, timeout=T) as r:
        out["sse"] = [r.headers["Content-Type"], r.read().decode()]
    out["stream_handle"] = list(serve.get_deployment_handle("Streamer").options(
        stream=True).remote({"n": 4}))
    controller = rt.get_actor("SERVE_CONTROLLER", namespace="serve")
    out["routes"] = rt.get(controller.get_routes.remote(), timeout=T)
    out["apps"] = rt.get(controller.list_applications.remote(), timeout=T)

    # Overload: 503 while one slow request holds the only slot.
    serve.run(Gate.bind(), name="gate", route_prefix="/gate")
    out["gate_first"] = _http(port, "/gate", {})
    t = threading.Thread(target=lambda: _http(port, "/gate", {"sleep": 2.0}))
    t.start()
    time.sleep(0.5)
    shed = _http(port, "/gate", {})
    t.join(timeout=T)
    out["overload"] = {"code": shed["code"], "type": shed["body"].get("type"),
                       "retry": "retry_after_s" in shed["body"]}

    # Batching: eight requests queued at once fill two batches of four.
    hb = serve.run(Batched.bind(), name="batched", proxy=False)
    resps = [hb.remote(i) for i in range(8)]
    out["batched"] = [r.result(timeout_s=T) for r in resps]
    out["batch_sizes"] = hb.batch_sizes.remote(0).result(timeout_s=T)

    # Multiplexing: each model id sticks to one replica; a replica's
    # one-model cache loads a, b, a on a, b, a.
    hl = serve.run(Lora.bind(), name="lora", proxy=False)
    deadline = time.monotonic() + T
    while serve.status()["Lora"]["running_replicas"] < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    stick = {}
    for mid in ("m1", "m2", "m3"):
        got = [hl.options(multiplexed_model_id=mid).remote({}).result(timeout_s=T)
               for _ in range(4)]
        stick[mid] = {"models": sorted({g["model"] for g in got}),
                      "replicas": len({g["replica"] for g in got})}
    out["multiplex_sticky"] = stick
    reps = [(f"r{i}", None) for i in range(5)]
    out["rendezvous"] = {m: multiplex.rendezvous_pick(reps, m)[0]
                         for m in ("m1", "m2", "m3", "lora-a", "lora-b")}
    out["multiplex_missing_id"] = outcome(
        lambda: hl.remote({}).result(timeout_s=T))

    # Deleting an app takes its route with it: /boom falls through to
    # "/", the prefix of the last app run without one (Lora, which wants
    # a model id).
    serve.delete("boom")
    gone = _http(port, "/boom", {})
    out["deleted_route"] = {"code": gone["code"], "type": gone["body"]["type"],
                            "no_model_id": "no model id" in gone["body"]["error"]}
    out["status_before_shutdown"] = _stable(serve.status())
    # A class defined in a function is not importable: no config of it.
    out["build_refused"] = outcome(lambda: serve.build(Echo.bind()))
    serve.shutdown()
    out["status_after_shutdown"] = serve.status()
    rt.shutdown()
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ({"jax", "ray_tpu"} - {pkg}))
    return out


if __name__ == "__main__":
    pkg = sys.argv[1]
    if pkg == "ray_tpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    print(json.dumps(main(pkg), default=str))
