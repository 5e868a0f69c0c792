"""Importable deployment classes of the port for tests/test_torch_serve.py's
serve build / run_from_config cases (a config names classes by import
path), and the HTTP and polling helpers of the serve tests. Imports
nothing of ray_tpu or torch."""

import json
import time
import urllib.error
import urllib.request

import pytest

from ray_tpu_torch import serve

T = 30  # seconds: every get, result and HTTP call of the serve tests is bounded


def wait_until(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"never happened: {msg}")


def http(port, path, payload=None, *, method=None, headers=None, timeout=T):
    """(status, body): JSON-decoded where it parses."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        method=method or ("POST" if data is not None else "GET"),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
        try:
            return r.status, json.loads(raw)
        except json.JSONDecodeError:
            return r.status, raw.decode()


def http_error(port, path, payload, **kw):
    with pytest.raises(urllib.error.HTTPError) as ei:
        http(port, path, payload, **kw)
    return ei.value.code, json.loads(ei.value.read())


def sse(port, path, payload, timeout=T):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "Accept": "text/event-stream"},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.headers["Content-Type"], r.read().decode()


@serve.deployment
class Doubler:
    def __call__(self, x):
        return 2 * x


@serve.deployment
class Chain:
    def __init__(self, inner):
        self.inner = inner

    def __call__(self, x):
        doubled = self.inner.remote(x).result(timeout_s=30)
        return doubled + 1
