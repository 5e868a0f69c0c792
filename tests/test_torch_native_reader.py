"""The port's native event-loop reader (ray_tpu_torch/src/eventloop).

A frame larger than the reader's 256 KiB buffer makes the reader grow
and compact its buffer. Frames already cut out of the same recv() must
reach Python before that move: otherwise they are read from offsets that
now point into the large frame's bytes (seen as "specenc: truncated" on
~440 KB actor calls). The first test sends exactly that byte pattern
over a socket pair; the second is the actor-call repro that showed it.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest


def _evloop():
    from ray_tpu_torch._private import evloop

    mod = evloop.module()
    if mod is None:
        pytest.fail("the native event loop did not build or load")
    return mod


def _frame(body: bytes) -> bytes:
    return len(body).to_bytes(4, "little") + body


@pytest.mark.parametrize("big_len", [300_000, 440_121, 1 << 20])
def test_small_frame_before_oversized_frame_arrives_intact(big_len):
    mod = _evloop()
    rng = np.random.default_rng(big_len)
    # First bytes != the wire magic: the reader hands them over raw.
    small = b"\x00" + rng.integers(0, 256, 90, dtype=np.uint8).tobytes()
    big = b"\x00" + rng.integers(0, 256, big_len - 1, dtype=np.uint8).tobytes()
    got, done = [], threading.Event()

    def deliver(batch):
        if batch is None:
            return False
        got.extend(bytes(x) for x in batch)
        if len(got) >= 2:
            done.set()
        return True

    a, b = socket.socketpair()
    try:
        handle = mod.attach(a.fileno(), deliver)
        head = _frame(big)[:4096]
        # One send: a whole small frame and the head of the large one,
        # so a single recv() holds both.
        b.sendall(_frame(small) + head)
        time.sleep(0.2)
        b.sendall(_frame(big)[4096:])
        assert done.wait(10), f"frames delivered: {len(got)}"
        assert got[0] == small
        assert got[1] == big
        mod.close(handle)
    finally:
        a.close()
        b.close()


REPRO = r"""
import sys
import numpy as np
import ray_tpu_torch as rt

rt.init(num_cpus=4, object_store_memory=64 << 20,
        _system_config={"head_shards": 1})
try:
    @rt.remote(num_cpus=0)
    class Sink:
        def report(self, metrics):
            return sum(x.size for x in metrics["g"])

    @rt.remote(num_cpus=0)
    class Caller:
        def go(self, sink, n):
            g = [np.ones(n, np.float32) for _ in range(8)]
            return [rt.get(sink.report.remote({"g": g}), timeout=20)
                    for _ in range(5)]

    sink = Sink.remote()
    callers = [Caller.remote() for _ in range(2)]
    out = rt.get([c.go.remote(sink, 13750) for c in callers], timeout=60)
    assert out == [[8 * 13750] * 5] * 2, out
    print("REPRO_OK")
finally:
    rt.shutdown()
"""


@pytest.mark.parametrize("trial", range(10))
def test_large_actor_calls_reach_the_head_whole(trial, tmp_path):
    """ROADMAP's repro: two callers, each sending 8 x 13,750 f32 five
    times to one sink. Run in a fresh process per trial (as the repro
    was: a cluster each), on the native lane."""
    import subprocess
    import sys

    _evloop()  # the lane must exist, or the trial proves nothing
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, TMPDIR=str(tmp_path))
    env.pop("RAY_TPU_NATIVE", None)
    env.pop("RAY_TPU_NATIVE_LOOP", None)
    r = subprocess.run([sys.executable, "-c", REPRO], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "REPRO_OK" in r.stdout, (
        r.stdout[-2000:] + r.stderr[-4000:])
