"""One script run under ray_tpu and under ray_tpu_torch, each in its own
process, by tests/test_torch_core_parity.py:

    python tests/torch_core_parity_cases.py ray_tpu|ray_tpu_torch

It prints one JSON object of outcomes (results, exception class names,
wait partitions, actor call order, named-actor lookups, the cluster's
resource keys). It imports only the package it is given, so the
ray_tpu_torch run loads neither jax nor ray_tpu.
"""

import importlib
import json
import os
import sys
import time

T = 30  # every get and wait is bounded


def main(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    exc = importlib.import_module(pkg + ".exceptions")
    # The chip resource: "TPU" in ray_tpu, "GPU" in the port; num_gpus=
    # is the port's name for it (num_tpus= its alias).
    chip = {"num_tpus": 2} if pkg == "ray_tpu" else {"num_gpus": 2}
    rt.init(num_cpus=4, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1}, **chip)
    out = {}

    def outcome(fn):
        try:
            return {"ok": fn()}
        except Exception as e:  # noqa: BLE001 — the class name is the outcome
            return {"raised": type(e).__name__}

    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(num_returns=3)
    def three(x):
        return x, x * 2, x * 3

    @rt.remote
    def outer(x):
        return rt.get(add.remote(x, 1), timeout=T) * 10

    @rt.remote
    def gen(n):
        for i in range(n):
            yield {"i": i, "sq": i * i}

    @rt.remote
    def boom():
        raise ValueError("kaboom")

    @rt.remote
    def consume(x):
        return x

    @rt.remote
    def late(s, v):
        time.sleep(s)
        return v

    @rt.remote(max_retries=0)
    def die():
        os._exit(1)

    ref = add.remote(0, 1)
    for i in range(5):
        ref = add.remote(ref, i)
    out["chain"] = rt.get(ref, timeout=T)
    out["multi_return"] = rt.get(list(three.remote(7)), timeout=T)
    out["nested"] = rt.get(outer.remote(4), timeout=T)
    out["stream"] = [rt.get(r, timeout=T) for r in gen.remote(4)]
    value = {"a": [1, 2.5, "x"], "b": (None, True), "c": b"\x00\x01" * 64}
    back = rt.get(rt.put(value), timeout=T)
    out["put_get"] = [back["a"], list(back["b"]), back["c"].hex()]
    out["task_error"] = outcome(lambda: rt.get(boom.remote(), timeout=T))
    out["dep_error"] = outcome(
        lambda: rt.get(consume.remote(boom.remote()), timeout=T))
    out["get_timeout"] = outcome(
        lambda: rt.get(late.remote(1.0, "late"), timeout=0.1))
    out["worker_crash"] = outcome(lambda: rt.get(die.remote(), timeout=T))
    out["not_an_objectref"] = outcome(lambda: rt.wait(rt.put(1)))

    refs = [late.remote(1.0, "slow"), late.remote(0.0, "quick"),
            late.remote(0.0, "quick2")]
    ready, pending = rt.wait(refs, num_returns=2, timeout=10)
    out["wait"] = [sorted(refs.index(r) for r in ready),
                   sorted(refs.index(r) for r in pending)]
    ready, pending = rt.wait(refs, num_returns=3, timeout=T)
    out["wait_all"] = [len(ready), len(pending)]

    @rt.remote
    class Log:
        def __init__(self, tag):
            self.tag, self.items = tag, []

        def append(self, x):
            self.items.append(x)
            return len(self.items)

        def get(self):
            return [self.tag, self.items]

        def fail(self):
            raise RuntimeError("actor method failed")

    log = Log.options(name="log-actor").remote("t")
    counts = [log.append.remote(i) for i in range(20)]
    out["actor_counts"] = rt.get(counts, timeout=T)
    out["actor_order"] = rt.get(log.get.remote(), timeout=T)
    same = rt.get_actor("log-actor")
    out["named_lookup"] = rt.get(same.get.remote(), timeout=T)
    out["named_missing"] = outcome(lambda: rt.get_actor("no-such-actor"))
    out["actor_error"] = outcome(lambda: rt.get(log.fail.remote(), timeout=T))
    rt.kill(log)
    time.sleep(0.5)
    out["after_kill"] = outcome(lambda: rt.get(log.get.remote(), timeout=T))

    def chip_name(k):
        return "CHIP" if k in ("TPU", "GPU") else k

    total = rt.cluster_resources()
    out["resource_keys"] = sorted(chip_name(k) for k in total)
    out["resource_counts"] = {chip_name(k): total[k] for k in ("CPU", "TPU", "GPU")
                              if k in total}
    rt.shutdown()
    out["foreign_modules"] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "ray_tpu") and pkg != "ray_tpu")
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1]), sort_keys=True))
