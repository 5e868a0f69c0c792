"""The port's task/actor core (ray_tpu_torch._private) held bit for bit
against ray_tpu's on pure functions: wire encodings, packed task specs,
ids, object serialization, scheduler placements, config overrides and
retry backoff. Starts no cluster. Then the port's own torch tensor
reducer: every tensor comes back exact, as one out-of-band buffer."""

import dataclasses
import pickle
import random

import numpy as np
import pytest
import torch

from ray_tpu._private import config as r_config
from ray_tpu._private import ids as r_ids
from ray_tpu._private import retry as r_retry
from ray_tpu._private import scheduler as r_sched
from ray_tpu._private import serialization as r_ser
from ray_tpu._private import task_spec as r_spec
from ray_tpu._private import wirefmt as r_wire
from ray_tpu_torch._private import config as p_config
from ray_tpu_torch._private import ids as p_ids
from ray_tpu_torch._private import retry as p_retry
from ray_tpu_torch._private import scheduler as p_sched
from ray_tpu_torch._private import serialization as p_ser
from ray_tpu_torch._private import task_spec as p_spec
from ray_tpu_torch._private import wirefmt as p_wire

# ----------------------------------------------------------------- wire

WIRE_CORPUS = [
    ("task_finished", 0, {"task_id": "task-1", "ok": True, "n": -7,
                          "x": 1.5, "payload": b"\x00\xff", "none": None}),
    ("seal_objects", 0, {"objects": [["a", 1, 2.0], ("b", -3)]}),
    ("del_ref", 0, {"ids": ["o1", "o2", "o3"]}),
    ("put_inline", 17, {"object_id": "o", "payload": b"x" * 300,
                        "contained_ids": [], "is_error": False}),
    ("direct_push", 300, {"res": {"CPU": 1.0, "GPU": 0.5},
                          "addr": ("127.0.0.1", 4242)}),
    ("submit_task", 2 ** 40, {"deep": [[[[1]]]], "big": 2 ** 62,
                              "neg": -(2 ** 63)}),
    ("__batch__", 0, [("del_ref", {"ids": ["a"]}),
                      ("add_borrow", {"id": "b"})]),
    ("not_a_hot_kind", 0, {"a": 1}),
    ("task_started", 0, {"exotic": object()}),
]


@pytest.mark.parametrize("case", range(len(WIRE_CORPUS)))
@pytest.mark.parametrize("lane", ["native", "python"])
def test_wire_encodings_match(case, lane, monkeypatch):
    kind, msg_id, body = WIRE_CORPUS[case]
    if kind == "__batch__":
        kind = r_wire._CAST_BATCH
        assert p_wire._CAST_BATCH == kind
    if lane == "python":
        monkeypatch.setattr(r_wire, "_codec", r_wire.PY_CODEC)
        monkeypatch.setattr(p_wire, "_codec", p_wire.PY_CODEC)
    ref = r_wire.encode(kind, msg_id, body)
    out = p_wire.encode(kind, msg_id, body)
    assert out == ref
    if ref is not None:
        assert p_wire.decode_frame(out) == r_wire.decode_frame(ref)


def test_wire_kind_tables_match():
    assert p_wire.KIND_CODES == r_wire.KIND_CODES
    assert (p_wire.WIRE_MAGIC, p_wire.WIRE_VERSION) == (
        r_wire.WIRE_MAGIC, r_wire.WIRE_VERSION)
    buf = [("del_ref", {"ids": ["a"]}), ("del_ref", {"ids": ["b"]}),
           ("task_finished", {"t": 1})]
    assert p_wire.coalesce_casts(list(buf)) == r_wire.coalesce_casts(list(buf))


# ------------------------------------------------------------ task specs

SPEC_FIELDS = dict(
    task_id="task-00ff", name="f", func_id="fn-1", args=b"\x80\x05args",
    deps=["o1", "o2"], return_ids=["r1"], resources={"CPU": 1.0, "GPU": 1.0},
    owner_id="driver", owner_addr=("127.0.0.1", 5555), max_retries=3,
    runtime_env={"env_vars": {"A": "1"}}, actor_id="actor-1",
    method_name="m", seq_no=9, borrowed_ids=["o3"], max_calls=2)


@pytest.mark.parametrize("extra", [{}, {"deadline": 1234.5},
                                   {"trace_ctx": ("t", "s", True)},
                                   {"streaming": True, "concurrency_group": "io"}],
                         ids=["plain", "deadline", "trace", "streaming"])
def test_task_spec_packing_matches(extra):
    ref = r_spec.pack_spec(r_spec.TaskSpec(**SPEC_FIELDS, **extra))
    out = p_spec.pack_spec(p_spec.TaskSpec(**SPEC_FIELDS, **extra))
    assert ref is not None and out == ref
    back = p_spec.unpack_spec(out)
    ref_back = r_spec.unpack_spec(ref)
    for f in dataclasses.fields(ref_back):
        if not f.name.startswith("_"):
            assert getattr(back, f.name) == getattr(ref_back, f.name), f.name
    assert p_spec.shape_key(back) == r_spec.shape_key(ref_back)
    renv = {"pip": ["x==1"], "env_vars": {"A": "1"}}
    assert p_spec.env_pkg_key(renv) == r_spec.env_pkg_key(renv)


# ------------------------------------------------------------------- ids

def test_ids_match():
    for cls in ("TaskID", "ActorID", "NodeID", "PlacementGroupID"):
        r, p = getattr(r_ids, cls)("ab12"), getattr(p_ids, cls)("ab12")
        assert (p.hex(), repr(p), hash(p)) == (r.hex(), repr(r), hash(r))
    r, p = r_ids.ObjectRef("cd34"), p_ids.ObjectRef("cd34")
    assert (p.hex(), repr(p), p.is_owned()) == (r.hex(), repr(r), r.is_owned())
    assert len(p_ids.fast_hex_id()) == len(r_ids.fast_hex_id()) == 32
    assert p_ids.fast_hex_id() != p_ids.fast_hex_id()


# --------------------------------------------------------- serialization

SER_CORPUS = [
    1, "hello", {"a": [1, 2]}, (None, True), b"\x00\xff" * 100,
    np.arange(12, dtype=np.float32).reshape(3, 4),
    {"x": np.ones((64, 64)), "y": [np.int8(3), np.zeros(0, np.int64)]},
    np.asfortranarray(np.arange(6.0).reshape(2, 3)),
]


@pytest.mark.parametrize("case", range(len(SER_CORPUS)))
def test_serialization_matches(case):
    obj = SER_CORPUS[case]
    r_header, r_bufs = r_ser.serialize(obj)
    p_header, p_bufs = p_ser.serialize(obj)
    assert p_header == r_header
    assert [bytes(b.raw()) for b in p_bufs] == [bytes(b.raw()) for b in r_bufs]
    assert p_ser.dumps(obj) == r_ser.dumps(obj)
    back = p_ser.loads(r_ser.dumps(obj))
    assert pickle.dumps(back) == pickle.dumps(r_ser.loads(p_ser.dumps(obj)))


# ------------------------------------------------------------- scheduler

NODES = [("n1", {"CPU": 4.0, "memory": 8.0}),
         ("n2", {"CPU": 8.0, "TPU": 4.0, "memory": 16.0}),
         ("n3", {"CPU": 2.0, "TPU": 2.0, "custom": 1.0})]
DEMANDS = [{"CPU": 1.0}, {"CPU": 2.0}, {"TPU": 1.0}, {"CPU": 1.0, "TPU": 2.0},
           {"custom": 0.5}, {"CPU": 3.0}, {"memory": 4.0}, {"CPU": 0.25},
           {"TPU": 3.0}, {"CPU": 64.0}]
BUNDLES = [[{"CPU": 1.0}] * 3, [{"CPU": 2.0}, {"TPU": 1.0}],
           [{"CPU": 1.0, "TPU": 1.0}] * 2, [{"CPU": 9.0}]]


def _chip(d, name):
    """ray_tpu's chip resource is "TPU", the port's "GPU"."""
    return {(name if k == "TPU" else k): v for k, v in d.items()}


def _placements(sched_mod, chip):
    s = sched_mod.ClusterScheduler(0.5)
    for nid, res in NODES:
        res = _chip(res, chip)
        s.add_node(sched_mod.NodeEntry(
            nid, "127.0.0.1", sched_mod.ResourceSet(res),
            sched_mod.ResourceSet(res)))
    picks = []
    for d in DEMANDS:
        demand = sched_mod.ResourceSet(_chip(d, chip))
        node = s.pick_node(demand)
        picks.append(None if node is None else node.node_id)
        if node is not None:
            s.acquire(node.node_id, demand)
    for bundles in BUNDLES:
        for policy in ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD"):
            picks.append(s.place_bundles([_chip(b, chip) for b in bundles],
                                         policy))
    split = [sched_mod.split_shard_resources(_chip(NODES[1][1], chip), i, 3)
             for i in range(3)]
    return picks, [{("TPU" if k == chip else k): v for k, v in x.items()}
                   for x in split]


def test_scheduler_placements_match():
    assert _placements(p_sched, "GPU") == _placements(r_sched, "TPU")


@pytest.mark.parametrize("n,total", [(1, 4), (2, 4), (4, 4), (8, 3), (3, 2)])
def test_shards_lease_disjoint_device_ranges(n, total):
    """Each head shard leases the devices its slice counts, from its own
    first index (ray_tpu numbers every shard's pool from 0, so two
    shards could lease one chip)."""
    ranges = [p_sched.shard_gpu_range(n, i, total) for i in range(total)]
    assert [i for lo, hi in ranges for i in range(lo, hi)] == list(range(n))
    for i, (lo, hi) in enumerate(ranges):
        part = p_sched.split_shard_resources({"GPU": float(n)}, i, total)
        assert part.get("GPU", 0.0) == hi - lo


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("overrides", [None, {"object_store_memory": 1 << 20,
                                              "head_shards": 2},
                                       {"task_max_retries_default": 7}])
def test_config_apply_overrides_matches(overrides, monkeypatch):
    monkeypatch.setenv("RAY_TPU_MAX_INLINE_OBJECT_SIZE", "4096")
    ref = dataclasses.asdict(r_config.Config().apply_overrides(overrides))
    out = dataclasses.asdict(p_config.Config().apply_overrides(overrides))
    assert out == ref
    assert out["max_inline_object_size"] == 4096
    with pytest.raises(ValueError, match="unknown system config key"):
        p_config.Config().apply_overrides({"no_such_knob": 1})


# ----------------------------------------------------------------- retry

@pytest.mark.parametrize("kw", [{}, {"jitter": 0.0}, {"multiplier": 3.0,
                                                     "max_delay_s": 0.5}])
def test_retry_backoff_delays_match(kw):
    def delays(mod):
        random.seed(1234)
        gen = mod.backoff_delays(mod.RetryPolicy(**kw))
        return [next(gen) for _ in range(12)]

    assert delays(p_retry) == delays(r_retry)


# ------------------------------------------------------- tensor reducer

def _tensors():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(6, 8, generator=g)
    return {
        "f32": base,
        "bf16": base.to(torch.bfloat16),
        "int64": torch.arange(-5, 7, dtype=torch.int64).reshape(3, 4),
        "non_contiguous": base.t()[::2],
        "zero_dim": torch.tensor(3.25),
        "empty": torch.zeros(0, 3),
        "bool": base > 0,
    }


def _assert_same(a, b):
    assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
    assert a.device.type == b.device.type == "cpu"
    assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bool else a,
                       b.view(torch.uint8) if b.dtype == torch.bool else b)


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_tensor_roundtrip_one_buffer(name):
    t = _tensors()[name]
    header, bufs = p_ser.serialize(t)
    assert len(bufs) == 1
    assert len(bufs[0].raw()) == t.numel() * t.element_size()
    _assert_same(p_ser.loads(p_ser.dumps(t)), t)


def test_nested_tensors_one_buffer_each():
    ts = _tensors()
    obj = {"a": ts, "b": [ts["bf16"].clone(), (ts["zero_dim"].clone(), "x")],
           "n": 3, "same": ts["f32"]}
    _, bufs = p_ser.serialize(obj)
    # one buffer per distinct tensor: "same" is ts["f32"] itself, which
    # pickle's memo sends once and restores as one object
    assert len(bufs) == len(ts) + 2
    back = p_ser.loads(p_ser.dumps(obj))
    for k, t in ts.items():
        _assert_same(back["a"][k], t)
    _assert_same(back["b"][0], ts["bf16"])
    _assert_same(back["b"][1][0], ts["zero_dim"])
    assert back["same"] is back["a"]["f32"]
    assert back["b"][1][1] == "x" and back["n"] == 3


def test_tensor_read_is_a_copy_of_the_payload():
    """The zero-copy read path hands the reducer read-only views of the
    store; the tensor that comes back is writable and owns its bytes."""
    t = torch.arange(16, dtype=torch.float32)
    payload = bytearray(p_ser.dumps({"t": t, "p": torch.nn.Parameter(t * 2)}))
    frozen = bytes(payload)
    views = []

    def wrap(mv):
        views.append(np.frombuffer(mv, dtype=np.uint8))
        return views[-1]

    back = p_ser.loads_from(memoryview(payload).toreadonly(), wrap_buffer=wrap)
    assert len(views) == 2 and not views[0].flags.writeable
    back["t"].add_(1)
    assert bytes(payload) == frozen
    assert torch.equal(back["t"], t + 1)
    assert type(back["p"]) is torch.nn.Parameter and back["p"].requires_grad
    assert torch.equal(back["p"].detach(), t * 2)


def test_torch_free_process_keeps_the_c_pickler(monkeypatch):
    """With neither torch loaded nor a reducer armed, _dump takes
    cloudpickle's C fast path (ray_tpu's gate was on jax)."""
    import sys

    calls = []
    monkeypatch.delitem(sys.modules, "torch")
    monkeypatch.setattr(p_ser, "_RuntimePickler",
                        lambda *a, **k: calls.append(a) or None)
    assert p_ser.loads(p_ser.dumps({"a": 1})) == {"a": 1}
    assert calls == []


def test_lock_witness_survives_a_finalizer_inside_its_bookkeeping(monkeypatch):
    """A garbage collection inside the witness's own bookkeeping can run a
    finalizer that takes a watched lock on the same thread (ObjectRef.
    __del__ does). ray_tpu's witness then re-enters its non-reentrant
    state lock and deadlocks (its copy in ray_tpu/_private/lockwitness.py
    is the same code); the port's skips the nested edge."""
    import threading

    from ray_tpu_torch._private import lockwitness as lw

    a, b, c, d = (lw._WitnessLock(lw._ORIG_LOCK(), f"site-{n}") for n in "abcd")
    real = lw.traceback.format_stack

    def stack_with_a_finalizer(*args, **kw):
        with c:  # what ObjectRef.__del__ would take, mid-bookkeeping
            with d:
                pass
        return real(*args, **kw)

    monkeypatch.setattr(lw.traceback, "format_stack", stack_with_a_finalizer)

    def nested():
        with a:
            with b:
                pass

    t = threading.Thread(target=nested, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the witness deadlocked on its own state lock"
    monkeypatch.setattr(lw.traceback, "format_stack", real)
    try:
        assert ("site-a", "site-b") in lw._edges
        assert ("site-c", "site-d") not in lw._edges  # skipped, not recorded
    finally:
        with lw._state():
            for key in [k for k in lw._edges if k[0].startswith("site-")]:
                del lw._edges[key]
