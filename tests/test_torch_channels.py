"""The port's channels (ray_tpu_torch.experimental) on the CPU: the shm
ring as tests/test_channels.py:31-133 drives ray_tpu's (roundtrip and
backpressure, capacity, ring run-ahead, the creator's handle collected
first, a write aborted mid-slot, a reader in another process), the
port's value rules (a numpy array read as a view of the slot, a tensor
as a fresh copy), the TCP lane, the device channel's plain version (CPU
tensors as host bytes) and its refusals, a device edge's refusals at
compile time (more than one reader, a graph that cannot compile to
channels), and util.collective on CPU tensors (results equal to numpy's,
returned as tensors). One cluster for the file; every read and get is
bounded."""

import gc
import os

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import serialization
from ray_tpu_torch.experimental import device_channel
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed, ChannelTimeout
from ray_tpu_torch.experimental.tcp_channel import TcpChannelReader, TcpChannelServer

T = 30


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=3, object_store_memory=64 * 1024 * 1024,
            _system_config={"head_shards": 1})
    yield
    rt.shutdown()


def test_channel_roundtrip_and_backpressure():
    ch = Channel(capacity=1 << 20, num_readers=1, num_slots=1)
    rd = Channel(name=ch.name, _create=False)
    ch.write({"x": np.arange(8), "tag": "m"})
    v = rd.begin_read()
    assert v["tag"] == "m" and v["x"].sum() == 28
    rd.end_read()
    ch.write(1)
    assert rd.begin_read() == 1
    with pytest.raises(ChannelTimeout):
        ch.write(2, timeout_s=0.2)
    rd.end_read()
    ch.write(2)
    assert rd.read() == 2
    ch.close()
    with pytest.raises(ChannelClosed):
        rd.begin_read(timeout_s=1.0)


def test_channel_capacity_enforced():
    ch = Channel(capacity=1024, num_readers=1)
    with pytest.raises(ValueError, match="exceeds channel capacity"):
        ch.write(np.zeros(100000))
    with pytest.raises(ValueError, match="exceeds channel capacity"):
        ch.write(torch.zeros(100000))


def test_channel_ring_runahead():
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=4)
    rd = Channel(name=ch.name, _create=False)
    for i in range(4):
        ch.write(i, timeout_s=2)
    with pytest.raises(ChannelTimeout):
        ch.write(99, timeout_s=0.2)
    assert [rd.read() for _ in range(4)] == [0, 1, 2, 3]
    ch.write(4)
    assert rd.read() == 4


def test_channel_survives_creator_gc():
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=4)
    name = ch.name
    assert name.startswith("/ray_tpu_torch-chan-")  # the port's own shm names
    rd = Channel(name=name, _create=False)
    for i in range(3):
        ch.write(i)
    del ch
    gc.collect()
    assert [rd.read() for _ in range(3)] == [0, 1, 2]
    rd2 = Channel(name=name, _create=False)
    del rd2
    assert os.path.exists("/dev/shm" + name)
    del rd
    gc.collect()
    assert not os.path.exists("/dev/shm" + name)


def test_channel_write_abort_on_serialization_failure(monkeypatch):
    ch = Channel(capacity=1 << 16, num_readers=1, num_slots=1)
    rd = Channel(name=ch.name, _create=False)
    real_write_to = serialization.write_to
    calls = {"n": 0}

    def failing_write_to(view, header, buffers):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom mid-slot")
        return real_write_to(view, header, buffers)

    monkeypatch.setattr(serialization, "write_to", failing_write_to)
    with pytest.raises(RuntimeError, match="boom mid-slot"):
        ch.write("doomed")

    class Bomb:
        def __reduce__(self):
            raise RuntimeError("boom early")

    with pytest.raises(Exception, match="boom early"):
        ch.write(Bomb())
    ch.write("after")
    assert rd.read() == "after"


def test_channel_values_follow_the_store_rules():
    """A numpy array is read as a view of the slot (valid to end_read); a
    tensor is rebuilt as a fresh tensor the reader may write; bf16 keeps
    its bits; the reader records the message's bytes in the slot."""
    ch = Channel(capacity=1 << 20, num_readers=1, num_slots=2)
    rd = Channel(name=ch.name, _create=False)
    t = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    value = {"a": np.arange(4.0), "t": t}
    ch.write(value)
    v = rd.begin_read()
    assert not v["a"].flags.owndata and v["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert torch.equal(v["t"], t) and v["t"].dtype == torch.bfloat16
    v["t"].add_(1)  # a copy of its own
    assert rd.last_read_bytes == serialization.serialized_size(
        *serialization.serialize(value)) > t.numel() * 2
    rd.end_read()


def test_tcp_channel_roundtrip_and_close():
    srv = TcpChannelServer("/t-chan", num_readers=1, num_slots=2)
    rd = TcpChannelReader("/t-chan", srv.endpoint)
    srv.write({"x": torch.arange(5)}, timeout_s=5)
    srv.write(2, timeout_s=5)
    with pytest.raises(ChannelTimeout):
        srv.write(3, timeout_s=0.3)  # two unacked: the ring is full
    v = rd.begin_read(timeout_s=5)
    assert torch.equal(v["x"], torch.arange(5))
    rd.end_read()
    assert rd.read(timeout_s=5) == 2
    srv.close()
    with pytest.raises(ChannelClosed):
        rd.begin_read(timeout_s=5)
    rd.close()


def test_device_channel_plain_version_and_refusals():
    """CPU tensors cross a device edge as host bytes in the slot; a
    descriptor naming a card this process cannot see, or a writer on
    another host, raises (nothing falls back to a host copy)."""
    meta = Channel(capacity=1 << 20, num_readers=1, num_slots=2)
    w = device_channel.DeviceChannelWriter(meta)
    r = device_channel.DeviceChannelReader(Channel(name=meta.name, _create=False))
    tree = {"w": torch.ones(3, 3), "tag": "meta", "n": 3, "a": np.arange(3)}
    w.write(tree, timeout_s=5)
    got = r.begin_read(timeout_s=5)
    r.end_read()  # the value owns its buffers
    assert torch.equal(got["w"], tree["w"]) and got["tag"] == "meta" and got["n"] == 3
    assert got["a"].tolist() == [0, 1, 2]
    ipc = device_channel._IpcTensor("GPU-00000000-0000-0000-0000-000000000000",
                                    "bfloat16", (4,), (1,), 0, (), b"")
    meta.write({"uuid": 1 << 32 | 1, "host": device_channel._host_id(), "tree": [ipc]})
    with pytest.raises(RuntimeError, match="not visible here"):
        r.begin_read(timeout_s=5)
    r.end_read()
    meta.write({"uuid": 1 << 32 | 2, "host": "elsewhere/boot", "tree": [ipc]})
    with pytest.raises(RuntimeError, match="same-host only"):
        r.begin_read(timeout_s=5)
    r.end_read()
    # writer ids are numbered per process, never reused
    assert device_channel.DeviceChannelWriter(meta)._base > w._base


def test_channel_cross_process(cluster):
    @rt.remote
    class Consumer:
        def consume(self, chan, n):
            total = 0.0
            for _ in range(n):
                v = chan.begin_read(timeout_s=30)
                total += float(v.sum())
                chan.end_read()
            return total

    ch = Channel(capacity=1 << 20, num_readers=1)
    c = Consumer.remote()
    ref = c.consume.remote(ch, 5)
    for i in range(5):
        ch.write(torch.full((100,), float(i)) if i % 2 else np.full(100, float(i)))
    assert rt.get(ref, timeout=T) == sum(i * 100 for i in range(5))
    rt.kill(c)


def test_device_edge_refuses_a_host_path(cluster):
    """A device edge with two readers (two actors, or an actor and the
    driver), or in a graph that falls back to the ObjectRef path, raises
    DeviceEdgeError at compile time, naming the method; the graph with one
    reader compiles and runs."""
    from ray_tpu_torch.dag import DeviceEdgeError, InputNode, MultiOutputNode

    @rt.remote(num_cpus=0)
    class Node:
        def make(self, s):
            return torch.full((4,), float(s))

        def total(self, x):
            return float(x.sum())

    p, c1, c2 = Node.remote(), Node.remote(), Node.remote()

    @rt.remote(num_cpus=0)
    def total(x):
        return float(x.sum())

    try:
        with InputNode() as inp:
            x = p.make.bind(inp).with_tensor_transport("device")
            two_actors = MultiOutputNode([c1.total.bind(x), c2.total.bind(x)])
        with pytest.raises(DeviceEdgeError, match=r"make\(\).*2 readers"):
            two_actors.experimental_compile()
        with InputNode() as inp:
            x = p.make.bind(inp).with_tensor_transport("device")
            with_driver = MultiOutputNode([c1.total.bind(x), x])
        with pytest.raises(DeviceEdgeError, match="driver"):
            with_driver.experimental_compile()
        with InputNode() as inp:
            function_dag = total.bind(p.make.bind(inp).with_tensor_transport("device"))
        with pytest.raises(DeviceEdgeError, match="legacy ObjectRef path"):
            function_dag.experimental_compile()
        assert issubclass(DeviceEdgeError, ValueError)
        with InputNode() as inp:
            one = c1.total.bind(p.make.bind(inp).with_tensor_transport("device"))
        dag = one.experimental_compile().ensure_compiled()
        try:
            assert rt.get(dag.execute(2), timeout=T) == 8.0
        finally:
            dag.teardown()
    finally:
        for a in (p, c1, c2):
            rt.kill(a)


def test_collective_takes_tensors(cluster):
    """Tensors in, tensors out (on the caller's device), equal to the
    numpy results of the same inputs."""

    @rt.remote
    class Rank:
        def __init__(self, rank):
            from ray_tpu_torch.util import collective

            self.g = collective.init_collective_group(2, rank, group_name="tensors")
            self.x = torch.arange(4, dtype=torch.float32) * (rank + 1)
            self.rank = rank

        def ops(self):
            outs = {"sum": self.g.allreduce(self.x), "mean": self.g.allreduce(self.x, "mean"),
                    "max": self.g.allreduce(self.x, "max"),
                    "gather": self.g.allgather(self.x),
                    "scatter": self.g.reducescatter(self.x),
                    "bcast": self.g.broadcast(self.x if self.rank == 0
                                              else torch.zeros(4), src=0),
                    "bcast_none": self.g.broadcast(self.x if self.rank == 0 else None,
                                                   src=0)}
            kinds = {k: type(v[0] if isinstance(v, list) else v).__name__
                     for k, v in outs.items()}
            vals = {k: ([t.tolist() for t in v] if isinstance(v, list) else v.tolist())
                    for k, v in outs.items()}
            return kinds, vals

    ranks = [Rank.remote(r) for r in range(2)]
    got = rt.get([r.ops.remote() for r in ranks], timeout=60)
    xs = [np.arange(4, dtype=np.float32) * (r + 1) for r in range(2)]
    for rank, (kinds, vals) in enumerate(got):
        assert set(kinds.values()) == {"Tensor"}
        assert vals["sum"] == (xs[0] + xs[1]).tolist()
        assert vals["mean"] == np.stack(xs).mean(axis=0).tolist()
        assert vals["max"] == np.maximum(*xs).tolist()
        assert vals["gather"] == [x.tolist() for x in xs]
        assert vals["scatter"] == np.array_split(xs[0] + xs[1], 2)[rank].tolist()
        assert vals["bcast"] == vals["bcast_none"] == xs[0].tolist()
    for r in ranks:
        rt.kill(r)
