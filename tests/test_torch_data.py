"""ray_tpu_torch.data (the port of ray_tpu.data) through the scenarios of
tests/test_data.py, tests/test_data_actor_pool.py and
tests/test_data_preprocessors.py, on one port cluster (head_shards=1),
each scenario twice: ``inline`` (DataContext.use_tasks off, stages run in
the driver's thread pool, as with no cluster up) and ``cluster`` (stages
fan out as the core's tasks and actor pools). Beside them: the port's
``iter_torch_batches`` (device and dtypes), TorchTrainer(datasets=...)
with ``get_dataset_shard`` on the CPU, BC on a port Dataset, and a
``{"GPU": 1}`` pool lease pinning CUDA_VISIBLE_DEVICES. Every get and
fit is bounded. The parquet, csv, image, tfrecord and tf paths import
their libraries as the reference's tests do.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.executor import _rebatch
from ray_tpu_torch.data.preprocessors import (
    Chain,
    Concatenator,
    LabelEncoder,
    MinMaxScaler,
    Normalizer,
    OneHotEncoder,
    OrdinalEncoder,
    Preprocessor,
    PreprocessorNotFittedException,
    RobustScaler,
    SimpleImputer,
    StandardScaler,
    UniformKBinsDiscretizer,
)

T = 60  # seconds: every get of these tests is bounded


@pytest.fixture(scope="module", autouse=True)
def _cluster():
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8, num_gpus=2, object_store_memory=128 * 1024 * 1024,
            _system_config={"head_shards": 1})
    yield
    rt.shutdown()


@pytest.fixture(autouse=True, params=["inline", "cluster"])
def mode(request):
    """``inline``: the executor runs every stage in the driver (as with no
    cluster); ``cluster``: stages run as tasks and actor pools."""
    ctx = rd.DataContext.get_current()
    old = ctx.use_tasks
    ctx.use_tasks = request.param == "cluster"
    yield request.param
    ctx.use_tasks = old


# ---------------------------------------------------------------------------
# blocks


def test_block_accessor_dict_roundtrip():
    b = {"a": np.arange(5), "b": np.arange(5) * 2.0}
    acc = BlockAccessor(b)
    assert acc.num_rows() == 5
    assert acc.column_names() == ["a", "b"]
    assert BlockAccessor(acc.slice(1, 3)).num_rows() == 2
    rows = list(acc.iter_rows())
    assert rows[2] == {"a": 2, "b": 4.0}


def test_block_concat_schema_mismatch_raises():
    with pytest.raises(ValueError, match="differing schemas"):
        BlockAccessor.concat([{"a": np.arange(2)}, {"b": np.arange(2)}])


def test_rebatch_exact_sizes_linear():
    blocks = [{"x": np.arange(i * 10, i * 10 + 10)} for i in range(5)]
    out = list(_rebatch(iter(blocks), 16))
    sizes = [BlockAccessor(b).num_rows() for b in out]
    assert sizes == [16, 16, 16, 2]
    all_vals = np.concatenate([b["x"] for b in out])
    np.testing.assert_array_equal(all_vals, np.arange(50))


# ---------------------------------------------------------------------------
# core transforms (local thread mode)


def test_range_map_filter_count():
    ds = rd.range(100).map_batches(lambda b: {"id": b["id"] * 2})
    ds = ds.filter(lambda r: r["id"] % 4 == 0)
    assert ds.count() == 50
    assert ds.take(3) == [{"id": 0}, {"id": 4}, {"id": 8}]


def test_map_rows_and_flat_map():
    ds = rd.from_items([1, 2, 3]).map(lambda x: x + 10)
    assert ds.take_all() == [11, 12, 13]
    ds2 = rd.from_items([1, 2]).flat_map(lambda x: [x, x * 100])
    assert ds2.take_all() == [1, 100, 2, 200]


def test_column_ops():
    ds = rd.from_numpy({"a": np.arange(4), "b": np.ones(4)})
    ds = ds.add_column("c", lambda cols: cols["a"] + cols["b"])
    ds = ds.rename_columns({"b": "ones"}).drop_columns(["a"])
    rows = ds.take_all()
    assert rows[0] == {"ones": 1.0, "c": 1.0}
    sel = rd.from_numpy({"a": np.arange(4), "b": np.ones(4)}).select_columns(["a"])
    assert sel.columns() == ["a"]


def test_sort_shuffle_limit_repartition():
    ds = rd.from_numpy({"v": np.array([3, 1, 2, 5, 4])})
    assert [r["v"] for r in ds.sort("v").take_all()] == [1, 2, 3, 4, 5]
    assert [r["v"] for r in ds.sort("v", descending=True).take(2)] == [5, 4]
    shuffled = ds.random_shuffle(seed=0)
    assert sorted(r["v"] for r in shuffled.take_all()) == [1, 2, 3, 4, 5]
    assert ds.limit(2).count() == 2
    blocks = list(ds.repartition(3).iter_blocks())
    assert len(blocks) == 3
    assert sum(BlockAccessor(b).num_rows() for b in blocks) == 5


def test_union_and_zip():
    a = rd.from_numpy({"x": np.arange(3)})
    b = rd.from_numpy({"x": np.arange(3, 6)})
    assert [r["x"] for r in a.union(b).take_all()] == [0, 1, 2, 3, 4, 5]
    z = a.zip(rd.from_numpy({"y": np.arange(10, 13)}))
    assert z.take_all() == [
        {"x": 0, "y": 10}, {"x": 1, "y": 11}, {"x": 2, "y": 12}
    ]


def test_stats_and_unique():
    ds = rd.from_numpy({"v": np.array([1.0, 2.0, 2.0, 3.0])})
    assert ds.sum("v") == 8.0
    assert ds.min("v") == 1.0
    assert ds.max("v") == 3.0
    assert ds.mean("v") == 2.0
    assert ds.unique("v") == [1.0, 2.0, 3.0]


def test_groupby():
    ds = rd.from_items(
        [{"k": "a", "v": 1}, {"k": "b", "v": 10}, {"k": "a", "v": 3}]
    )
    counts = {r["k"]: r["count()"] for r in ds.groupby("k").count().take_all()}
    assert counts == {"a": 2, "b": 1}
    sums = {r["k"]: r["v"] for r in ds.groupby("k").sum("v").take_all()}
    assert sums == {"a": 4, "b": 10}
    maxes = {r["k"]: r["v"] for r in ds.groupby("k").max("v").take_all()}
    assert maxes == {"a": 3, "b": 10}


def test_groupby_std_and_aggregate():
    import numpy as np

    ds = rd.from_items(
        [{"k": "a", "v": 1}, {"k": "a", "v": 3}, {"k": "a", "v": 5},
         {"k": "b", "v": 10}]
    )
    stds = {r["k"]: r["v"] for r in ds.groupby("k").std("v").take_all()}
    assert abs(stds["a"] - 2.0) < 1e-9  # std([1,3,5], ddof=1) = 2
    assert stds["b"] == 0.0  # single element: defined as 0
    rows = ds.groupby("k").aggregate(
        total=("v", np.sum), spread=("v", lambda v: v.max() - v.min()),
    ).take_all()
    agg = {r["k"]: (r["total"], r["spread"]) for r in rows}
    assert agg == {"a": (9, 4), "b": (10, 0)}
    import pytest as _pytest

    with _pytest.raises(KeyError, match="nope"):
        ds.groupby("k").aggregate(x=("nope", np.sum)).take_all()
    with _pytest.raises(ValueError, match="group key"):
        ds.groupby("k").aggregate(k=("v", np.sum))


def test_class_udf_map_batches():
    class AddConst:
        def __init__(self, c):
            self.c = c

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = rd.range(10).map_batches(AddConst, fn_constructor_args=(100,))
    assert ds.take(2) == [{"id": 100}, {"id": 101}]


# ---------------------------------------------------------------------------
# iterators


def test_tfrecords_roundtrip(tmp_path):
    """write_tfrecords/read_tfrecords with a pure-Python
    tf.train.Example codec (reference read_api.py read_tfrecords uses
    TensorFlow; the wire format here is identical and TF-free)."""
    ds = rd.from_items([
        {"name": "a", "score": 1.5, "count": 3},
        {"name": "b", "score": -2.25, "count": 40},
        {"name": "c", "score": 0.5, "count": -7},
    ])
    out_dir = str(tmp_path / "tfr")
    files = ds.write_tfrecords(out_dir)
    assert files and all(f.endswith(".tfrecords") for f in files)
    back = sorted(rd.read_tfrecords(out_dir).iter_rows(),
                  key=lambda r: r["name"])
    assert [r["name"] for r in back] == [b"a", b"b", b"c"]  # bytes_list
    assert [r["count"] for r in back] == [3, 40, -7]  # signed int64
    assert np.allclose([r["score"] for r in back], [1.5, -2.25, 0.5])


def test_tfrecord_crc_and_framing(tmp_path):
    """The emitted framing carries valid masked CRC32Cs (a TF reader
    would verify them; known-answer check for crc32c('123456789'))."""
    from ray_tpu_torch.data.datasource import _crc32c, _masked_crc

    assert _crc32c(b"123456789") == 0xE3069283  # CRC-32C check value
    head = np.uint64(5).tobytes()
    assert _masked_crc(head) != _crc32c(head)  # masking applied


def test_tfrecords_sparse_features_and_unpacked_ints(tmp_path):
    """Valid wire forms beyond what our writer emits: records with
    HETEROGENEOUS feature keys normalize to the union (missing ->
    None), and UNPACKED int64 varints decode signed."""
    from ray_tpu_torch.data.datasource import (
        _ld,
        _masked_crc,
        _varint,
        decode_example,
    )

    # Unpacked negative int64: Int64List.value as a direct varint field.
    neg = (1 << 64) - 7  # -7 two's complement
    feature = _ld(3, _varint(1 << 3 | 0) + _varint(neg))
    entry = _ld(1, b"count") + _ld(2, feature)
    ex = _ld(1, _ld(1, entry))
    assert decode_example(ex) == {"count": [-7]}

    # Sparse keys across records in one file.
    from ray_tpu_torch.data.datasource import encode_example

    out = tmp_path / "sparse.tfrecords"
    with open(out, "wb") as f:
        for row in [{"a": 1, "b": 2}, {"a": 3}]:
            data = encode_example(row)
            head = np.uint64(len(data)).tobytes()
            f.write(head + np.uint32(_masked_crc(head)).tobytes())
            f.write(data + np.uint32(_masked_crc(data)).tobytes())
    rows = list(rd.read_tfrecords(str(out)).iter_rows())
    assert [r["a"] for r in rows] == [1, 3]
    assert rows[0]["b"] == 2 and rows[1]["b"] is None

    # Ragged list features stay LISTS for every record of the column
    # (no scalar-vs-list mixing when some records have length 1).
    out2 = tmp_path / "ragged.tfrecords"
    with open(out2, "wb") as f:
        for row in [{"ids": [7]}, {"ids": [3, 4]}]:
            data = encode_example(row)
            head = np.uint64(len(data)).tobytes()
            f.write(head + np.uint32(_masked_crc(head)).tobytes())
            f.write(data + np.uint32(_masked_crc(data)).tobytes())
    ragged = list(rd.read_tfrecords(str(out2)).iter_rows())
    assert ragged[0]["ids"] == [7] and ragged[1]["ids"] == [3, 4]

    # Corruption is loud, not silent.
    blob = out.read_bytes()
    (out.parent / "bad.tfrecords").write_bytes(blob[:-6])  # truncated
    with pytest.raises(Exception, match="truncated|corrupt"):
        list(rd.read_tfrecords(str(out.parent / "bad.tfrecords"))
             .iter_rows())


def test_read_images_skips_non_image_files(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    Image.new("RGB", (4, 4)).save(tmp_path / "ok.png")
    (tmp_path / "README.txt").write_text("not an image")
    assert rd.read_images(str(tmp_path)).count() == 1


def test_read_sql_sqlite(tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE t (id INTEGER, name TEXT)")
    conn.executemany("INSERT INTO t VALUES (?, ?)",
                     [(i, f"row{i}") for i in range(10)])
    conn.commit()
    conn.close()

    ds = rd.read_sql("SELECT id, name FROM t WHERE id < 5",
                     lambda: sqlite3.connect(db))
    rows = sorted(ds.iter_rows(), key=lambda r: r["id"])
    assert len(rows) == 5 and rows[4]["name"] == "row4"


def test_read_images(tmp_path):
    PIL = pytest.importorskip("PIL")  # noqa: F841
    from PIL import Image

    for i in range(3):
        Image.new("RGB", (8, 6), color=(i * 10, 0, 0)).save(
            tmp_path / f"img{i}.png")
    ds = rd.read_images(str(tmp_path), size=(4, 4), include_paths=True)
    batches = list(ds.iter_batches(batch_size=None))
    imgs = np.concatenate([b["image"] for b in batches])
    assert imgs.shape == (3, 4, 4, 3)
    assert ds.count() == 3


def test_bounded_memory_streaming():
    """Memory-budgeted backpressure (reference: streaming_executor.py:48
    byte-bounded output queues): streaming a dataset ~10x larger than
    the budget keeps buffered stage output within budget + one
    in-flight window, regardless of how slowly the consumer drains."""
    from ray_tpu_torch.data.dataset import DataContext

    ctx = DataContext.get_current()
    old = (ctx.use_tasks, ctx.parallelism, ctx.target_max_bytes_in_flight)
    block_bytes = 100 * 1000 * 8  # 100k int64 rows per block
    try:
        ctx.use_tasks = False
        ctx.parallelism = 4
        ctx.target_max_bytes_in_flight = 4 * block_bytes  # dataset is 10x
        ds = rd.range(40 * 100 * 1000, parallelism=40)  # 40 blocks
        total = 0
        for batch in ds.iter_batches(batch_size=50 * 1000):
            total += len(batch["id"])
        assert total == 40 * 100 * 1000
        peak = ctx.stats.get("max_bytes_buffered", 0)
        assert peak > 0
        # Budget + the parallelism in-flight overshoot window.
        assert peak <= ctx.target_max_bytes_in_flight + \
            ctx.parallelism * block_bytes, peak
    finally:
        ctx.use_tasks, ctx.parallelism, ctx.target_max_bytes_in_flight = old


def test_zero_copy_batches_are_views():
    """zero_copy_batch=True hands out slices of the source blocks
    (numpy views / arrow slices) when a batch is one contiguous run —
    no bytes copied; the default path still copies."""
    ds = rd.range_tensor(1000, shape=(4,), parallelism=4)  # 250-row blocks
    zc = list(ds.iter_batches(batch_size=125, zero_copy_batch=True))
    assert all(b["data"].base is not None for b in zc)  # views
    assert sum(len(b["data"]) for b in zc) == 1000
    copied = list(ds.iter_batches(batch_size=125))
    assert all(b["data"].base is None for b in copied)  # owned copies
    # Values identical either way.
    assert np.array_equal(zc[0]["data"], copied[0]["data"])


def test_iter_batches_shapes_and_drop_last():
    ds = rd.range(70)
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32)]
    assert sizes == [32, 32, 6]
    sizes = [len(b["id"]) for b in ds.iter_batches(batch_size=32, drop_last=True)]
    assert sizes == [32, 32]


@pytest.mark.parametrize("dtypes", [None, "float32", {"id": "bfloat16"}])
def test_iter_torch_batches_device_and_dtypes(dtypes):
    """The port's iter_torch_batches (in place of iter_jax_batches):
    tensors on ``device`` cast by ``dtypes``, one dtype for every column
    or a dict; object columns stay numpy."""
    import torch

    dt = ({k: getattr(torch, v) for k, v in dtypes.items()} if isinstance(dtypes, dict)
          else getattr(torch, dtypes) if dtypes else None)
    ds = rd.range(16).add_column("name", lambda c: np.array([str(i) for i in c["id"]],
                                                            dtype=object))
    batches = list(ds.iter_torch_batches(batch_size=8, device="cpu", dtypes=dt))
    assert len(batches) == 2
    want = {None: torch.int64, "float32": torch.float32}.get(dtypes, torch.bfloat16) \
        if not isinstance(dtypes, dict) else torch.bfloat16
    assert batches[1]["id"].dtype == want and batches[1]["id"].device.type == "cpu"
    assert batches[1]["id"].tolist() == list(range(8, 16))
    assert list(batches[0]["name"]) == [str(i) for i in range(8)]
    shard = ds.streaming_split(1)[0]
    assert next(shard.iter_torch_batches(batch_size=4, device="cpu"))["id"].tolist() == [0, 1, 2, 3]


def test_iter_torch_batches():
    import torch

    b = next(rd.range(8).iter_torch_batches(batch_size=8, device="cpu"))
    assert isinstance(b["id"], torch.Tensor)


def test_streaming_split_covers_all_rows():
    ds = rd.range(100, parallelism=10)
    shards = ds.streaming_split(3)
    seen = []
    for s in shards:
        seen.extend(r["id"] for r in s.iter_rows())
    assert sorted(seen) == list(range(100))
    assert all(s.count() > 0 for s in shards)


def test_split_materializes_evenly():
    parts = rd.range(10).split(2)
    assert [p.count() for p in parts] == [5, 5]


# ---------------------------------------------------------------------------
# IO roundtrips


def test_parquet_roundtrip(tmp_path):
    ds = rd.from_numpy({"a": np.arange(20), "b": np.arange(20) * 1.5})
    ds.write_parquet(str(tmp_path / "pq"))
    back = rd.read_parquet(str(tmp_path / "pq"))
    assert back.count() == 20
    assert back.sort("a").take(1) == [{"a": 0, "b": 0.0}]


def test_csv_roundtrip(tmp_path):
    rd.from_numpy({"x": np.arange(5)}).write_csv(str(tmp_path / "csv"))
    back = rd.read_csv(str(tmp_path / "csv"))
    assert [r["x"] for r in back.sort("x").take_all()] == [0, 1, 2, 3, 4]


def test_json_write_text_read(tmp_path):
    rd.from_items([{"m": 1}, {"m": 2}]).write_json(str(tmp_path / "j"))
    back = rd.read_json(str(tmp_path / "j"))
    assert sorted(r["m"] for r in back.take_all()) == [1, 2]
    p = tmp_path / "t.txt"
    p.write_text("hello\n\nworld\n")
    assert [r["text"] for r in rd.read_text(str(p)).take_all()] == ["hello", "world"]


def test_read_numpy_and_binary(tmp_path):
    np.save(tmp_path / "arr.npy", np.arange(6).reshape(2, 3))
    ds = rd.read_numpy(str(tmp_path / "arr.npy"))
    assert ds.take_all()[0]["data"].shape == (3,) or ds.count() == 2
    (tmp_path / "blob.bin").write_bytes(b"\x01\x02")
    bd = rd.read_binary_files(str(tmp_path / "blob.bin"), include_paths=True)
    row = bd.take_all()[0]
    assert row["bytes"] == b"\x01\x02"


# ---------------------------------------------------------------------------
# distributed execution + Train integration


def test_distributed_map_batches_over_cluster(mode):
    ds = rd.range(40, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "pid": np.full(len(b["id"]), os.getpid())}
    )
    rows = ds.take_all()
    assert sorted(r["id"] for r in rows) == list(range(40))
    # On the cluster the stages ran in worker processes, not the driver.
    assert all((r["pid"] != os.getpid()) == (mode == "cluster") for r in rows)


def _shard_sums(config):
    from ray_tpu_torch import train

    shard = train.get_dataset_shard("train")
    ids = [int(i) for b in shard.iter_torch_batches(batch_size=8, device="cpu")
           for i in b["id"]]
    train.report({"ids": ids, "rank": train.get_context().get_world_rank()})


def test_trainer_consumes_streaming_split(tmp_path):
    """TorchTrainer(datasets=...) hands each worker its streaming_split
    shard through get_dataset_shard (device="cpu")."""
    from ray_tpu_torch import train

    result = train.TorchTrainer(
        _shard_sums,
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="data_split", storage_path=str(tmp_path)),
        backend_config=train.TorchConfig(device="cpu"),
        datasets={"train": rd.range(20, parallelism=4)},
    ).fit()
    assert result.error is None
    # Rank 0 reports; its shard is blocks 0 and 2 of the 4 (5 rows each).
    assert result.metrics["rank"] == 0
    assert result.metrics["ids"] == list(range(0, 5)) + list(range(10, 15))


def test_bc_trains_on_a_port_dataset():
    """BC's offline data as a port Dataset of row dicts (take_all)."""
    from ray_tpu_torch.rllib import BCConfig

    rng = np.random.default_rng(0)
    obs = rng.standard_normal((64, 4)).astype(np.float32)
    ds = rd.from_items([{"obs": o, "actions": int(o[0] > 0)} for o in obs])
    algo = (BCConfig().environment(observation_dim=4, action_dim=2)
            .learners(device="cpu").training(train_batch_size=32).offline(ds).build())
    first = algo.train()["total_loss"]
    for _ in range(5):
        last = algo.train()["total_loss"]
    assert np.isfinite(last) and last < first
    algo.stop()


# ---------------------------------------------------------------------------
# round-3 datasources: avro, webdataset, refs, tf


def _zigzag(n: int) -> bytes:
    # Independent encoder (not the reader's code) per the Avro 1.11 spec.
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_bytes(b: bytes) -> bytes:
    return _zigzag(len(b)) + b


def _write_avro(path, rows, codec=b"null"):
    import json
    import struct
    import zlib

    schema = {
        "type": "record", "name": "R",
        "fields": [
            {"name": "id", "type": "long"},
            {"name": "name", "type": "string"},
            {"name": "score", "type": "double"},
            {"name": "tags", "type": {"type": "array", "items": "string"}},
            {"name": "opt", "type": ["null", "long"]},
        ],
    }
    body = bytearray()
    for r in rows:
        body += _zigzag(r["id"])
        body += _avro_bytes(r["name"].encode())
        body += struct.pack("<d", r["score"])
        if r["tags"]:
            body += _zigzag(len(r["tags"]))
            for t in r["tags"]:
                body += _avro_bytes(t.encode())
        body += _zigzag(0)  # array terminator
        if r["opt"] is None:
            body += _zigzag(0)
        else:
            body += _zigzag(1) + _zigzag(r["opt"])
    payload = bytes(body)
    if codec == b"deflate":
        payload = zlib.compress(payload)[2:-4]  # raw deflate
    sync = b"S" * 16
    meta = (_zigzag(2)
            + _avro_bytes(b"avro.schema")
            + _avro_bytes(json.dumps(schema).encode())
            + _avro_bytes(b"avro.codec") + _avro_bytes(codec)
            + _zigzag(0))
    with open(path, "wb") as f:
        f.write(b"Obj\x01" + meta + sync)
        f.write(_zigzag(len(rows)) + _zigzag(len(payload)) + payload + sync)


ROWS = [
    {"id": 1, "name": "a", "score": 0.5, "tags": ["x", "y"], "opt": None},
    {"id": -7, "name": "bb", "score": -2.25, "tags": [], "opt": 42},
    {"id": 2**40, "name": "", "score": 0.0, "tags": ["z"], "opt": -1},
]


@pytest.mark.parametrize("codec", [b"null", b"deflate"])
def test_read_avro(tmp_path, codec):
    p = str(tmp_path / "f.avro")
    _write_avro(p, ROWS, codec=codec)
    got = rd.read_avro(p).take_all()
    assert got == ROWS


def test_read_webdataset(tmp_path):
    import io
    import json
    import tarfile

    p = str(tmp_path / "shard-000.tar")
    with tarfile.open(p, "w") as tf:
        for key, cls, meta in [("s1", 3, {"a": 1}), ("s2", 9, {"b": 2})]:
            for ext, payload in [
                ("jpg", b"\xff\xd8fakejpeg"),
                ("cls", str(cls).encode()),
                ("json", json.dumps(meta).encode()),
                ("txt", f"caption of {key}".encode()),
            ]:
                data = payload
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    rows = rd.read_webdataset(p).take_all()
    assert [r["__key__"] for r in rows] == ["s1", "s2"]
    assert rows[0]["cls"] == 3 and rows[1]["cls"] == 9
    assert rows[0]["json"] == {"a": 1}
    assert rows[0]["txt"] == "caption of s1"
    assert rows[0]["jpg"].startswith(b"\xff\xd8")  # raw bytes kept


def test_from_refs_and_blocks():
    import numpy as np
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"x": [1, 2, 3]})
    tbl = pa.Table.from_pandas(pd.DataFrame({"x": [4, 5]}),
                               preserve_index=False)
    arr = np.arange(4)
    ds = rd.from_pandas_refs([rt.put(df)])
    assert [r["x"] for r in ds.take_all()] == [1, 2, 3]
    ds = rd.from_arrow_refs([rt.put(tbl)])
    assert [r["x"] for r in ds.take_all()] == [4, 5]
    ds = rd.from_numpy_refs([rt.put(arr)])
    assert [r["data"] for r in ds.take_all()] == [0, 1, 2, 3]
    ds = rd.from_blocks([{"x": np.array([7, 8])}])
    assert [r["x"] for r in ds.take_all()] == [7, 8]


def test_from_tf():
    tf = pytest.importorskip("tensorflow")
    tfds = tf.data.Dataset.from_tensor_slices({"a": [1, 2, 3],
                                               "b": [4.0, 5.0, 6.0]})
    ds = rd.from_tf(tfds)
    rows = ds.take_all()
    assert [int(r["a"]) for r in rows] == [1, 2, 3]
    assert [float(r["b"]) for r in rows] == [4.0, 5.0, 6.0]


def test_webdataset_heterogeneous_and_dirs(tmp_path):
    import io
    import tarfile

    p = str(tmp_path / "s.tar")
    with tarfile.open(p, "w") as tf:
        # a/0001 and b/0001: same basename, different dirs = 2 samples;
        # only a/ has a txt (optional field).
        for name, data in [("a/0001.jpg", b"ja"), ("a/0001.txt", b"ca"),
                           ("b/0001.jpg", b"jb")]:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    rows = rd.read_webdataset(p).take_all()
    assert [r["__key__"] for r in rows] == ["a/0001", "b/0001"]
    assert rows[0]["jpg"] == b"ja" and rows[1]["jpg"] == b"jb"
    assert rows[0]["txt"] == "ca" and rows[1]["txt"] is None


def test_avro_namespaced_named_types(tmp_path):
    import json
    import struct

    # Record with an enum referenced by FULLNAME (what most writers emit).
    schema = {
        "type": "record", "name": "R", "namespace": "com.x",
        "fields": [
            {"name": "color",
             "type": {"type": "enum", "name": "Color",
                      "symbols": ["RED", "BLUE"]}},
            {"name": "again", "type": "com.x.Color"},
        ],
    }
    body = _zigzag(0) + _zigzag(1) + _zigzag(1) + _zigzag(0)  # RED,BLUE,BLUE,RED
    sync = b"S" * 16
    meta = (_zigzag(2)
            + _avro_bytes(b"avro.schema")
            + _avro_bytes(json.dumps(schema).encode())
            + _avro_bytes(b"avro.codec") + _avro_bytes(b"null")
            + _zigzag(0))
    p = str(tmp_path / "ns.avro")
    with open(p, "wb") as f:
        f.write(b"Obj\x01" + meta + sync)
        f.write(_zigzag(2) + _zigzag(len(body)) + body + sync)
    rows = rd.read_avro(p).take_all()
    assert rows == [{"color": "RED", "again": "BLUE"},
                    {"color": "BLUE", "again": "RED"}]


def test_split_at_indices_and_train_test_split():
    ds = rd.range(10)
    parts = ds.split_at_indices([3, 7])
    assert [p.count() for p in parts] == [3, 4, 3]
    assert [r["id"] for r in parts[1].take_all()] == [3, 4, 5, 6]
    train, test = rd.range(8).train_test_split(test_size=0.25)
    assert train.count() == 6 and test.count() == 2
    assert [r["id"] for r in test.take_all()] == [6, 7]
    train, test = rd.range(8).train_test_split(test_size=3, shuffle=True,
                                               seed=0)
    assert train.count() == 5 and test.count() == 3
    ids = sorted(r["id"] for r in train.take_all()) + sorted(
        r["id"] for r in test.take_all())
    assert sorted(ids) == list(range(8))
    with pytest.raises(ValueError):
        rd.range(4).train_test_split(test_size=1.5)


def test_random_sample_and_take_batch():
    ds = rd.range(2000)
    got = ds.random_sample(0.25, seed=7).count()
    assert 350 < got < 650  # ~500 expected
    assert rd.range(5).random_sample(0.0).count() == 0
    batch = rd.range(100).take_batch(8)
    assert list(batch["id"]) == list(range(8))


def test_iter_tf_batches():
    tf = pytest.importorskip("tensorflow")
    batches = list(rd.range(10).iter_tf_batches(batch_size=4))
    assert [int(b["id"].shape[0]) for b in batches] == [4, 4, 2]
    assert batches[0]["id"].dtype == tf.int64


def test_dataset_stats():
    ds = rd.range(1000).map_batches(lambda b: {"id": b["id"] * 2})
    assert "iterate" in ds.stats()
    total = ds.sum("id")
    assert total == 999000
    s = ds.stats()
    assert "1000 rows" in s and "rows/s" in s


# ---------------------------------------------------------------------------
# actor pools (tests/test_data_actor_pool.py)


class AddBias:
    """Class UDF with observable construction cost/count."""

    def __init__(self, bias=100):
        self.bias = bias
        self.pid = os.getpid()

    def __call__(self, batch):
        return {"id": batch["id"] + self.bias,
                "pid": np.full_like(batch["id"], self.pid)}


def test_pool_runs_class_udf():
    ds = rd.range(200).map_batches(
        AddBias, batch_size=20, compute="actors")
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == [i + 100 for i in range(200)]


def test_constructor_amortized_across_blocks():
    """One pool worker handles many blocks through ONE instance: the
    reported pids collapse to at most pool-size distinct values."""
    ds = rd.range(400).map_batches(
        AddBias, batch_size=10,
        compute=rd.ActorPoolStrategy(min_size=1, max_size=2))
    pids = {int(r["pid"]) for r in ds.take_all()}
    assert 1 <= len(pids) <= 2  # 40 blocks, <= 2 workers


def test_pool_scales_up_under_backlog(mode):
    ctx = rd.DataContext.get_current()
    (ctx.stats or {}).pop("actor_pool", None)
    ds = rd.range(300).map_batches(
        AddBias, batch_size=10,
        compute=rd.ActorPoolStrategy(min_size=1, max_size=3))
    if mode == "inline":  # no pool: the class UDF runs in the driver
        with pytest.warns(UserWarning, match="runs inline"):
            out = ds.take_all()
        assert len(out) == 300 and {int(r["pid"]) for r in out} == {os.getpid()}
        return
    out = ds.take_all()
    assert len(out) == 300
    stats = (ctx.stats or {}).get("actor_pool")
    assert stats and stats["spawned"] >= 1
    assert stats["peak_size"] <= 3


class VisibleDevices:
    def __call__(self, batch):
        seen = os.environ.get("CUDA_VISIBLE_DEVICES", "unset")
        return {"visible": np.array([seen] * len(batch["id"]), dtype=object)}


def test_gpu_lease_pins_a_pool_worker_to_one_card(mode):
    """resources={"GPU": 1} leases a card to each pool worker, which then
    sees exactly that device (CUDA_VISIBLE_DEVICES), as num_gpus=1 does;
    build_llm_processor's pool asks for this lease."""
    ds = rd.range(40).map_batches(
        VisibleDevices, batch_size=10,
        compute=rd.ActorPoolStrategy(min_size=1, max_size=2, resources={"GPU": 1}))
    if mode == "inline":
        with pytest.warns(UserWarning, match="runs inline"):
            rows = ds.take_all()
        assert {r["visible"] for r in rows} == {os.environ.get("CUDA_VISIBLE_DEVICES", "unset")}
        return
    assert {r["visible"] for r in ds.take_all()} <= {"0", "1"}



class CrashOnce:
    """Dies on the first block of a fresh process (pool must replace
    the worker and replay the block); ``mark`` is a file of the test's
    own temporary directory."""

    def __init__(self, mark):
        self.mark = mark

    def __call__(self, batch):
        if not os.path.exists(self.mark):
            with open(self.mark, "w") as f:
                f.write("x")
            os._exit(1)
        return {"id": batch["id"] * 2}


@pytest.mark.parametrize("mode", ["cluster"], indirect=True)  # inline would kill the test
def test_restart_on_death_replays_block(mode, tmp_path):
    ds = rd.range(60).map_batches(
        CrashOnce, batch_size=10, fn_constructor_args=(str(tmp_path / "crashed"),),
        compute=rd.ActorPoolStrategy(min_size=1, max_size=1,
                                     max_restarts=2))
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == [i * 2 for i in range(60)]
    assert os.path.exists(tmp_path / "crashed")


def test_plain_fn_with_compute_rejected():
    with pytest.raises(ValueError, match="CLASS UDF"):
        rd.range(10).map_batches(lambda b: b, compute="actors")


# ---------------------------------------------------------------------------
# preprocessors (tests/test_data_preprocessors.py)


def _col(ds, c):
    return np.asarray([r[c] for r in ds.take_all()])


def test_standard_scaler_fit_transform():
    ds = rd.from_items([{"x": float(i), "y": float(i * 10)}
                        for i in range(10)])
    sc = StandardScaler(["x"])
    out = sc.fit_transform(ds)
    xs = _col(out, "x")
    assert abs(xs.mean()) < 1e-9 and abs(xs.std() - 1.0) < 1e-9
    assert _col(out, "y")[3] == 30.0  # untouched column

    # Serving-time batch path matches the dataset path.
    b = sc.transform_batch({"x": np.arange(10.0), "y": np.zeros(10)})
    np.testing.assert_allclose(b["x"], xs, rtol=1e-12)


def test_unfitted_raises():
    sc = StandardScaler(["x"])
    with pytest.raises(PreprocessorNotFittedException):
        sc.transform(rd.range(3))
    # Stateless preprocessors never require fit.
    c = Concatenator(["id"], output_column_name="f")
    assert "f" in c.transform_batch({"id": np.arange(4)})


def test_min_max_and_robust_scalers():
    ds = rd.from_items([{"x": float(v)} for v in [0, 5, 10]])
    mm = MinMaxScaler(["x"]).fit(ds)
    np.testing.assert_allclose(
        mm.transform_batch({"x": np.array([0.0, 5.0, 10.0])})["x"],
        [0.0, 0.5, 1.0])

    rb = RobustScaler(["x"]).fit(
        rd.from_items([{"x": float(v)} for v in range(1, 102)]))
    out = rb.transform_batch({"x": np.array([51.0])})
    assert abs(out["x"][0]) < 1e-9  # median maps to 0


def test_label_and_ordinal_encoders():
    ds = rd.from_items([{"cls": c, "f": c} for c in
                        ["cat", "dog", "cat", "bird"]])
    le = LabelEncoder("cls").fit(ds)
    enc = le.transform_batch({"cls": np.array(["bird", "cat", "dog"])})
    assert enc["cls"].tolist() == [0, 1, 2]  # sorted-unique codes
    dec = le.inverse_transform_batch(enc)
    assert dec["cls"].tolist() == ["bird", "cat", "dog"]
    with pytest.raises(ValueError, match="unseen"):
        le.transform_batch({"cls": np.array(["fish"])})

    oe = OrdinalEncoder(["f"]).fit(ds)
    assert oe.transform_batch(
        {"f": np.array(["dog", "bird"])})["f"].tolist() == [2, 0]


def test_one_hot_encoder():
    ds = rd.from_items([{"c": v} for v in ["a", "b", "a"]])
    oh = OneHotEncoder(["c"]).fit(ds)
    out = oh.transform_batch({"c": np.array(["b", "a", "zzz"])})
    assert "c" not in out
    assert out["c_a"].tolist() == [0, 1, 0]
    assert out["c_b"].tolist() == [1, 0, 0]  # unseen -> all-zero row


def test_simple_imputer_strategies():
    ds = rd.from_items([{"x": v} for v in [1.0, np.nan, 3.0]])
    mean = SimpleImputer(["x"], strategy="mean").fit(ds)
    assert mean.transform_batch(
        {"x": np.array([np.nan])})["x"][0] == 2.0
    const = SimpleImputer(["x"], strategy="constant", fill_value=-1.0)
    assert const.transform_batch(
        {"x": np.array([np.nan, 5.0])})["x"].tolist() == [-1.0, 5.0]
    with pytest.raises(ValueError):
        SimpleImputer(["x"], strategy="constant")


def test_concatenator_and_normalizer():
    out = Concatenator(["a", "b"], output_column_name="feat").\
        transform_batch({"a": np.array([1.0, 2.0]),
                         "b": np.array([3.0, 4.0]),
                         "keep": np.array([9, 9])})
    assert out["feat"].shape == (2, 2) and out["feat"].dtype == np.float32
    assert "a" not in out and "keep" in out

    nm = Normalizer(["a", "b"], norm="l2").transform_batch(
        {"a": np.array([3.0]), "b": np.array([4.0])})
    np.testing.assert_allclose([nm["a"][0], nm["b"][0]], [0.6, 0.8])


def test_discretizer_bins():
    ds = rd.from_items([{"x": float(v)} for v in range(100)])
    kb = UniformKBinsDiscretizer(["x"], bins=4).fit(ds)
    out = kb.transform_batch({"x": np.array([0.0, 30.0, 60.0, 99.0])})
    assert out["x"].tolist() == [0, 1, 2, 3]
    # NaN must not silently become the top bin.
    with pytest.raises(ValueError, match="NaN"):
        kb.transform_batch({"x": np.array([np.nan])})


def test_nan_in_fit_column_does_not_poison_stats():
    """A NaN at FIT time must not corrupt stats (NaN stats silently
    zeroed columns via the zero-variance branch / top-binned all
    values). Fit aggregates are nan-aware like the reference's
    null-skipping aggregates."""
    ds = rd.from_items([{"x": v} for v in [1.0, np.nan, 3.0]])
    sc = StandardScaler(["x"]).fit(ds)
    out = sc.transform_batch({"x": np.array([1.0, 3.0])})
    np.testing.assert_allclose(out["x"], [-1.0, 1.0])
    mm = MinMaxScaler(["x"]).fit(ds)
    np.testing.assert_allclose(
        mm.transform_batch({"x": np.array([1.0, 3.0])})["x"], [0.0, 1.0])
    kb = UniformKBinsDiscretizer(["x"], bins=2).fit(ds)
    assert kb.transform_batch(
        {"x": np.array([1.0, 3.0])})["x"].tolist() == [0, 1]


def test_imputer_categorical_most_frequent_and_constant():
    ds = rd.from_items([{"c": v} for v in
                        ["sf", "sf", None, "nyc", None]])
    mf = SimpleImputer(["c"], strategy="most_frequent").fit(ds)
    out = mf.transform_batch({"c": np.array(["nyc", None], dtype=object)})
    assert out["c"].tolist() == ["nyc", "sf"]
    const = SimpleImputer(["c"], strategy="constant",
                          fill_value="unknown")
    out2 = const.transform_batch({"c": np.array([None, "sf"],
                                                dtype=object)})
    assert out2["c"].tolist() == ["unknown", "sf"]


def test_stateless_chain_needs_no_fit():
    ch = Chain(Normalizer(["a", "b"]),
               Concatenator(["a", "b"], output_column_name="f"))
    out = ch.transform_batch({"a": np.array([3.0]),
                              "b": np.array([4.0])})
    np.testing.assert_allclose(out["f"], [[0.6, 0.8]])


def test_chain_fits_each_stage_on_prior_output():
    ds = rd.from_items([{"x": float(i), "c": ["a", "b"][i % 2]}
                        for i in range(8)])
    chain = Chain(
        StandardScaler(["x"]),
        OneHotEncoder(["c"]),
        Concatenator(["x", "c_a", "c_b"], output_column_name="features"),
    )
    out = chain.fit_transform(ds)
    rows = out.take_all()
    assert set(rows[0]) == {"features"}
    assert rows[0]["features"].shape == (3,)
    # The batch path composes identically.
    b = chain.transform_batch({"x": np.array([0.0]),
                               "c": np.array(["a"])})
    assert b["features"].shape == (1, 3)


def test_fitted_preprocessor_travels_to_train_workers(tmp_path):
    """The fit-on-driver / transform-on-worker flow Train uses
    (reference: preprocessors serialized into Train checkpoints)."""
    ds = rd.from_items([{"x": float(i)} for i in range(16)])
    sc = StandardScaler(["x"]).fit(ds)

    @rt.remote
    def worker_transform(p: Preprocessor, xs):
        return p.transform_batch({"x": np.asarray(xs)})["x"].mean()

    m = rt.get(worker_transform.remote(sc, list(range(16))), timeout=T)
    assert abs(m) < 1e-9


def test_tokenizer_and_count_vectorizer():
    from ray_tpu_torch.data.preprocessors import CountVectorizer, Tokenizer

    ds = rd.from_items([{"text": "the cat sat"},
                        {"text": "the dog SAT!"}])
    tok = Tokenizer(["text"]).transform_batch(
        {"text": np.array(["Hello, World"], dtype=object)})
    assert tok["text"][0] == ["hello", "world"]

    cv = CountVectorizer(["text"]).fit(ds)
    out = cv.transform_batch({"text": np.array(["the the cat"],
                                               dtype=object)})
    assert "text" not in out
    assert out["text_the"].tolist() == [2]
    assert out["text_cat"].tolist() == [1]
    assert out["text_dog"].tolist() == [0]

    top = CountVectorizer(["text"], max_features=2).fit(ds)
    # 'the' (2) and 'sat' (2) are the top-2 tokens.
    cols = [k for k in top.transform_batch(
        {"text": np.array(["x"], dtype=object)}) if k.startswith("text_")]
    assert sorted(cols) == ["text_sat", "text_the"]


def test_feature_hasher_and_hashing_vectorizer():
    from ray_tpu_torch.data.preprocessors import (FeatureHasher,
                                            HashingVectorizer, Tokenizer)

    hv = HashingVectorizer(["text"], num_features=16)
    out = hv.transform_batch({"text": np.array(["cat cat dog"],
                                               dtype=object)})
    mat = out["text_hashed"]
    assert mat.shape == (1, 16) and mat.sum() == 3.0 and mat.max() == 2.0

    fh = Chain(Tokenizer(["text"]),
               FeatureHasher(["text"], num_features=8))
    out2 = fh.transform_batch({"text": np.array(["a b a"], dtype=object)})
    assert out2["hashed_features"].shape == (1, 8)
    assert out2["hashed_features"].sum() == 3.0


def test_maxabs_multihot_power():
    from ray_tpu_torch.data.preprocessors import (MaxAbsScaler, MultiHotEncoder,
                                            PowerTransformer)

    ds = rd.from_items([{"x": v} for v in [-4.0, 2.0]])
    ma = MaxAbsScaler(["x"]).fit(ds)
    np.testing.assert_allclose(
        ma.transform_batch({"x": np.array([-4.0, 2.0])})["x"], [-1.0, 0.5])

    genres = rd.from_items([{"g": ["scifi", "drama"]},
                            {"g": ["drama"]}])
    mh = MultiHotEncoder(["g"]).fit(genres)
    out = mh.transform_batch({"g": np.array([["drama", "drama"],
                                             ["scifi"]], dtype=object)})
    assert out["g"].tolist() == [[2, 0], [0, 1]]  # cols: drama, scifi

    pt = PowerTransformer(["x"], power=0.0, method="box-cox")
    np.testing.assert_allclose(
        pt.transform_batch({"x": np.array([1.0, np.e])})["x"], [0.0, 1.0])
    yj = PowerTransformer(["x"], power=1.0)
    np.testing.assert_allclose(
        yj.transform_batch({"x": np.array([-1.0, 0.0, 3.0])})["x"],
        [-1.0, 0.0, 3.0])
    with pytest.raises(ValueError, match="positive"):
        pt.transform_batch({"x": np.array([-1.0])})
