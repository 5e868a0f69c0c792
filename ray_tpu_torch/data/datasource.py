"""Datasources: read tasks over files/ranges (reference analogue:
python/ray/data/datasource/ — parquet, csv, json, text, numpy, binary;
port of ray_tpu/data/datasource.py).

A datasource yields ``ReadTask``s — serializable zero-arg callables, each
producing an iterator of blocks. One task per file (or per range shard)
is the parallelism unit the executor schedules over the cluster.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, Iterator

import numpy as np

from ray_tpu_torch.data.block import Block, BlockMetadata


class ReadTask:
    def __init__(self, fn: Callable[[], Iterator[Block]],
                 metadata: BlockMetadata | None = None):
        self._fn = fn
        self.metadata = metadata or BlockMetadata(None, None)

    def __call__(self) -> Iterator[Block]:
        return self._fn()


def _expand_paths(paths) -> list[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(
                    os.path.join(root, f) for f in sorted(files)
                    if not f.startswith((".", "_"))
                )
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


def range_tasks(n: int, parallelism: int) -> list[ReadTask]:
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    tasks = []
    for i in range(0, n, per):
        lo, hi = i, min(i + per, n)

        def fn(lo=lo, hi=hi):
            yield {"id": np.arange(lo, hi, dtype=np.int64)}

        tasks.append(ReadTask(fn, BlockMetadata(hi - lo, (hi - lo) * 8)))
    return tasks


def range_tensor_tasks(n: int, shape: tuple, parallelism: int) -> list[ReadTask]:
    parallelism = max(1, min(parallelism, n or 1))
    per = (n + parallelism - 1) // parallelism
    tasks = []
    for i in range(0, n, per):
        lo, hi = i, min(i + per, n)

        def fn(lo=lo, hi=hi):
            base = np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * len(shape))
            yield {"data": np.broadcast_to(base, (hi - lo,) + tuple(shape)).copy()}

        size = (hi - lo) * int(np.prod(shape)) * 8
        tasks.append(ReadTask(fn, BlockMetadata(hi - lo, size)))
    return tasks


def _file_tasks(paths, reader: Callable[[str], Iterator[Block]]) -> list[ReadTask]:
    tasks = []
    for path in _expand_paths(paths):
        def fn(path=path):
            return reader(path)

        meta = BlockMetadata(
            None, os.path.getsize(path) if os.path.exists(path) else None,
            input_files=[path],
        )
        tasks.append(ReadTask(fn, meta))
    return tasks


def parquet_tasks(paths, columns=None) -> list[ReadTask]:
    def read(path):
        import pyarrow.parquet as pq

        f = pq.ParquetFile(path)
        for batch in f.iter_batches(columns=columns):
            import pyarrow as pa

            yield pa.Table.from_batches([batch])

    return _file_tasks(paths, read)


def csv_tasks(paths, **csv_kwargs) -> list[ReadTask]:
    def read(path):
        import pyarrow.csv as pacsv

        yield pacsv.read_csv(path, **csv_kwargs)

    return _file_tasks(paths, read)


def json_tasks(paths) -> list[ReadTask]:
    def read(path):
        import pyarrow.json as pajson

        yield pajson.read_json(path)

    return _file_tasks(paths, read)


def text_tasks(paths, *, drop_empty_lines: bool = True) -> list[ReadTask]:
    def read(path):
        with open(path, "r", errors="replace") as f:
            lines = [ln.rstrip("\n") for ln in f]
        if drop_empty_lines:
            lines = [ln for ln in lines if ln]
        yield {"text": np.asarray(lines, dtype=object)}

    return _file_tasks(paths, read)


def numpy_tasks(paths) -> list[ReadTask]:
    def read(path):
        arr = np.load(path, allow_pickle=False)
        yield {"data": arr}

    return _file_tasks(paths, read)


def binary_tasks(paths, *, include_paths: bool = False) -> list[ReadTask]:
    def read(path):
        with open(path, "rb") as f:
            data = f.read()
        block = {"bytes": np.asarray([data], dtype=object)}
        if include_paths:
            block["path"] = np.asarray([path], dtype=object)
        yield block

    return _file_tasks(paths, read)


# -- TFRecord (pure Python: framing + tf.train.Example codec) ---------------
#
# Reference: data read_tfrecords/write_tfrecords (read_api.py), which lean
# on TensorFlow. TF is not a dependency here, so both the record
# framing (length + masked CRC32C) and the tf.train.Example protobuf are
# implemented directly — the format is small and stable.

_CRC32C_TABLE = None
_NATIVE_CRC32C = None


def _crc32c(data: bytes) -> int:
    global _CRC32C_TABLE, _NATIVE_CRC32C
    if _NATIVE_CRC32C is None:
        # Per-byte Python CRC is the write-path bottleneck on big
        # datasets: prefer a native implementation when one is baked in.
        try:
            import crc32c as _c  # type: ignore

            _NATIVE_CRC32C = _c.crc32c
        except ImportError:
            try:
                import google_crc32c as _g  # type: ignore

                _NATIVE_CRC32C = lambda d: int.from_bytes(  # noqa: E731
                    _g.Checksum(d).digest(), "big")
            except ImportError:
                _NATIVE_CRC32C = False
    if _NATIVE_CRC32C:
        return _NATIVE_CRC32C(data)
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited field
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_example(row: dict) -> bytes:
    """dict -> serialized tf.train.Example. Columns map to the standard
    feature kinds: bytes/str -> bytes_list, floats -> float_list (packed
    f32), ints -> int64_list (packed varints)."""
    import struct

    feats = b""
    for key, val in row.items():
        arr = np.atleast_1d(np.asarray(val))
        if arr.dtype.kind in ("S", "U", "O"):
            payload = b"".join(
                _ld(1, v if isinstance(v, bytes) else str(v).encode())
                for v in arr.tolist())
            feature = _ld(1, payload)  # Feature.bytes_list
        elif arr.dtype.kind == "f":
            packed = struct.pack(f"<{arr.size}f",
                                 *arr.astype(np.float32).ravel().tolist())
            feature = _ld(2, _ld(1, packed))  # Feature.float_list (packed)
        else:
            packed = b"".join(_varint(int(v) & (1 << 64) - 1)
                              for v in arr.ravel().tolist())
            feature = _ld(3, _ld(1, packed))  # Feature.int64_list (packed)
        entry = _ld(1, key.encode()) + _ld(2, feature)
        feats += _ld(1, entry)  # Features.feature map entry
    return _ld(1, feats)  # Example.features


def decode_example(data: bytes) -> dict:
    """Serialized tf.train.Example -> {name: list} feature dict."""
    import struct

    def fields(buf):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:
                ln, pos = _read_varint(buf, pos)
                yield field, buf[pos:pos + ln]
                pos += ln
            elif wire == 0:
                v, pos = _read_varint(buf, pos)
                yield field, v
            elif wire == 5:
                yield field, buf[pos:pos + 4]
                pos += 4
            else:  # pragma: no cover - not produced by Example
                raise ValueError(f"unsupported wire type {wire}")

    out: dict = {}
    for f1, features in fields(data):
        if f1 != 1:
            continue
        for f2, entry in fields(features):
            if f2 != 1:
                continue
            name, feature = None, b""
            for f3, v in fields(entry):
                if f3 == 1:
                    name = v.decode()
                elif f3 == 2:
                    feature = v
            values: list = []
            for kind, payload in fields(feature):
                if kind == 1:  # bytes_list
                    values = [v for f, v in fields(payload) if f == 1]
                elif kind == 2:  # float_list
                    floats: list = []
                    for f, v in fields(payload):
                        if isinstance(v, bytes) and len(v) % 4 == 0:
                            floats.extend(
                                struct.unpack(f"<{len(v) // 4}f", v))
                        elif isinstance(v, bytes):
                            floats.append(struct.unpack("<f", v)[0])
                    values = floats
                elif kind == 3:  # int64_list
                    def signed(n: int) -> int:
                        return n - (1 << 64) if n >= 1 << 63 else n

                    ints: list = []
                    for f, v in fields(payload):
                        if isinstance(v, bytes):  # packed
                            pos = 0
                            while pos < len(v):
                                n, pos = _read_varint(v, pos)
                                ints.append(signed(n))
                        else:  # unpacked varint (equally valid wire form)
                            ints.append(signed(v))
                    values = ints
            if name is not None:
                out[name] = values
    return out


def tfrecord_tasks(paths) -> list[ReadTask]:
    def read(path):
        rows = []
        with open(path, "rb") as f:
            while True:
                head = f.read(12)
                if not head:
                    break
                if len(head) < 12:
                    raise ValueError(
                        f"truncated TFRecord header in {path!r} at "
                        f"offset {f.tell() - len(head)}")
                (length,) = np.frombuffer(head[:8], "<u8")
                (len_crc,) = np.frombuffer(head[8:], "<u4")
                if int(len_crc) != _masked_crc(head[:8]):
                    raise ValueError(
                        f"corrupt TFRecord length CRC in {path!r} at "
                        f"offset {f.tell() - 12}")
                data = f.read(int(length))
                tail = f.read(4)
                if len(data) < int(length) or len(tail) < 4:
                    raise ValueError(
                        f"truncated TFRecord data in {path!r} "
                        f"(wanted {int(length)} bytes)")
                (data_crc,) = np.frombuffer(tail, "<u4")
                if int(data_crc) != _masked_crc(data):
                    raise ValueError(
                        f"corrupt TFRecord data CRC in {path!r}")
                rows.append(decode_example(data))
        if rows:
            from ray_tpu_torch.data.block import BlockAccessor

            # Examples may carry sparse/optional features: normalize to
            # the UNION of keys (missing -> None). Collapse a feature to
            # scalars only when EVERY record has exactly one value —
            # per-column consistency, never scalar-vs-list mixed rows.
            keys = sorted({k for r in rows for k in r})
            scalar = {k: all(len(r[k]) == 1 for r in rows if k in r)
                      for k in keys}
            yield BlockAccessor.from_rows([
                {k: (r[k][0] if scalar[k] else r.get(k))
                 if k in r else None
                 for k in keys}
                for r in rows])

    return _file_tasks(paths, read)


def sql_tasks(sql: str, connection_factory) -> list[ReadTask]:
    """One task running the query through a DB-API connection factory
    (reference: data read_sql, datasource/sql_datasource.py — the
    factory pattern keeps connections picklable)."""
    def read():
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        if rows:
            from ray_tpu_torch.data.block import BlockAccessor

            yield BlockAccessor.from_rows(
                [dict(zip(names, r)) for r in rows])

    return [ReadTask(read)]  # row/byte counts unknown until the query runs


# ---------------------------------------------------------------------------
# Avro Object Container Files — self-contained binary decoder (reference:
# data read_avro, datasource/avro_datasource.py, which delegates to the
# `avro` package; this image ships no avro lib, so the container format
# and binary encoding are implemented directly from the Avro 1.11 spec).
# ---------------------------------------------------------------------------


class _AvroReader:
    """Streaming decoder over one Avro container file."""

    MAGIC = b"Obj\x01"

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0
        if data[:4] != self.MAGIC:
            raise ValueError("not an Avro object container file (bad magic)")
        self.pos = 4
        meta = self._map_bytes()
        import json as _json

        self.schema = _json.loads(meta[b"avro.schema"].decode())
        self.codec = meta.get(b"avro.codec", b"null").decode()
        if self.codec not in ("null", "deflate"):
            raise ValueError(f"unsupported Avro codec {self.codec!r}")
        self.sync = self._fixed(16)
        # Named-type registry so schemas can reference records/enums/
        # fixed by name.
        self.named: dict = {}
        self._register(self.schema)

    # -- varint/zigzag primitives ------------------------------------------

    def _long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def _fixed(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _bytes(self) -> bytes:
        return self._fixed(self._long())

    def _map_bytes(self) -> dict:
        out = {}
        while True:
            n = self._long()
            if n == 0:
                break
            if n < 0:  # block with byte size prefix
                n = -n
                self._long()
            for _ in range(n):
                k = self._bytes()
                out[k] = self._bytes()
        return out

    # -- schema-driven decode ----------------------------------------------

    def _register(self, schema, namespace: str = "") -> None:
        if isinstance(schema, dict):
            t = schema.get("type")
            if t in ("record", "enum", "fixed") and "name" in schema:
                # Spec naming: a name may carry its own namespace (or a
                # dotted fullname); otherwise it inherits the enclosing
                # one. Register BOTH the fullname and the short name so
                # either reference style resolves.
                name = schema["name"]
                if "." in name:
                    namespace, _, name = name.rpartition(".")
                else:
                    namespace = schema.get("namespace", namespace)
                self.named[name] = schema
                if namespace:
                    self.named[f"{namespace}.{name}"] = schema
            if t == "record":
                for f in schema.get("fields", ()):
                    self._register(f.get("type"), namespace)
            elif t == "array":
                self._register(schema.get("items"), namespace)
            elif t == "map":
                self._register(schema.get("values"), namespace)
        elif isinstance(schema, list):
            for s in schema:
                self._register(s, namespace)

    def _decode(self, schema):
        if isinstance(schema, str):
            schema = self.named.get(schema, schema)
        if isinstance(schema, list):  # union: long index, then value
            return self._decode(schema[self._long()])
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                return {f["name"]: self._decode(f["type"])
                        for f in schema["fields"]}
            if t == "array":
                out = []
                while True:
                    n = self._long()
                    if n == 0:
                        break
                    if n < 0:
                        n = -n
                        self._long()  # skip block byte size
                    out.extend(self._decode(schema["items"])
                               for _ in range(n))
                return out
            if t == "map":
                out = {}
                while True:
                    n = self._long()
                    if n == 0:
                        break
                    if n < 0:
                        n = -n
                        self._long()
                    for _ in range(n):
                        key = self._fixed(self._long()).decode()
                        out[key] = self._decode(schema["values"])
                return out
            if t == "enum":
                return schema["symbols"][self._long()]
            if t == "fixed":
                return self._fixed(schema["size"])
            schema = t  # primitive spelled as {"type": "long"} etc.
        if schema == "null":
            return None
        if schema == "boolean":
            b = self.buf[self.pos]
            self.pos += 1
            return bool(b)
        if schema in ("int", "long"):
            return self._long()
        if schema == "float":
            import struct

            (v,) = struct.unpack("<f", self._fixed(4))
            return v
        if schema == "double":
            import struct

            (v,) = struct.unpack("<d", self._fixed(8))
            return v
        if schema == "bytes":
            return self._bytes()
        if schema == "string":
            return self._bytes().decode()
        raise ValueError(f"unsupported Avro schema {schema!r}")

    def records(self):
        import zlib

        while self.pos < len(self.buf):
            count = self._long()
            size = self._long()
            payload = self._fixed(size)
            if self.codec == "deflate":
                payload = zlib.decompress(payload, -15)
            sub = _AvroReader.__new__(_AvroReader)
            sub.buf, sub.pos = payload, 0
            sub.schema, sub.named = self.schema, self.named
            for _ in range(count):
                yield sub._decode(self.schema)
            if self._fixed(16) != self.sync:
                raise ValueError("Avro sync-marker mismatch (corrupt block)")


def avro_tasks(paths) -> list[ReadTask]:
    def read(path):
        with open(path, "rb") as f:
            rows = list(_AvroReader(f.read()).records())
        if rows:
            from ray_tpu_torch.data.block import BlockAccessor

            yield BlockAccessor.from_rows(
                [r if isinstance(r, dict) else {"value": r} for r in rows])

    return _file_tasks(paths, read)


def webdataset_tasks(paths, *, decode: bool = True) -> list[ReadTask]:
    """Tar shards of samples (reference: data read_webdataset,
    datasource/webdataset_datasource.py). Files sharing a basename up to
    the first dot form one sample; the remaining extension names the
    column. ``decode`` converts .txt/.json/.cls payloads (text, JSON,
    int class id); every other field stays raw bytes."""
    def read(path):
        import json as _json
        import tarfile

        rows: list[dict] = []
        cur_key = None
        cur: dict = {}
        with tarfile.open(path, "r:*") as tf:
            for info in tf:
                if not info.isfile():
                    continue
                # Key = full path up to the first dot of the BASENAME
                # (directories included): same-named files in different
                # tar directories are distinct samples.
                dirname, base = os.path.split(info.name)
                stem, _, ext = base.partition(".")
                key = f"{dirname}/{stem}" if dirname else stem
                if key != cur_key:
                    if cur:
                        rows.append(cur)
                    cur_key, cur = key, {"__key__": key}
                payload = tf.extractfile(info).read()
                if decode:
                    if ext in ("txt", "text"):
                        payload = payload.decode()
                    elif ext == "json":
                        payload = _json.loads(payload)
                    elif ext == "cls":
                        payload = int(payload.decode().strip())
                cur[ext] = payload
        if cur:
            rows.append(cur)
        if rows:
            from ray_tpu_torch.data.block import BlockAccessor

            # Samples may carry heterogeneous fields (optional captions
            # or metadata); normalize to the union so from_rows (which
            # derives columns from the first row) neither drops fields
            # nor KeyErrors.
            cols: dict = {}
            for r in rows:
                for k in r:
                    cols.setdefault(k, None)
            rows = [{k: r.get(k) for k in cols} for r in rows]
            yield BlockAccessor.from_rows(rows)

    return _file_tasks(paths, read)


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tif",
               ".tiff")


def image_tasks(paths, *, size: "tuple | None" = None,
                mode: str = "RGB", include_paths: bool = False
                ) -> list[ReadTask]:
    """Decoded image arrays (reference: read_images,
    datasource/image_datasource.py — which filters directories by image
    extension for the same reason: one stray README must not abort the
    read). Requires Pillow."""
    def read(path):
        from PIL import Image

        img = Image.open(path).convert(mode)
        if size is not None:
            # size is (height, width) — reference ImageDatasource
            # convention; PIL's resize takes (width, height).
            img = img.resize((size[1], size[0]))
        block = {"image": np.asarray(img)[None]}
        if include_paths:
            block["path"] = np.asarray([path], dtype=object)
        yield block

    files = [p for p in _expand_paths(paths)
             if p.lower().endswith(_IMAGE_EXTS)]
    if not files:
        raise FileNotFoundError(f"no image files matched {paths!r}")
    return _file_tasks(files, read)


# -- writers ----------------------------------------------------------------

def write_tfrecord_block(block: Block, path: str, idx: int) -> str:
    import struct

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:06d}.tfrecords")
    with open(out, "wb") as f:
        for row in BlockAccessor(block).iter_rows():
            if not isinstance(row, dict):
                row = {"item": row}
            data = encode_example(row)
            # Explicit little-endian framing (the spec; native tobytes
            # would byte-swap on BE hosts and fail the reader's CRCs).
            head = struct.pack("<Q", len(data))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
    return out


def write_parquet_block(block: Block, path: str, idx: int) -> str:
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:06d}.parquet")
    pq.write_table(BlockAccessor(block).to_arrow(), out)
    return out


def write_csv_block(block: Block, path: str, idx: int) -> str:
    import pyarrow.csv as pacsv

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:06d}.csv")
    pacsv.write_csv(BlockAccessor(block).to_arrow(), out)
    return out


def write_json_block(block: Block, path: str, idx: int) -> str:
    import json

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:06d}.jsonl")
    with open(out, "w") as f:
        for row in BlockAccessor(block).iter_rows():
            if not isinstance(row, dict):
                row = {"item": row}
            f.write(json.dumps(
                {k: v.tolist() if isinstance(v, np.ndarray) else
                 (v.item() if isinstance(v, np.generic) else v)
                 for k, v in row.items()}
            ) + "\n")
    return out


class Datasource:
    """Custom datasource plugin ABC (reference:
    data/datasource/datasource.py Datasource — get_read_tasks(parallelism)
    returning ReadTasks; ray.data.read_datasource). Subclass and implement
    ``get_read_tasks``; optionally ``estimate_inmemory_data_size``.

        class MySource(Datasource):
            def get_read_tasks(self, parallelism):
                return [ReadTask(lambda i=i: iter([{'x': np.arange(i)}]))
                        for i in range(parallelism)]

        ds = ray_tpu_torch.data.read_datasource(MySource(), parallelism=8)
    """

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> int | None:
        return None

    def get_name(self) -> str:
        return type(self).__name__


def write_numpy_block(block: Block, path: str, idx: int,
                      column: "str | None" = None) -> str:
    """One .npy per block (reference: Dataset.write_numpy — a single
    column as a stacked array, or the whole block as a structured dict
    via np.savez when no column is named)."""
    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    batch = BlockAccessor(block).to_numpy()
    if column is not None:
        out = os.path.join(path, f"part-{idx:06d}.npy")
        np.save(out, np.asarray(batch[column]))
    else:
        out = os.path.join(path, f"part-{idx:06d}.npz")
        np.savez(out, **{k: np.asarray(v) for k, v in batch.items()})
    return out


def write_sql_block(block: Block, sql: str, connection_factory) -> int:
    """executemany one block through a DB-API connection (reference:
    Dataset.write_sql — same (sql, connection_factory) contract)."""
    from ray_tpu_torch.data.block import BlockAccessor

    conn = connection_factory()
    try:
        rows = []
        for row in BlockAccessor(block).iter_rows():
            if not isinstance(row, dict):
                row = {"item": row}
            rows.append(tuple(
                v.item() if isinstance(v, np.generic) else v
                for v in row.values()))
        cur = conn.cursor()
        cur.executemany(sql, rows)
        conn.commit()
        return len(rows)
    finally:
        conn.close()


def write_webdataset_block(block: Block, path: str, idx: int) -> str:
    """One tar shard per block, inverse of webdataset_tasks: each row
    becomes `<key>.<column>` members; bytes stay raw, str -> .txt-style
    text, int -> .cls, everything else JSON (reference:
    Dataset.write_webdataset)."""
    import io
    import json as _json
    import tarfile

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{idx:06d}.tar")
    with tarfile.open(out, "w") as tf:
        for i, row in enumerate(BlockAccessor(block).iter_rows()):
            if not isinstance(row, dict):
                row = {"bin": row}
            key = str(row.get("__key__") or f"{idx:06d}-{i:06d}")
            for col, value in row.items():
                if col == "__key__":
                    continue
                if isinstance(value, np.generic):
                    value = value.item()
                if isinstance(value, bytes):
                    payload = value
                elif isinstance(value, str):
                    payload = value.encode()
                elif isinstance(value, int):
                    payload = str(value).encode()
                else:
                    if isinstance(value, np.ndarray):
                        value = value.tolist()
                    payload = _json.dumps(value).encode()
                info = tarfile.TarInfo(f"{key}.{col}")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return out


def write_images_block(block: Block, path: str, idx: int,
                       column: str = "image",
                       file_format: str = "png") -> list[str]:
    """One image file per row from an array column (reference:
    Dataset.write_images)."""
    from PIL import Image

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    outs = []
    for i, row in enumerate(BlockAccessor(block).iter_rows()):
        arr = np.asarray(row[column])
        out = os.path.join(path, f"img-{idx:06d}-{i:06d}.{file_format}")
        Image.fromarray(arr).save(out)
        outs.append(out)
    return outs
