"""Dataset: the public lazy-plan API of ray_tpu_torch.data (port of
ray_tpu/data/dataset.py).

Counterpart of the reference's Dataset (python/ray/data/dataset.py:153 —
builds a logical plan under _internal/logical/, executed by the
StreamingExecutor) and DataIterator (data/iterator.py:94 iter_batches).
Transforms append logical ops; execution happens at iteration/consumption
(iter_batches, take, write_*) through executor.execute_plan, which fuses
map chains and fans read/map stages out as tasks of the port's core when
a cluster is up. Batches are numpy dicts by default; ``iter_torch_batches``
hands them over as tensors on a device (the card unless the caller asks
for the CPU), where the reference's ``iter_jax_batches`` hands out jax
arrays placed by a ``sharding``. The port has no ``sharding=``: a rank
of a process group takes its part through ``streaming_split``."""

from __future__ import annotations

import builtins
import dataclasses
import itertools
from typing import Any, Callable, ClassVar, Iterator, Optional

import numpy as np

from ray_tpu_torch.data import datasource as ds_mod
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.executor import (
    AddColumn,
    DropColumns,
    Filter,
    FlatMap,
    InputData,
    Limit,
    LogicalOp,
    MapBatches,
    MapRows,
    RandomizeBlockOrder,
    RandomShuffle,
    Read,
    RenameColumns,
    Repartition,
    SelectColumns,
    Sort,
    UnionOp,
    ZipOp,
    _rebatch,
    execute_plan,
)


@dataclasses.dataclass
class DataContext:
    """Execution knobs (reference: data/context.py DataContext)."""

    use_tasks: bool = True  # fan stages out as cluster tasks when possible
    parallelism: int = 4  # max in-flight stage tasks (backpressure window)
    # Byte budget for completed-but-unconsumed stage outputs (reference:
    # streaming_executor.py:48 resource-budget backpressure — output
    # queues bounded by BYTES, not count). Producers stop submitting
    # while the buffered bytes exceed this; a slow consumer therefore
    # caps memory at ~budget + parallelism in-flight blocks regardless
    # of dataset size.
    target_max_bytes_in_flight: int = 256 * 1024 * 1024
    # Filled by the executor per run: {"max_bytes_buffered": N, ...}.
    stats: dict = dataclasses.field(default_factory=dict)

    _current: "ClassVar[DataContext | None]" = None

    @staticmethod
    def get_current() -> "DataContext":
        if DataContext._current is None:
            DataContext._current = DataContext()
        return DataContext._current


class Dataset:
    """Lazy, immutable plan over blocks. Reference: data/dataset.py:153."""

    def __init__(self, plan: list[LogicalOp]):
        self._plan = plan

    # -- plan building -----------------------------------------------------

    def _append(self, op: LogicalOp) -> "Dataset":
        return Dataset(self._plan + [op])

    def map(self, fn: Callable) -> "Dataset":
        return self._append(MapRows(fn))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: int | None = None,
        batch_format: str = "numpy",
        fn_constructor_args: tuple = (),
        zero_copy_batch: bool = False,
        compute: Any = None,
    ) -> "Dataset":
        if isinstance(fn, type):
            ctor = fn
            args = fn_constructor_args
            return self._append(
                MapBatches(None, batch_size, batch_format,
                           lambda: ctor(*args),
                           zero_copy_batch=zero_copy_batch,
                           compute=compute)
            )
        if compute is not None:
            raise ValueError(
                "compute='actors' requires a CLASS UDF (the pool exists "
                "to amortize expensive per-worker setup)")
        return self._append(MapBatches(fn, batch_size, batch_format,
                                       zero_copy_batch=zero_copy_batch))

    def filter(self, fn: Callable) -> "Dataset":
        return self._append(Filter(fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._append(FlatMap(fn))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._append(AddColumn(name, fn))

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self._append(DropColumns(tuple(cols)))

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self._append(SelectColumns(tuple(cols)))

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        return self._append(RenameColumns(dict(mapping)))

    def limit(self, n: int) -> "Dataset":
        return self._append(Limit(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(Repartition(num_blocks))

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        return self._append(RandomShuffle(seed))

    def randomize_block_order(self, *, seed: int | None = None) -> "Dataset":
        """Shuffle block order without repacking rows (reference:
        Dataset.randomize_block_order)."""
        return self._append(RandomizeBlockOrder(seed))

    def sort(self, key: str, *, descending: bool = False) -> "Dataset":
        return self._append(Sort(key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._append(UnionOp([o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._append(ZipOp(other._plan))

    # -- execution ---------------------------------------------------------

    def iter_blocks(self) -> Iterator[Block]:
        ctx = DataContext.get_current()
        return self._instrumented(execute_plan(self._plan, ctx), ctx)

    def _instrumented(self, stream: Iterator[Block], ctx) -> Iterator[Block]:
        """Record per-run execution stats while the stream drains."""
        import time as _time

        t0 = _time.perf_counter()
        blocks = rows = nbytes = 0
        try:
            for b in stream:
                acc = BlockAccessor(b)
                blocks += 1
                rows += acc.num_rows()
                nbytes += acc.size_bytes()
                yield b
        finally:
            self._last_stats = {
                "wall_s": _time.perf_counter() - t0,
                "blocks": blocks,
                "rows": rows,
                "bytes": nbytes,
                "max_bytes_buffered": ctx.stats.get("max_bytes_buffered"),
            }

    def stats(self) -> str:
        """Execution summary for the most recent iteration of THIS
        dataset (reference: Dataset.stats, dataset.py:5227)."""
        s = getattr(self, "_last_stats", None)
        if not s:
            return "No execution stats yet: iterate the dataset first."
        mb = s["bytes"] / (1024 * 1024)
        rate = s["rows"] / s["wall_s"] if s["wall_s"] > 0 else float("inf")
        out = (f"Dataset execution: {s['blocks']} blocks, {s['rows']} rows, "
               f"{mb:.1f} MiB in {s['wall_s']:.3f}s ({rate:,.0f} rows/s)")
        if s.get("max_bytes_buffered") is not None:
            out += (f"; peak buffered "
                    f"{s['max_bytes_buffered'] / (1024 * 1024):.1f} MiB")
        return out

    def iter_batches(
        self,
        *,
        batch_size: int | None = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        zero_copy_batch: bool = False,
    ) -> Iterator[Any]:
        stream = _rebatch(self.iter_blocks(), batch_size,
                          zero_copy=zero_copy_batch)
        for block in stream:
            acc = BlockAccessor(block)
            if drop_last and batch_size and acc.num_rows() < batch_size:
                continue
            yield acc.to_batch(batch_format)

    def iter_rows(self) -> Iterator[Any]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_torch_batches(self, *, batch_size: int | None = 256,
                           drop_last: bool = False, device="cuda",
                           dtypes=None) -> Iterator[dict]:
        """Batches as torch tensors on ``device`` (reference analogue:
        iter_torch_batches, data/iterator.py:233; it takes the place of
        ray_tpu's ``iter_jax_batches``). ``dtypes`` is one torch dtype
        for every column or a {column: dtype} dict; object columns stay
        numpy. ray_tpu's iter_torch_batches gives CPU tensors: pass
        ``device="cpu"`` for those."""
        yield from _torch_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last), device, dtypes)

    def iter_tf_batches(self, *, batch_size: int | None = 256,
                        drop_last: bool = False) -> Iterator[dict]:
        """Batches as tf tensors (reference: iter_tf_batches,
        data/iterator.py:378)."""
        import tensorflow as tf

        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            yield {
                k: tf.convert_to_tensor(v) if v.dtype != object else v
                for k, v in batch.items()
            }

    # -- consumption -------------------------------------------------------

    def take(self, n: int = 20) -> list:
        return list(itertools.islice(self.limit(n).iter_rows(), n))

    def take_all(self) -> list:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self.iter_blocks())

    def schema(self):
        for block in self.iter_blocks():
            return BlockAccessor(block).schema()
        return None

    def columns(self) -> list[str]:
        for block in self.iter_blocks():
            return BlockAccessor(block).column_names()
        return []

    def materialize(self) -> "Dataset":
        """Execute now; the result holds concrete blocks (reference:
        Dataset.materialize → MaterializedDataset)."""
        return Dataset([InputData(blocks=list(self.iter_blocks()))])

    def to_pandas(self):
        import pandas as pd

        frames = [BlockAccessor(b).to_pandas() for b in self.iter_blocks()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow(self):
        return BlockAccessor(BlockAccessor.concat(list(self.iter_blocks()))).to_arrow()

    # -- column stats ------------------------------------------------------

    def _column_values(self, col: str) -> np.ndarray:
        parts = [BlockAccessor(b).to_numpy()[col] for b in self.iter_blocks()]
        return np.concatenate(parts) if parts else np.array([])

    def sum(self, col: str):
        return self._column_values(col).sum()

    def min(self, col: str):
        return self._column_values(col).min()

    def max(self, col: str):
        return self._column_values(col).max()

    def mean(self, col: str):
        return float(self._column_values(col).mean())

    def std(self, col: str):
        return float(self._column_values(col).std(ddof=1))

    def unique(self, col: str) -> list:
        return list(np.unique(self._column_values(col)))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    # -- writes ------------------------------------------------------------

    def _write(self, path: str, writer) -> list[str]:
        return [writer(b, path, i) for i, b in enumerate(self.iter_blocks())]

    def write_parquet(self, path: str) -> list[str]:
        return self._write(path, ds_mod.write_parquet_block)

    def write_csv(self, path: str) -> list[str]:
        return self._write(path, ds_mod.write_csv_block)

    def write_json(self, path: str) -> list[str]:
        return self._write(path, ds_mod.write_json_block)

    def write_tfrecords(self, path: str) -> list[str]:
        return self._write(path, ds_mod.write_tfrecord_block)

    def write_numpy(self, path: str, *,
                    column: str | None = None) -> list[str]:
        """.npy (one column) / .npz (whole block) shards (reference:
        Dataset.write_numpy)."""
        return self._write(
            path, lambda b, p, i: ds_mod.write_numpy_block(b, p, i, column))

    def write_sql(self, sql: str, connection_factory) -> int:
        """Insert every row through a DB-API connection; returns rows
        written (reference: Dataset.write_sql — same
        (sql, connection_factory) contract as read_sql)."""
        return sum(ds_mod.write_sql_block(b, sql, connection_factory)
                   for b in self.iter_blocks())

    def write_webdataset(self, path: str) -> list[str]:
        """Tar shards, inverse of read_webdataset (reference:
        Dataset.write_webdataset)."""
        return self._write(path, ds_mod.write_webdataset_block)

    def write_images(self, path: str, column: str = "image", *,
                     file_format: str = "png") -> list[str]:
        """One image file per row (reference: Dataset.write_images)."""
        outs: list[str] = []
        for i, b in enumerate(self.iter_blocks()):
            outs.extend(ds_mod.write_images_block(b, path, i, column,
                                                  file_format))
        return outs

    def write_datasink(self, datasink: "Datasink") -> None:
        """Stream blocks through a custom sink (reference:
        Dataset.write_datasink / datasource.Datasink lifecycle:
        on_write_start -> write(block) per block -> on_write_complete,
        or on_write_failed with the exception)."""
        try:
            # on_write_start inside the try: a staging-setup failure is
            # a write failure per the documented lifecycle and must
            # route through on_write_failed before re-raising.
            datasink.on_write_start()
            for block in self.iter_blocks():
                datasink.write(block)
        except Exception as e:
            datasink.on_write_failed(e)
            raise
        datasink.on_write_complete()

    # -- train integration -------------------------------------------------

    def split(self, n: int) -> list["Dataset"]:
        """Materializing equal split (reference: Dataset.split)."""
        blocks = list(self.repartition(n).iter_blocks())
        # repartition yields exactly n blocks
        return [Dataset([InputData(blocks=[b])]) for b in blocks]

    def split_at_indices(self, indices: list[int]) -> list["Dataset"]:
        """Materialize and split at row indices (reference:
        Dataset.split_at_indices, dataset.py:1923): ``[2, 5]`` yields
        rows [0,2), [2,5), [5,end)."""
        if sorted(indices) != list(indices) or any(i < 0 for i in indices):
            raise ValueError("indices must be non-negative and sorted")
        rows = self.take_all()
        bounds = [0, *indices, len(rows)]
        out = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = rows[max(lo, 0):max(hi, 0)]
            out.append(from_items(part) if part else
                       Dataset([InputData(blocks=[])]))
        return out

    def train_test_split(self, test_size: "int | float", *,
                         shuffle: bool = False, seed: int | None = None,
                         ) -> "tuple[Dataset, Dataset]":
        """Materializing train/test split (reference:
        Dataset.train_test_split, dataset.py:2079). ``test_size`` is a
        fraction (0, 1) or an absolute row count; the train split is the
        complement."""
        ds = self.random_shuffle(seed=seed) if shuffle else self
        n = ds.count()
        if isinstance(test_size, float):
            if not 0.0 < test_size < 1.0:
                raise ValueError(
                    f"float test_size must be in (0, 1), got {test_size}")
            k = int(n * test_size)
        else:
            if not 0 <= int(test_size) <= n:
                raise ValueError(
                    f"int test_size must be in [0, {n}], got {test_size}")
            k = int(test_size)
        train, test = ds.split_at_indices([n - k])
        return train, test

    def random_sample(self, fraction: float, *,
                      seed: int | None = None) -> "Dataset":
        """Bernoulli row sample (reference: Dataset.random_sample,
        dataset.py:1549) — each row kept independently with probability
        ``fraction``, so the result size is approximate."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        rng = np.random.default_rng(seed)

        def sample(batch: dict) -> dict:
            num = len(next(iter(batch.values()))) if batch else 0
            keep = rng.random(num) < fraction
            return {k: np.asarray(v)[keep] for k, v in batch.items()}

        return self.map_batches(sample)

    def take_batch(self, batch_size: int = 20) -> dict:
        """First up-to-``batch_size`` rows as one columnar batch
        (reference: Dataset.take_batch, dataset.py:2704)."""
        for batch in self.limit(batch_size).iter_batches(
                batch_size=batch_size, drop_last=False):
            return batch
        raise ValueError("dataset is empty")

    def streaming_split(self, n: int) -> list["DataIterator"]:
        """Per-worker streaming shards (reference: Dataset.streaming_split
        + train/_internal/data_config.py:12). Shard i consumes blocks
        j ≡ i (mod n) of the executed stream — workers iterate
        concurrently without materializing the whole dataset."""
        return [DataIterator(self, i, n) for i in builtins.range(n)]

    def iterator(self) -> "DataIterator":
        """Whole-dataset DataIterator (reference: Dataset.iterator)."""
        return DataIterator(self, 0, 1)

    # -- introspection -----------------------------------------------------

    @property
    def context(self) -> DataContext:
        """The execution context this plan runs under (reference:
        Dataset.context)."""
        return DataContext.get_current()

    def copy(self) -> "Dataset":
        """Shallow plan copy (reference: Dataset.copy — plans are
        immutable, so a list copy is a full logical copy)."""
        return Dataset(list(self._plan))

    def show(self, limit: int = 20) -> None:
        """Print up to ``limit`` rows (reference: Dataset.show).
        numpy scalars display as plain Python values."""
        for row in self.take(limit):
            if isinstance(row, dict):
                row = {k: (v.item() if isinstance(v, np.generic) else v)
                       for k, v in row.items()}
            print(row)

    def num_blocks(self) -> int:
        """Block count after execution (reference: Dataset.num_blocks)."""
        return sum(1 for _ in self.iter_blocks())

    def size_bytes(self) -> int:
        """Total block bytes after execution (reference:
        Dataset.size_bytes)."""
        return sum(BlockAccessor(b).size_bytes() for b in self.iter_blocks())

    def input_files(self) -> list[str]:
        """Source file paths of the plan's read ops (reference:
        Dataset.input_files). Empty for in-memory sources."""
        files: list[str] = []
        for op in self._plan:
            if isinstance(op, Read):
                for task in op.tasks:
                    meta = getattr(task, "metadata", None)
                    files.extend(getattr(meta, "input_files", None) or ())
        return files

    def names(self) -> list[str]:
        """Column names (reference: Dataset.schema().names)."""
        return self.columns()

    def types(self) -> list:
        """Column dtypes of the first block, schema order (reference:
        Dataset.schema().types)."""
        for block in self.iter_blocks():
            acc = BlockAccessor(block)
            batch = acc.to_batch("numpy")
            return [np.asarray(batch[c]).dtype for c in acc.column_names()]
        return []

    def split_proportionately(self, proportions: list[float],
                              ) -> list["Dataset"]:
        """Materializing split by fractions; the remainder becomes the
        final extra split (reference: Dataset.split_proportionately,
        ``[0.7, 0.2]`` -> three datasets at 70%/20%/10%)."""
        if not proportions or any(p <= 0 for p in proportions) \
                or sum(proportions) >= 1.0:
            raise ValueError("proportions must be positive and sum to <1")
        n = self.count()
        bounds, acc = [], 0.0
        for p in proportions:
            acc += p
            # round, not int: float accumulation (0.7+0.2 ->
            # 0.8999999…) would truncate a row out of the wrong split.
            bounds.append(round(n * acc))
        return self.split_at_indices(bounds)

    # -- ref-level conversions (reference: to_*_refs — per-block object
    # refs so downstream consumers fetch shards without a driver concat)

    def to_numpy_refs(self) -> list:
        import ray_tpu_torch

        return [ray_tpu_torch.put(BlockAccessor(b).to_numpy())
                for b in self.iter_blocks()]

    def to_pandas_refs(self) -> list:
        import ray_tpu_torch

        return [ray_tpu_torch.put(BlockAccessor(b).to_pandas())
                for b in self.iter_blocks()]

    def to_arrow_refs(self) -> list:
        import ray_tpu_torch

        return [ray_tpu_torch.put(BlockAccessor(b).to_arrow())
                for b in self.iter_blocks()]

    # -- framework-native datasets ----------------------------------------

    def to_tf(self, feature_columns, label_columns, *,
              batch_size: int = 256):
        """tf.data.Dataset of (features, labels) (reference:
        Dataset.to_tf). Columns may be a name or list of names; a single
        name yields a bare tensor, a list a dict of tensors."""
        import tensorflow as tf

        # One plan execution for both signatures — _spec per column set
        # would re-run the whole read/map pipeline twice at graph-
        # definition time.
        probe = self.take_batch(1)

        def _spec(cols):
            def one(c):
                v = np.asarray(probe[c])
                return tf.TensorSpec(shape=(None,) + v.shape[1:],
                                     dtype=tf.as_dtype(v.dtype))
            if isinstance(cols, str):
                return one(cols)
            return {c: one(c) for c in cols}

        def _pick(batch, cols):
            if isinstance(cols, str):
                return tf.convert_to_tensor(batch[cols])
            return {c: tf.convert_to_tensor(batch[c]) for c in cols}

        def gen():
            for batch in self.iter_batches(batch_size=batch_size):
                yield _pick(batch, feature_columns), _pick(batch, label_columns)

        return tf.data.Dataset.from_generator(
            gen, output_signature=(_spec(feature_columns),
                                   _spec(label_columns)))

    def to_torch(self, *, label_column: str | None = None,
                 batch_size: int = 256):
        """torch IterableDataset of (features_dict, label) batches —
        or plain batch dicts without a label column (reference:
        Dataset.to_torch)."""
        import torch

        outer = self

        class _IterTorch(torch.utils.data.IterableDataset):
            def __iter__(self):
                # CPU tensors, as the reference's (a DataLoader moves them).
                for batch in outer.iter_torch_batches(
                        batch_size=batch_size, device="cpu"):
                    if label_column is None:
                        yield batch
                    else:
                        label = batch.pop(label_column)
                        yield batch, label

        return _IterTorch()

    def __repr__(self):
        names = [type(op).__name__ for op in self._plan]
        return f"Dataset({' -> '.join(names)})"


def _torch_batches(batches, device, dtypes) -> Iterator[dict]:
    import torch

    for batch in batches:
        out = {}
        for k, v in batch.items():
            if v.dtype == object:
                out[k] = v
                continue
            dt = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
            out[k] = torch.as_tensor(v).to(device=device, dtype=dt)
        yield out


class Datasink:
    """Custom write target (reference: data/datasource/datasink.py
    Datasink — subclass and override write(); the lifecycle hooks are
    optional)."""

    def on_write_start(self) -> None:
        pass

    def write(self, block: Block) -> None:
        raise NotImplementedError

    def on_write_complete(self) -> None:
        pass

    def on_write_failed(self, error: Exception) -> None:
        pass


class DataIterator:
    """A worker's shard view (reference: data/iterator.py DataIterator)."""

    def __init__(self, dataset: Dataset, shard_index: int, num_shards: int):
        self._ds = dataset
        self._shard = shard_index
        self._num = num_shards

    def _blocks(self) -> Iterator[Block]:
        for i, block in enumerate(self._ds.iter_blocks()):
            if i % self._num == self._shard:
                yield block

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        for block in _rebatch(self._blocks(), batch_size):
            acc = BlockAccessor(block)
            if drop_last and batch_size and acc.num_rows() < batch_size:
                continue
            yield acc.to_batch(batch_format)

    def iter_rows(self) -> Iterator[Any]:
        for block in self._blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_torch_batches(self, *, batch_size: int | None = 256,
                           drop_last: bool = False, device="cuda",
                           dtypes=None) -> Iterator[dict]:
        """This shard's batches as tensors on ``device`` (as
        ``Dataset.iter_torch_batches``)."""
        yield from _torch_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last), device, dtypes)

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self._blocks())


class GroupedData:
    """Reference: data/grouped_data.py. Sort-based host aggregation."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _groups(self) -> Iterator[tuple[Any, dict[str, np.ndarray]]]:
        blocks = list(self._ds.iter_blocks())
        if not blocks:
            return
        merged = BlockAccessor(BlockAccessor.concat(blocks))
        cols = merged.to_numpy()
        keys = cols[self._key]
        order = np.argsort(keys, kind="stable")
        sorted_cols = {k: v[order] for k, v in cols.items()}
        sk = sorted_cols[self._key]
        bounds = np.nonzero(sk[1:] != sk[:-1])[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(sk)]])
        for s, e in zip(starts, ends):
            yield sk[s], {k: v[s:e] for k, v in sorted_cols.items()}

    def _agg(self, fn: Callable, cols: Optional[list[str]] = None) -> Dataset:
        rows = []
        for key_val, group in self._groups():
            row = {self._key: key_val}
            for k, v in group.items():
                if k == self._key:
                    continue
                if cols is not None and k not in cols:
                    continue
                row[k] = fn(v)
            rows.append(row)
        return from_items(rows)

    def count(self) -> Dataset:
        rows = [
            {self._key: kv, "count()": len(next(iter(g.values())))}
            for kv, g in self._groups()
        ]
        return from_items(rows)

    def sum(self, cols: list[str] | str | None = None) -> Dataset:
        return self._agg(np.sum, [cols] if isinstance(cols, str) else cols)

    def mean(self, cols: list[str] | str | None = None) -> Dataset:
        return self._agg(np.mean, [cols] if isinstance(cols, str) else cols)

    def min(self, cols: list[str] | str | None = None) -> Dataset:
        return self._agg(np.min, [cols] if isinstance(cols, str) else cols)

    def max(self, cols: list[str] | str | None = None) -> Dataset:
        return self._agg(np.max, [cols] if isinstance(cols, str) else cols)

    def std(self, cols: list[str] | str | None = None,
            ddof: int = 1) -> Dataset:
        return self._agg(lambda v: np.std(v, ddof=ddof) if len(v) > ddof
                         else 0.0,
                         [cols] if isinstance(cols, str) else cols)

    def aggregate(self, **named_aggs: "tuple[str, Callable]") -> Dataset:
        """Generic multi-aggregate (reference: grouped_data.py
        GroupedData.aggregate with AggregateFn): each kwarg maps an
        output column to ``(input_column, fn)`` where fn reduces the
        group's numpy column to a scalar.

            ds.groupby("k").aggregate(total=("v", np.sum),
                                      biggest=("v", np.max))
        """
        if self._key in named_aggs:
            raise ValueError(
                f"aggregate: output column {self._key!r} would overwrite "
                f"the group key")
        rows = []
        for key_val, group in self._groups():
            row = {self._key: key_val}
            for out_col, (in_col, fn) in named_aggs.items():
                if in_col not in group:
                    raise KeyError(
                        f"aggregate: column {in_col!r} not in dataset "
                        f"(have {sorted(group)})")
                row[out_col] = fn(group[in_col])
            rows.append(row)
        return from_items(rows)

    def map_groups(self, fn: Callable) -> Dataset:
        out_blocks = []
        for _, group in self._groups():
            res = fn(group)
            if res is not None:
                out_blocks.append(BlockAccessor.batch_to_block(res))
        return Dataset([InputData(blocks=out_blocks)])


# ---------------------------------------------------------------------------
# creation APIs (reference: ray.data.read_* / from_*)


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    if parallelism <= 0:
        parallelism = DataContext.get_current().parallelism
    return Dataset([Read(tasks=ds_mod.range_tasks(n, parallelism))])


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    if parallelism <= 0:
        parallelism = DataContext.get_current().parallelism
    return Dataset([Read(tasks=ds_mod.range_tensor_tasks(n, shape, parallelism))])


def from_items(items: list) -> Dataset:
    return Dataset([InputData(blocks=[BlockAccessor.from_rows(list(items))])])


def from_numpy(arrays: np.ndarray | dict[str, np.ndarray]) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}
    return Dataset([InputData(blocks=[{k: np.asarray(v) for k, v in arrays.items()}])])


def from_arrow(table) -> Dataset:
    return Dataset([InputData(blocks=[table])])


def _df_to_block(df):
    import pyarrow as pa

    return pa.Table.from_pandas(df, preserve_index=False)


def from_pandas(df) -> Dataset:
    return Dataset([InputData(blocks=[_df_to_block(df)])])


def read_parquet(paths, *, columns: list[str] | None = None) -> Dataset:
    return Dataset([Read(tasks=ds_mod.parquet_tasks(paths, columns))])


def read_csv(paths, **kwargs) -> Dataset:
    return Dataset([Read(tasks=ds_mod.csv_tasks(paths, **kwargs))])


def read_json(paths) -> Dataset:
    return Dataset([Read(tasks=ds_mod.json_tasks(paths))])


def read_text(paths, *, drop_empty_lines: bool = True) -> Dataset:
    return Dataset([Read(tasks=ds_mod.text_tasks(paths, drop_empty_lines=drop_empty_lines))])


def read_numpy(paths) -> Dataset:
    return Dataset([Read(tasks=ds_mod.numpy_tasks(paths))])


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    return Dataset([Read(tasks=ds_mod.binary_tasks(paths, include_paths=include_paths))])


def read_tfrecords(paths) -> Dataset:
    """TFRecord files of tf.train.Example records, decoded WITHOUT a
    TensorFlow dependency (reference: read_tfrecords, read_api.py)."""
    return Dataset([Read(tasks=ds_mod.tfrecord_tasks(paths))])


def read_sql(sql: str, connection_factory) -> Dataset:
    """Rows from a DB-API query (reference: read_sql,
    datasource/sql_datasource.py). ``connection_factory`` is a zero-arg
    callable returning a fresh connection (picklable, runs on the
    executing worker)."""
    return Dataset([Read(tasks=ds_mod.sql_tasks(sql, connection_factory))])


def read_avro(paths) -> Dataset:
    """Avro object-container files, decoded without an avro-package
    dependency (reference: read_avro, datasource/avro_datasource.py)."""
    return Dataset([Read(tasks=ds_mod.avro_tasks(paths))])


def read_webdataset(paths, *, decode: bool = True) -> Dataset:
    """WebDataset tar shards: files sharing a basename form one sample
    (reference: read_webdataset, datasource/webdataset_datasource.py)."""
    return Dataset([Read(tasks=ds_mod.webdataset_tasks(paths, decode=decode))])


def read_parquet_bulk(paths, *, columns: list[str] | None = None) -> Dataset:
    """One block per file with no cross-file metadata/schema
    unification up front (reference: read_parquet_bulk, read_api.py —
    the many-small-files fast path). Our parquet reader is already
    per-file, so this differs from read_parquet only in skipping
    directory expansion niceties the slow path adds later."""
    return Dataset([Read(tasks=ds_mod.parquet_tasks(paths, columns))])


def from_blocks(blocks: list) -> Dataset:
    """Dataset over pre-built blocks (reference: from_blocks,
    read_api.py)."""
    return Dataset([InputData(blocks=list(blocks))])


def _get_refs(refs) -> list:
    import ray_tpu_torch

    if not isinstance(refs, (list, tuple)):
        refs = [refs]
    return ray_tpu_torch.get(list(refs))


def from_pandas_refs(refs) -> Dataset:
    """Dataset from ObjectRefs of pandas DataFrames (reference:
    from_pandas_refs, read_api.py)."""
    return Dataset([InputData(blocks=[_df_to_block(df)
                                      for df in _get_refs(refs)])])


def from_numpy_refs(refs) -> Dataset:
    """Dataset from ObjectRefs of numpy arrays (reference:
    from_numpy_refs, read_api.py)."""
    return Dataset([InputData(blocks=[{"data": a} for a in _get_refs(refs)])])


def from_arrow_refs(refs) -> Dataset:
    """Dataset from ObjectRefs of Arrow tables (reference:
    from_arrow_refs, read_api.py)."""
    return Dataset([InputData(blocks=_get_refs(refs))])


def from_tf(tf_dataset) -> Dataset:
    """Ingest a tf.data.Dataset by materializing it (reference: from_tf,
    read_api.py — likewise eager: 'loads the entire dataset into
    memory')."""
    rows = []
    for item in tf_dataset.as_numpy_iterator():
        if isinstance(item, dict):
            rows.append(item)
        elif isinstance(item, (tuple, list)):
            rows.append({f"item_{i}": v for i, v in enumerate(item)})
        else:
            rows.append({"item": item})
    from ray_tpu_torch.data.block import BlockAccessor

    return Dataset([InputData(blocks=[BlockAccessor.from_rows(rows)])])


def read_images(paths, *, size: "tuple | None" = None, mode: str = "RGB",
                include_paths: bool = False) -> Dataset:
    """Decoded image arrays via Pillow (reference: read_images,
    datasource/image_datasource.py)."""
    return Dataset([Read(tasks=ds_mod.image_tasks(
        paths, size=size, mode=mode, include_paths=include_paths))])


def from_huggingface(hf_dataset) -> Dataset:
    """Ingest a Hugging Face ``datasets.Dataset`` (reference:
    ray.data.from_huggingface, data/read_api.py). Arrow-backed HF datasets
    convert column-wise without row materialization."""
    try:
        if getattr(hf_dataset, "_indices", None) is not None:
            # select/shuffle/filter keep an indices mapping over the full
            # backing table; materialize it or we'd read unselected rows.
            hf_dataset = hf_dataset.flatten_indices()
        table = hf_dataset.data.table  # pyarrow.Table behind the HF dataset
    except AttributeError:
        table = None
    if table is not None:
        return from_arrow(table)
    rows = [dict(r) for r in hf_dataset]
    return from_items(rows)


def from_torch(torch_dataset) -> Dataset:
    """Ingest a map-style torch Dataset (reference: ray.data.from_torch) —
    rows are (sample, label) tuples or dicts."""
    # NB: this module's `range` is ray_tpu_torch.data.range (a Dataset factory);
    # index with the builtin.
    import builtins

    rows = [torch_dataset[i] for i in builtins.range(len(torch_dataset))]
    return from_items(rows)


def read_datasource(datasource, *, parallelism: int = -1) -> Dataset:
    """Read from a custom Datasource plugin (reference:
    ray.data.read_datasource, data/read_api.py)."""
    if parallelism <= 0:
        parallelism = DataContext.get_current().parallelism
    tasks = datasource.get_read_tasks(parallelism)
    if not tasks:
        raise ValueError(
            f"datasource {datasource.get_name()} produced no read tasks")
    return Dataset([Read(tasks=tasks)])
