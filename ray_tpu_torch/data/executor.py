"""Streaming execution of Dataset plans (port of ray_tpu/data/executor.py).

Reference analogue: data/_internal/execution/streaming_executor.py:48 —
a thread running a PhysicalOperator graph with backpressure. Here the
plan is compiled into **fused map stages** (consecutive row/batch ops
collapse into one function, the reference's operator-fusion rule) and
executed either:

  - as tasks of the port's core, one per input block, with a bounded in-flight
    window (backpressure) when a cluster is initialized; or
  - inline in a thread pool (pure-local iteration, zero-setup mode).

All-to-all ops (repartition/shuffle/sort) are barrier stages that
materialize their input.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.datasource import ReadTask


# -- logical ops ------------------------------------------------------------

class LogicalOp:
    pass


@dataclass
class Read(LogicalOp):
    tasks: list = field(default_factory=list)  # list[ReadTask]


@dataclass
class InputData(LogicalOp):
    blocks: list = field(default_factory=list)


@dataclass
class MapBatches(LogicalOp):
    fn: Callable
    batch_size: int | None = None
    batch_format: str = "numpy"
    fn_constructor: Callable | None = None  # class-based UDF (actor-ish)
    # "actors" / ActorPoolStrategy: run this stage on a managed actor
    # pool (ray_tpu_torch.data.actor_pool — the reference's
    # ActorPoolMapOperator). None = stateless tasks/threads.
    compute: Any = None
    # Zero-copy batches (reference: map_batches(zero_copy_batch=True)):
    # a batch that is one contiguous run of a source block is passed as
    # a SLICE (arrow slice / numpy view) instead of a copy. The UDF must
    # not mutate it in place.
    zero_copy_batch: bool = False


@dataclass
class MapRows(LogicalOp):
    fn: Callable


@dataclass
class Filter(LogicalOp):
    fn: Callable


@dataclass
class FlatMap(LogicalOp):
    fn: Callable


@dataclass
class AddColumn(LogicalOp):
    name: str
    fn: Callable


@dataclass
class DropColumns(LogicalOp):
    cols: tuple


@dataclass
class SelectColumns(LogicalOp):
    cols: tuple


@dataclass
class RenameColumns(LogicalOp):
    mapping: dict


@dataclass
class Limit(LogicalOp):
    n: int


@dataclass
class Repartition(LogicalOp):
    n: int


@dataclass
class RandomShuffle(LogicalOp):
    seed: int | None = None


@dataclass
class RandomizeBlockOrder(LogicalOp):
    """Shuffle BLOCK order only (reference: randomize_block_order —
    cheap decorrelation without the row-level shuffle's full repack)."""

    seed: int | None = None


@dataclass
class Sort(LogicalOp):
    key: str
    descending: bool = False


@dataclass
class UnionOp(LogicalOp):
    others: list = field(default_factory=list)  # list[list[LogicalOp]]


@dataclass
class ZipOp(LogicalOp):
    other: list = field(default_factory=list)  # plan


FUSABLE = (MapBatches, MapRows, Filter, FlatMap, AddColumn, DropColumns,
           SelectColumns, RenameColumns)


# -- fused stage execution ---------------------------------------------------

def _apply_op(op, blocks: Iterator[Block]) -> Iterator[Block]:
    if isinstance(op, MapBatches):
        fn = op.fn
        if op.fn_constructor is not None:
            if op.compute is not None:
                # compute='actors' inline fallback: amortize the
                # constructor across blocks (instance shared by the
                # local thread pool — actors give true isolation).
                inst = getattr(op, "_cached_inst", None)
                if inst is None:
                    inst = op.fn_constructor()
                    op._cached_inst = inst
            else:
                inst = op.fn_constructor()
            fn = inst.__call__ if callable(inst) else inst
        for block in _rebatch(blocks, op.batch_size,
                              zero_copy=op.zero_copy_batch):
            batch = BlockAccessor(block).to_batch(op.batch_format)
            out = fn(batch)
            if out is None:
                continue
            yield BlockAccessor.batch_to_block(out)
    elif isinstance(op, MapRows):
        for block in blocks:
            rows = [op.fn(r) for r in BlockAccessor(block).iter_rows()]
            yield BlockAccessor.from_rows(rows)
    elif isinstance(op, Filter):
        for block in blocks:
            acc = BlockAccessor(block)
            keep = np.asarray(
                [bool(op.fn(r)) for r in acc.iter_rows()], dtype=bool
            )
            if keep.any():
                yield acc.take_indices(np.nonzero(keep)[0])
    elif isinstance(op, FlatMap):
        for block in blocks:
            rows = []
            for r in BlockAccessor(block).iter_rows():
                rows.extend(op.fn(r))
            if rows:
                yield BlockAccessor.from_rows(rows)
    elif isinstance(op, AddColumn):
        for block in blocks:
            cols = BlockAccessor(block).to_numpy()
            cols[op.name] = np.asarray(op.fn(cols))
            yield cols
    elif isinstance(op, DropColumns):
        for block in blocks:
            cols = BlockAccessor(block).to_numpy()
            yield {k: v for k, v in cols.items() if k not in op.cols}
    elif isinstance(op, SelectColumns):
        for block in blocks:
            cols = BlockAccessor(block).to_numpy()
            yield {k: cols[k] for k in op.cols}
    elif isinstance(op, RenameColumns):
        for block in blocks:
            cols = BlockAccessor(block).to_numpy()
            yield {op.mapping.get(k, k): v for k, v in cols.items()}
    else:  # pragma: no cover
        raise TypeError(f"not a fusable op: {op}")


def _rebatch(blocks: Iterator[Block], batch_size: int | None,
             zero_copy: bool = False) -> Iterator[Block]:
    """Re-chunk a block stream to exactly ``batch_size`` rows (last batch
    may be short). None → pass blocks through unchanged. Slices directly
    out of the buffered blocks — only the emitted batch is materialized,
    so the pass stays O(rows) regardless of block/batch size ratio."""
    if batch_size is None:
        yield from blocks
        return
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    buf: deque[tuple[Block, int]] = deque()  # (block, consumed-offset)
    buffered = 0

    def emit(n: int) -> Block:
        parts = []
        need = n
        while need:
            blk, off = buf[0]
            acc = BlockAccessor(blk)
            take = min(acc.num_rows() - off, need)
            parts.append(acc.slice(off, off + take))
            if off + take == acc.num_rows():
                buf.popleft()
            else:
                buf[0] = (blk, off + take)
            need -= take
        if zero_copy and len(parts) == 1:
            # One contiguous run of a source block: hand out the slice
            # itself (arrow slice / numpy view — no bytes move). Caller
            # opted in and must not mutate (reference:
            # map_batches(zero_copy_batch=True) semantics).
            return parts[0]
        # Concat (even one part): it copies numpy slices, so the
        # emitted batch never aliases buffered source blocks — consumers
        # may mutate batches in place without corrupting the lazy plan.
        return BlockAccessor.concat(parts)

    for block in blocks:
        n = BlockAccessor(block).num_rows()
        if n == 0:
            continue
        buf.append((block, 0))
        buffered += n
        while buffered >= batch_size:
            yield emit(batch_size)
            buffered -= batch_size
    if buffered:
        yield emit(buffered)


def run_fused_stage(source, ops: list) -> list[Block]:
    """Run a chain of fusable ops over one input (a ReadTask or a block).
    This is the function shipped to the cluster as one task."""
    if isinstance(source, ReadTask):
        blocks: Iterator[Block] = source()
    else:
        blocks = iter([source])
    for op in ops:
        blocks = _apply_op(op, blocks)
    return list(blocks)


# -- streaming driver --------------------------------------------------------

def _bounded_map(inputs: list, fn: Callable, parallelism: int,
                 use_tasks: bool, max_bytes: "int | None" = None,
                 stats: "dict | None" = None) -> Iterator[list[Block]]:
    """Apply ``fn`` over ``inputs`` with at most ``parallelism`` in
    flight AND at most ``max_bytes`` of completed-but-unconsumed output
    buffered; yield results in submission order (the reference's
    resource-budget OpState queues, streaming_executor.py:48 — bounded
    by BYTES, not count). The local thread path enforces the byte
    budget exactly (outputs buffer in driver memory); the cluster-task
    path keeps the count window (completed blocks wait in the object
    store, where eviction/spilling governs memory, not this driver)."""
    if parallelism <= 1 or len(inputs) <= 1:
        for item in inputs:
            yield fn(item)
        return
    if use_tasks:
        import ray_tpu_torch

        remote_fn = ray_tpu_torch.remote(fn)
        pending: dict[int, Any] = {}
        next_submit = 0
        next_yield = 0
        while next_yield < len(inputs):
            while next_submit < len(inputs) and len(pending) < parallelism:
                pending[next_submit] = remote_fn.remote(inputs[next_submit])
                next_submit += 1
            yield ray_tpu_torch.get(pending.pop(next_yield))
            next_yield += 1
    else:
        import threading

        lock = threading.Lock()
        buffered = {"bytes": 0, "peak": 0}

        def run_sized(item):
            out = fn(item)
            n = sum(BlockAccessor(b).size_bytes() for b in out)
            with lock:
                buffered["bytes"] += n
                buffered["peak"] = max(buffered["peak"], buffered["bytes"])
            return out, n

        with ThreadPoolExecutor(max_workers=parallelism) as pool:
            futs = {}
            next_submit = 0
            next_yield = 0
            while next_yield < len(inputs):
                while next_submit < len(inputs) and len(futs) < parallelism:
                    if max_bytes is not None and futs:
                        with lock:
                            over = buffered["bytes"] >= max_bytes
                        if over:
                            # Budget exhausted: stop producing until the
                            # consumer drains (futs is non-empty, so the
                            # yield below always makes progress).
                            break
                    futs[next_submit] = pool.submit(run_sized,
                                                    inputs[next_submit])
                    next_submit += 1
                out, n = futs.pop(next_yield).result()
                with lock:
                    buffered["bytes"] -= n
                next_yield += 1
                yield out
            if stats is not None:
                stats["max_bytes_buffered"] = max(
                    stats.get("max_bytes_buffered", 0), buffered["peak"])


def execute_plan(plan: list, ctx) -> Iterator[Block]:
    """Stream blocks out of a logical plan."""
    stats = getattr(ctx, "stats", None)
    if stats is not None:
        # Per-run high-water mark: a smaller run after a larger one must
        # not report the stale peak.
        stats.pop("max_bytes_buffered", None)
    i = 0
    stream: Iterator[Block] | None = None
    while i < len(plan):
        op = plan[i]
        if isinstance(op, (Read, InputData)):
            # Fuse the longest run of fusable ops after the source.
            j = i + 1
            fused = []
            seen_pool = False
            while j < len(plan) and isinstance(plan[j], FUSABLE):
                nxt = plan[j]
                if isinstance(nxt, MapBatches) and nxt.compute is not None:
                    if seen_pool:
                        # A second pool stage keeps its OWN strategy:
                        # stop fusing so each pool honors its
                        # size/resource request.
                        break
                    seen_pool = True
                fused.append(nxt)
                j += 1
            inputs = op.tasks if isinstance(op, Read) else op.blocks
            use_tasks = ctx.use_tasks and _cluster_up()

            pool_op = next(
                (f for f in fused
                 if isinstance(f, MapBatches) and f.compute is not None),
                None)
            if pool_op is not None and use_tasks:
                # Actor-pool stage (reference:
                # actor_pool_map_operator.py): class UDFs build once per
                # pool worker; blocks stream through the pool with
                # backlog-driven scale-up and restart-on-death. The pool
                # is constructed INSIDE the generator: an abandoned or
                # failing plan must not leak live actors.
                from ray_tpu_torch.data.actor_pool import (ActorPool,
                                                     resolve_strategy)

                strategy = resolve_strategy(pool_op.compute)

                def gen_pool(inputs=inputs, strategy=strategy,
                             _fused=tuple(fused)):
                    pool = ActorPool(strategy, _fused, ctx.parallelism)
                    try:
                        for out in pool.map(list(inputs)):
                            yield from out
                    finally:
                        pool.shutdown()
                        if getattr(ctx, "stats", None) is not None:
                            ctx.stats["actor_pool"] = pool.stats

                stream = gen_pool()
                i = j
                continue
            if pool_op is not None:
                import warnings

                warnings.warn(
                    "map_batches(compute='actors') without an initialized "
                    "cluster runs inline; the class UDF is cached per "
                    "stage (shared across the local thread pool)",
                    stacklevel=2)

            def run(src, _fused=tuple(fused)):
                return run_fused_stage(src, list(_fused))

            def gen(inputs=inputs, run=run, use_tasks=use_tasks):
                for out in _bounded_map(
                        list(inputs), run, ctx.parallelism, use_tasks,
                        max_bytes=getattr(ctx, "target_max_bytes_in_flight",
                                          None),
                        stats=getattr(ctx, "stats", None)):
                    yield from out

            stream = gen()
            i = j
        elif isinstance(op, FUSABLE):
            stream = _apply_op(op, stream)
            i += 1
        elif isinstance(op, Limit):
            stream = _limit_stream(stream, op.n)
            i += 1
        elif isinstance(op, Repartition):
            blocks = list(stream)
            stream = iter(_repartition(blocks, op.n))
            i += 1
        elif isinstance(op, RandomShuffle):
            blocks = list(stream)
            stream = iter(_shuffle(blocks, op.seed))
            i += 1
        elif isinstance(op, RandomizeBlockOrder):
            blocks = list(stream)
            import numpy as _np

            _np.random.default_rng(op.seed).shuffle(blocks)
            stream = iter(blocks)
            i += 1
        elif isinstance(op, Sort):
            blocks = list(stream)
            stream = iter(_sort(blocks, op.key, op.descending))
            i += 1
        elif isinstance(op, UnionOp):
            streams = [stream] + [execute_plan(p, ctx) for p in op.others]

            def chain(streams=streams):
                for s in streams:
                    yield from s

            stream = chain()
            i += 1
        elif isinstance(op, ZipOp):
            stream = _zip_streams(stream, execute_plan(op.other, ctx))
            i += 1
        else:
            raise TypeError(f"unknown logical op {op}")
    return stream if stream is not None else iter(())


def _cluster_up() -> bool:
    try:
        import ray_tpu_torch

        return ray_tpu_torch.is_initialized()
    except Exception:
        return False


def _limit_stream(stream, n):
    remaining = n
    for block in stream:
        if remaining <= 0:
            return
        acc = BlockAccessor(block)
        if acc.num_rows() <= remaining:
            remaining -= acc.num_rows()
            yield block
        else:
            yield acc.slice(0, remaining)
            return


def _repartition(blocks, n):
    merged = BlockAccessor.concat(blocks)
    acc = BlockAccessor(merged)
    total = acc.num_rows()
    per = total // n
    extra = total % n
    out, start = [], 0
    for k in range(n):
        size = per + (1 if k < extra else 0)
        out.append(acc.slice(start, start + size))
        start += size
    return out


def _shuffle(blocks, seed):
    merged = BlockAccessor.concat(blocks)
    acc = BlockAccessor(merged)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(acc.num_rows())
    return [acc.take_indices(idx)]


def _sort(blocks, key, descending):
    merged = BlockAccessor.concat(blocks)
    acc = BlockAccessor(merged)
    col = acc.to_numpy()[key]
    idx = np.argsort(col, kind="stable")
    if descending:
        idx = idx[::-1]
    return [acc.take_indices(idx)]


def _zip_streams(a, b):
    abuf = _RowBuffer(a)
    bbuf = _RowBuffer(b)
    while True:
        blk_a = abuf.next_chunk()
        if blk_a is None:
            break
        n = BlockAccessor(blk_a).num_rows()
        blk_b = bbuf.take(n)
        if blk_b is None:
            raise ValueError("zip: datasets have different lengths")
        cols = dict(BlockAccessor(blk_a).to_numpy())
        for k, v in BlockAccessor(blk_b).to_numpy().items():
            name = k
            while name in cols:
                name = name + "_1"
            cols[name] = v
        yield cols
    if bbuf.take(1) is not None:
        raise ValueError("zip: datasets have different lengths")


class _RowBuffer:
    def __init__(self, stream):
        self._stream = stream
        self._buf = []
        self._n = 0

    def next_chunk(self):
        if self._buf:
            blk = self._buf.pop(0)
            self._n -= BlockAccessor(blk).num_rows()
            return blk
        return next(self._stream, None)

    def take(self, n):
        while self._n < n:
            blk = next(self._stream, None)
            if blk is None:
                return None
            self._buf.append(blk)
            self._n += BlockAccessor(blk).num_rows()
        merged = BlockAccessor.concat(self._buf)
        acc = BlockAccessor(merged)
        out = acc.slice(0, n)
        rest = acc.slice(n, acc.num_rows())
        self._buf = [rest] if BlockAccessor(rest).num_rows() else []
        self._n = BlockAccessor(rest).num_rows() if self._buf else 0
        return out
