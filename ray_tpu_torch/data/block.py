"""Block: the unit of data movement in ray_tpu_torch.data (port of
ray_tpu/data/block.py).

The reference's blocks are Arrow tables in plasma (reference:
python/ray/data/block.py, arrow_block.py — BlockAccessor dispatches on
block type). Same design here: a block is a ``pyarrow.Table`` (tabular
sources) or a dict of numpy arrays (tensor batches); ``BlockAccessor``
gives a uniform view. Numpy dict blocks are first-class (not an
afterthought) because the consumer is a training step that wants
fixed-shape host arrays to copy to the device.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


Block = Any  # pyarrow.Table | dict[str, np.ndarray] | list (rows)


def _is_table(block) -> bool:
    return pa is not None and isinstance(block, pa.Table)


class BlockAccessor:
    """Uniform view over a block (reference analogue:
    data/block.py BlockAccessor.for_block)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_rows(rows: list) -> Block:
        """Rows (dicts or scalars) → canonical block."""
        if not rows:
            return {}
        if isinstance(rows[0], dict):
            cols = {}
            for k in rows[0]:
                vals = [r[k] for r in rows]
                try:
                    cols[k] = np.asarray(vals)
                except Exception:
                    cols[k] = np.asarray(vals, dtype=object)
            return cols
        return {"item": np.asarray(rows)}

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        if _is_table(batch) or isinstance(batch, dict):
            return batch
        if isinstance(batch, np.ndarray):
            return {"item": batch}
        if isinstance(batch, list):
            return BlockAccessor.from_rows(batch)
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return pa.Table.from_pandas(batch, preserve_index=False)
        except ImportError:
            pass
        raise TypeError(f"cannot convert {type(batch)} to a block")

    # -- introspection -----------------------------------------------------

    def num_rows(self) -> int:
        b = self._block
        if _is_table(b):
            return b.num_rows
        if isinstance(b, dict):
            if not b:
                return 0
            return len(next(iter(b.values())))
        return len(b)

    def size_bytes(self) -> int:
        b = self._block
        if _is_table(b):
            return b.nbytes
        if isinstance(b, dict):
            return sum(
                v.nbytes if isinstance(v, np.ndarray) else 64
                for v in b.values()
            )
        return 64 * len(b)

    def schema(self):
        b = self._block
        if _is_table(b):
            return b.schema
        if isinstance(b, dict):
            return {
                k: getattr(v, "dtype", type(v).__name__) for k, v in b.items()
            }
        return None

    def column_names(self) -> list[str]:
        b = self._block
        if _is_table(b):
            return b.column_names
        if isinstance(b, dict):
            return list(b.keys())
        return []

    # -- conversion --------------------------------------------------------

    def to_numpy(self) -> dict[str, np.ndarray]:
        b = self._block
        if _is_table(b):
            out = {}
            for name in b.column_names:
                col = b.column(name)
                try:
                    out[name] = col.to_numpy(zero_copy_only=False)
                except Exception:
                    out[name] = np.asarray(col.to_pylist(), dtype=object)
            return out
        if isinstance(b, dict):
            return {k: np.asarray(v) for k, v in b.items()}
        return BlockAccessor(BlockAccessor.from_rows(list(b))).to_numpy()

    def to_arrow(self):
        b = self._block
        if _is_table(b):
            return b
        if pa is None:
            raise ImportError("pyarrow not available")
        return pa.table({k: list(np.asarray(v)) for k, v in self.to_numpy().items()})

    def to_pandas(self):
        import pandas as pd

        if _is_table(self._block):
            return self._block.to_pandas()
        return pd.DataFrame(self.to_numpy())

    def to_batch(self, batch_format: str = "numpy"):
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format == "pyarrow":
            return self.to_arrow()
        if batch_format == "pandas":
            return self.to_pandas()
        raise ValueError(f"unknown batch_format {batch_format!r}")

    def iter_rows(self) -> Iterable[dict]:
        cols = self.to_numpy()
        names = list(cols)
        n = self.num_rows()
        for i in range(n):
            row = {k: cols[k][i] for k in names}
            yield row["item"] if names == ["item"] else row

    # -- slicing / combining ----------------------------------------------

    def slice(self, start: int, end: int) -> Block:
        b = self._block
        if _is_table(b):
            return b.slice(start, end - start)
        if isinstance(b, dict):
            return {k: v[start:end] for k, v in b.items()}
        return b[start:end]

    def take_indices(self, idx: np.ndarray) -> Block:
        b = self._block
        if _is_table(b):
            return b.take(pa.array(idx))
        if isinstance(b, dict):
            return {k: np.asarray(v)[idx] for k, v in b.items()}
        return [b[i] for i in idx]

    @staticmethod
    def concat(blocks: list[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return {}
        first = blocks[0]
        if _is_table(first):
            blocks = [b if _is_table(b) else BlockAccessor(b).to_arrow() for b in blocks]
            return pa.concat_tables(blocks, promote_options="default")
        if isinstance(first, dict):
            # Mixed kinds coerce to the first block's kind (a union of a
            # numpy source with a parquet source is legitimate).
            blocks = [
                b if isinstance(b, dict) else BlockAccessor(b).to_numpy()
                for b in blocks
            ]
            keys = set(first.keys())
            for b in blocks[1:]:
                if set(b.keys()) != keys:
                    raise ValueError(
                        "cannot concat blocks with differing schemas: "
                        f"{sorted(keys)} vs {sorted(b.keys())}"
                    )
            return {
                k: np.concatenate([np.asarray(b[k]) for b in blocks])
                for k in first.keys()
            }
        out = []
        for b in blocks:
            out.extend(b)
        return out


class BlockMetadata:
    """Size/schema summary travelling with block refs (reference analogue:
    data/block.py BlockMetadata)."""

    __slots__ = ("num_rows", "size_bytes", "schema", "input_files")

    def __init__(self, num_rows, size_bytes, schema=None, input_files=None):
        self.num_rows = num_rows
        self.size_bytes = size_bytes
        self.schema = schema
        self.input_files = input_files or []

    @staticmethod
    def for_block(block: Block) -> "BlockMetadata":
        acc = BlockAccessor(block)
        return BlockMetadata(acc.num_rows(), acc.size_bytes(), acc.schema())
