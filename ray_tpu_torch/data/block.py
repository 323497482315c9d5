"""Blocks — the unit of data movement and processing.

Role-equivalent to the reference's Block/BlockAccessor (ref:
python/ray/data/block.py; blocks there are Arrow tables).  A block is a
pyarrow.Table (columnar path), a dict of equal-length numpy arrays (the
tensor-batch path — Arrow can't hold multi-dimensional columns, and
training batches are exactly dicts of [N, ...] arrays), or a plain list
of rows (simple-object path); BlockAccessor normalizes all three.
Blocks travel through the shared-memory object plane as task returns,
so the Arrow/numpy paths are zero-copy from store to consumer.
Counterpart of ``ray_tpu/data/block.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Union

Block = Union["pyarrow.Table", Dict[str, Any], List[Any]]  # noqa: F821


class BlockAccessor:
    def __init__(self, block: Block):
        self._block = block
        self._is_arrow = type(block).__module__.startswith("pyarrow")
        self._is_tensor = isinstance(block, dict)

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        if self._is_arrow:
            return self._block.num_rows
        if self._is_tensor:
            return len(next(iter(self._block.values()))) \
                if self._block else 0
        return len(self._block)

    def iter_rows(self) -> Iterator[Any]:
        if self._is_arrow:
            for row in self._block.to_pylist():
                yield row
        elif self._is_tensor:
            keys = list(self._block)
            for i in range(self.num_rows()):
                yield {k: self._block[k][i] for k in keys}
        else:
            yield from self._block

    def slice(self, start: int, end: int) -> Block:
        if self._is_arrow:
            return self._block.slice(start, end - start)
        if self._is_tensor:
            return {k: v[start:end] for k, v in self._block.items()}
        return self._block[start:end]

    def to_arrow(self):
        import pyarrow as pa

        if self._is_arrow:
            return self._block
        if self._is_tensor:
            import numpy as np

            cols = {}
            for k, v in self._block.items():
                a = np.asarray(v)
                if a.ndim <= 1:
                    cols[k] = pa.array(a)
                elif a.ndim == 2:
                    # Fixed-shape tensors -> FixedSizeList columns (the
                    # reference stores these as ArrowTensorArray).
                    cols[k] = pa.FixedSizeListArray.from_arrays(
                        pa.array(a.reshape(-1)), a.shape[1])
                else:
                    cols[k] = pa.array(a.tolist())  # nested lists
            return pa.table(cols)
        rows = list(self._block)
        if rows and isinstance(rows[0], dict):
            return pa.Table.from_pylist(rows)
        return pa.table({"value": rows})

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_numpy_batch(self) -> Dict[str, Any]:
        import numpy as np

        if self._is_arrow:
            return {name: np.asarray(col)
                    for name, col in zip(self._block.column_names,
                                         self._block.columns)}
        if self._is_tensor:
            return {k: np.asarray(v) for k, v in self._block.items()}
        rows = list(self._block)
        if rows and isinstance(rows[0], dict):
            keys = rows[0].keys()
            return {k: np.asarray([r[k] for r in rows]) for k in keys}
        return {"value": np.asarray(rows)}

    def schema(self):
        if self._is_arrow:
            return self._block.schema
        if self._is_tensor:
            import numpy as np

            return {k: f"ndarray{tuple(np.asarray(v).shape[1:])}"
                    for k, v in self._block.items()}
        rows = list(self._block)
        if rows and isinstance(rows[0], dict):
            return {k: type(v).__name__ for k, v in rows[0].items()}
        return type(rows[0]).__name__ if rows else None

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Normalize a map_batches return (dict of arrays, pandas,
        arrow, or list) into a block."""
        import numpy as np

        mod = type(batch).__module__
        if mod.startswith("pyarrow"):
            return batch
        if mod.startswith("pandas"):
            import pyarrow as pa

            return pa.Table.from_pandas(batch, preserve_index=False)
        if isinstance(batch, dict):
            arrays = {k: np.asarray(v) for k, v in batch.items()}
            if any(a.ndim > 1 for a in arrays.values()):
                return arrays  # tensor-batch block (Arrow is 1-D only)
            import pyarrow as pa

            return pa.table(arrays)
        if isinstance(batch, list):
            return batch
        raise TypeError(f"unsupported batch type {type(batch)}")


def build_block(rows: List[Any]) -> Block:
    """Rows -> block; dict rows with array values become a tensor-batch
    block, other dict rows become Arrow, scalars stay a list."""
    if rows and isinstance(rows[0], dict):
        import numpy as np

        if any(isinstance(v, np.ndarray) and v.ndim >= 1
               for v in rows[0].values()):
            try:
                return {k: np.stack([r[k] for r in rows])
                        for k in rows[0]}
            except Exception:
                return rows
        try:
            import pyarrow as pa

            return pa.Table.from_pylist(rows)
        except Exception:
            return rows
    return list(rows)
