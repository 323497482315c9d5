"""ray_tpu_torch.data — block datasets with streaming task execution.

Counterpart of ``ray_tpu/data`` (ref: python/ray/data/: lazy plan +
StreamingExecutor + datasources), over the port's runtime.  Read APIs
build source thunks (one per file/fragment = one block); transforms
chain lazily; execution streams blocks through remote tasks.  The
modules import numpy and the standard library; ``pyarrow`` and
``pandas`` load inside the functions that need them.  A host without
them runs datasets of list blocks and of dict blocks with a
multi-dimensional column (tensor batches); as in the JAX package, a
``map_batches`` that returns only 1-D columns makes an Arrow block.
"""

from __future__ import annotations

import glob as _glob
from typing import Any, Dict, Iterable, List, Optional

from .aggregate import (AggregateFn, Count, Max, Mean, Min,  # noqa: F401
                        Std, Sum)
from .block import Block, BlockAccessor, build_block  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .grouped_data import GroupedData  # noqa: F401
from .iterator import DataIterator  # noqa: F401


def from_items(items: List[Any], *, parallelism: int = 4) -> Dataset:
    import numpy as np

    items = list(items)
    parts = np.array_split(np.arange(len(items)), max(1, min(
        parallelism, len(items) or 1)))
    sources = []
    for part in parts:
        chunk = [items[i] for i in part]
        sources.append(lambda c=chunk: build_block(c))
    return Dataset(sources)


def range(n: int, *, parallelism: int = 4) -> Dataset:  # noqa: A001
    import numpy as np

    bounds = np.linspace(0, n, max(1, parallelism) + 1, dtype=int)
    sources = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sources.append(lambda lo=int(lo), hi=int(hi):
                       [{"id": i} for i in __import__("builtins").range(lo, hi)])
    return Dataset(sources)


def read_parquet(paths, *, parallelism: int = 0) -> Dataset:
    files = _expand(paths, "*.parquet")

    def _mk(f):
        def load():
            import pyarrow.parquet as pq

            return pq.read_table(f)

        return load

    return Dataset([_mk(f) for f in files])


def read_csv(paths, *, parallelism: int = 0) -> Dataset:
    files = _expand(paths, "*.csv")

    def _mk(f):
        def load():
            import pyarrow.csv as pacsv

            return pacsv.read_csv(f)

        return load

    return Dataset([_mk(f) for f in files])


def read_json(paths, *, parallelism: int = 0) -> Dataset:
    files = _expand(paths, "*.json")

    def _mk(f):
        def load():
            import pyarrow.json as pajson

            return pajson.read_json(f)

        return load

    return Dataset([_mk(f) for f in files])


def read_numpy(paths, *, parallelism: int = 0) -> Dataset:
    files = _expand(paths, "*.npy")

    def _mk(f):
        def load():
            import numpy as np

            arr = np.load(f)
            return [{"data": row} for row in arr]

        return load

    return Dataset([_mk(f) for f in files])


def from_numpy(arr, *, parallelism: int = 4) -> Dataset:
    import numpy as np

    chunks = np.array_split(arr, max(1, parallelism))
    return Dataset([
        lambda c=c: [{"data": row} for row in c] for c in chunks])


def from_pandas(df) -> Dataset:
    import pyarrow as pa

    table = pa.Table.from_pandas(df, preserve_index=False)
    return Dataset([lambda t=table: t])


def from_arrow(table) -> Dataset:
    return Dataset([lambda t=table: t])


def _expand(paths, pattern: str) -> List[str]:
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(_glob.glob(os.path.join(p, pattern))))
        elif any(ch in p for ch in "*?["):
            files.extend(sorted(_glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no files matched {paths}")
    return files
