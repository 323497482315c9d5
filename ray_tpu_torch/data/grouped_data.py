"""GroupedData — the result of Dataset.groupby(key).

Role-equivalent to the reference's GroupedData (ref:
python/ray/data/grouped_data.py — aggregate/count/sum/min/max/mean/std
and map_groups).  Execution is a hash-partitioned exchange through the
object plane: aggregations pre-combine inside the map tasks so only
(key, accumulator) pairs cross the shuffle; map_groups moves whole rows
(it needs them) via the generic hash exchange.  Both stages submit
under the streaming byte budget (Dataset._run_stage_bounded).
Counterpart of ``ray_tpu/data/grouped_data.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Union

from .aggregate import (AggregateFn, Count, Max, Mean, Min, Std, Sum)
from .block import build_block
from .dataset import (Dataset, _groupby_map, _groupby_reduce, _key_fn,
                      _map_groups_reduce)


class GroupedData:
    def __init__(self, dataset: Dataset, key: Union[str, Callable]):
        self._ds = dataset
        self._key = key

    def __repr__(self):
        return f"GroupedData(key={self._key!r}, ds={self._ds!r})"

    # ---------------------------------------------------------- aggregate
    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        """One output row per key: {key, agg1.name: v1, ...}; output is
        a Dataset so further transforms/consumption stream as usual."""
        if not aggs:
            raise ValueError("aggregate() needs at least one "
                             "AggregateFn")
        ds = self._ds
        key_name = self._key if isinstance(self._key, str) else None
        if not ds._has_runtime():
            key = _key_fn(self._key)
            accs: dict = {}
            for row in ds.iter_rows():
                k = key(row)
                cur = accs.get(k)
                if cur is None:
                    cur = accs[k] = [a.init() for a in aggs]
                for i, a in enumerate(aggs):
                    cur[i] = a.accumulate_row(cur[i], row)
            rows = []
            for k in sorted(accs, key=lambda v: (str(type(v)), v)):
                row = {key_name or "key": k}
                for a, acc in zip(aggs, accs[k]):
                    row[a.name] = a.finalize(acc)
                rows.append(row)
            return Dataset._from_materialized(
                [build_block(rows)] if rows else [], ds._window)

        import ray_tpu_torch
        from ..core import serialization

        if callable(self._key):
            serialization.ensure_code_portable(self._key)
        for a in aggs:
            for f in (a.init, a.accumulate_row, a.merge, a.finalize):
                serialization.ensure_code_portable(f)
        n_out = max(len(ds._sources), 1)
        map_fn = ray_tpu_torch.remote(_groupby_map).options(
            num_returns=n_out)
        reduce_fn = ray_tpu_torch.remote(_groupby_reduce)
        return ds._exchange_stages(
            n_out,
            lambda _i, src: map_fn.remote(src, ds._ops, n_out,
                                          self._key, list(aggs)),
            lambda j, map_out: reduce_fn.remote(
                key_name, list(aggs), *[m[j] for m in map_out]))

    # ---------------------------------------------------------- shortcuts
    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on=None) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on=None) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on=None) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on=None) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on=None, ddof: int = 1) -> Dataset:
        return self.aggregate(Std(on, ddof))

    # --------------------------------------------------------- map_groups
    def map_groups(self, fn: Callable[[list], Any]) -> Dataset:
        """Apply ``fn(rows_of_one_group) -> row | list[row]`` per group
        (ref: grouped_data.py map_groups).  Whole rows hash-exchange to
        the group's partition."""
        ds = self._ds
        if not ds._has_runtime():
            key = _key_fn(self._key)
            groups: dict = {}
            for row in ds.iter_rows():
                groups.setdefault(key(row), []).append(row)
            rows = []
            for k in sorted(groups, key=lambda v: (str(type(v)), v)):
                res = fn(groups[k])
                rows.extend(res if isinstance(res, list) else [res])
            return Dataset._from_materialized(
                [build_block(rows)] if rows else [], ds._window)

        import ray_tpu_torch
        from ..core import serialization
        from .dataset import _shuffle_map

        if callable(self._key):
            serialization.ensure_code_portable(self._key)
        serialization.ensure_code_portable(fn)
        n_out = max(len(ds._sources), 1)
        map_fn = ray_tpu_torch.remote(_shuffle_map).options(
            num_returns=n_out)
        reduce_fn = ray_tpu_torch.remote(_map_groups_reduce)
        return ds._exchange_stages(
            n_out,
            lambda _i, src: map_fn.remote(src, ds._ops, n_out, "hash",
                                          None, self._key, None),
            lambda j, map_out: reduce_fn.remote(
                self._key, fn, *[m[j] for m in map_out]))
