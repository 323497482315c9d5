"""Aggregation functions for Dataset.groupby / Dataset.aggregate.

Role-equivalent to the reference's AggregateFn family (ref:
python/ray/data/aggregate.py — AggregateFn with init/accumulate_row/
merge/finalize and the Count/Sum/Min/Max/Mean/Std built-ins).  The
accumulate/merge split matters here for the same reason it does
upstream: partial aggregation happens inside shuffle-map tasks so only
small accumulators cross the exchange, not raw rows.  Counterpart of
``ray_tpu/data/aggregate.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Union

from .dataset import _key_fn as _field


class AggregateFn:
    """init() -> accumulator; accumulate_row(acc, row) -> acc;
    merge(acc1, acc2) -> acc; finalize(acc) -> value."""

    def __init__(self, init: Callable[[], Any],
                 accumulate_row: Callable[[Any, Any], Any],
                 merge: Callable[[Any, Any], Any],
                 finalize: Callable[[Any], Any] = lambda a: a,
                 name: str = "agg()"):
        self.init = init
        self.accumulate_row = accumulate_row
        self.merge = merge
        self.finalize = finalize
        self.name = name


class Count(AggregateFn):
    def __init__(self):
        super().__init__(
            init=lambda: 0,
            accumulate_row=lambda a, _row: a + 1,
            merge=lambda a, b: a + b,
            name="count()")


class Sum(AggregateFn):
    def __init__(self, on: Optional[Union[str, Callable]] = None):
        get = _field(on)
        super().__init__(
            init=lambda: 0,
            accumulate_row=lambda a, row: a + get(row),
            merge=lambda a, b: a + b,
            name=f"sum({on})" if isinstance(on, str) else "sum()")


class Min(AggregateFn):
    def __init__(self, on: Optional[Union[str, Callable]] = None):
        get = _field(on)
        super().__init__(
            init=lambda: None,
            accumulate_row=lambda a, row:
                get(row) if a is None else min(a, get(row)),
            merge=lambda a, b:
                b if a is None else (a if b is None else min(a, b)),
            name=f"min({on})" if isinstance(on, str) else "min()")


class Max(AggregateFn):
    def __init__(self, on: Optional[Union[str, Callable]] = None):
        get = _field(on)
        super().__init__(
            init=lambda: None,
            accumulate_row=lambda a, row:
                get(row) if a is None else max(a, get(row)),
            merge=lambda a, b:
                b if a is None else (a if b is None else max(a, b)),
            name=f"max({on})" if isinstance(on, str) else "max()")


class Mean(AggregateFn):
    def __init__(self, on: Optional[Union[str, Callable]] = None):
        get = _field(on)
        super().__init__(
            init=lambda: (0, 0.0),                     # (count, sum)
            accumulate_row=lambda a, row: (a[0] + 1, a[1] + get(row)),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[1] / a[0] if a[0] else None,
            name=f"mean({on})" if isinstance(on, str) else "mean()")


class Std(AggregateFn):
    """Sample standard deviation via parallel Welford/Chan merge (the
    numerically-stable pairwise update the reference uses, ref:
    aggregate.py Std)."""

    def __init__(self, on: Optional[Union[str, Callable]] = None,
                 ddof: int = 1):
        get = _field(on)

        def acc_row(a, row):
            n, mean, m2 = a
            x = float(get(row))
            n += 1
            d = x - mean
            mean += d / n
            m2 += d * (x - mean)
            return (n, mean, m2)

        def merge(a, b):
            na, ma, m2a = a
            nb, mb, m2b = b
            if na == 0:
                return b
            if nb == 0:
                return a
            n = na + nb
            d = mb - ma
            return (n, ma + d * nb / n,
                    m2a + m2b + d * d * na * nb / n)

        super().__init__(
            init=lambda: (0, 0.0, 0.0),
            accumulate_row=acc_row,
            merge=merge,
            finalize=lambda a:
                math.sqrt(a[2] / (a[0] - ddof)) if a[0] > ddof else None,
            name=f"std({on})" if isinstance(on, str) else "std()")
