"""DataContext — per-process execution knobs for Dataset pipelines.

Role-equivalent to the reference's DataContext (ref:
python/ray/data/context.py) reduced to the knobs the streaming
executor actually uses: the in-flight byte budget (backpressure), the
task-concurrency cap, and the starting block-size estimate the budget
uses before it has observed real blocks.  Counterpart of
``ray_tpu/data/context.py``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class DataContext:
    # Backpressure: total estimated bytes of submitted-but-unconsumed
    # blocks stays under this (ref: streaming_executor resource manager
    # + backpressure policies).
    max_in_flight_bytes: int = 256 * 1024 * 1024
    # Hard cap on concurrently running block tasks.
    max_concurrent_tasks: int = 16
    # Block size assumed until real completed-block sizes are observed.
    initial_block_size_estimate: int = 8 * 1024 * 1024

    _local = threading.local()

    @classmethod
    def get_current(cls) -> "DataContext":
        ctx = getattr(cls._local, "ctx", None)
        if ctx is None:
            ctx = cls._local.ctx = cls()
        return ctx
