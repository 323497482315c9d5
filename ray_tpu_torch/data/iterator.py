"""DataIterator — a per-consumer streaming shard handle.

Role-equivalent to the reference's DataIterator returned by
``Dataset.streaming_split`` (ref: python/ray/data/iterator.py,
_internal/execution/streaming_split coordination): a lightweight handle
a trainer ships to one rank, exposing batch iteration over that rank's
share of the blocks.  Each training worker iterates its own shard with
``prefetch_blocks`` pulling ahead on a feeder thread, then hands
batches to ``train.iter_device_batches``, which overlaps the copy of
batch N+1 onto the card with step N's compute — the full zero-stall
ingest chain.  Counterpart of ``ray_tpu/data/iterator.py``.

The iterator is picklable (it carries the shard Dataset's source thunks
and op chain, not any runtime state), so the driver can build shards
with locality hints and pass one to each remote training worker.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional


class DataIterator:
    """Streaming view over one shard of a Dataset.

    Re-iterable: each ``iter_batches``/``iter_rows`` call re-executes
    the shard's block tasks (one pass per epoch)."""

    def __init__(self, dataset, locality_node: Optional[str] = None):
        self._dataset = dataset
        if locality_node:
            dataset._locality_node = locality_node

    @property
    def locality_node(self) -> Optional[str]:
        return self._dataset._locality_node

    def num_blocks(self) -> int:
        return self._dataset.num_blocks()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_blocks: int = 2) -> Iterator[Any]:
        """Vectorized batches over this shard; prefetch defaults ON
        (the consumer is a training loop — block tasks + object pulls
        should overlap its step time)."""
        return self._dataset.iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last, prefetch_blocks=prefetch_blocks)

    def iter_rows(self) -> Iterator[Any]:
        return self._dataset.iter_rows()

    def materialize(self):
        """Pull the shard into driver memory (tests/debug)."""
        return self._dataset.materialize()

    def __repr__(self):
        loc = self._dataset._locality_node
        return (f"DataIterator(blocks={self._dataset.num_blocks()}"
                + (f", node={loc[:8]}" if loc else "") + ")")
