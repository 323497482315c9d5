"""Shared bounded feeder-thread prefetcher.

A copy of ``ray_tpu/util/prefetch.py``, the producer-thread protocol
behind ``train.session.iter_device_batches``:

- a daemon feeder thread pulls from the source iterable (optionally
  mapping each item through ``transform``) into a bounded queue, whose
  depth is the backpressure window;
- exceptions forward through the queue and re-raise at the consumer;
- a consumer that abandons the iterator mid-stream does not strand the
  feeder: the generator's ``finally`` signals stop, drains the queue so
  a blocked put unblocks, and joins the thread;
- ``wait_cm`` (a context-manager factory) wraps only blocking dequeues,
  so a caller charges genuine starvation to a goodput phase without
  taxing the non-blocking path.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

_END = object()


def iter_prefetched(source: Iterable[Any], *, depth: int,
                    transform: Optional[Callable[[Any], Any]] = None,
                    wait_cm: Optional[Callable[[], Any]] = None,
                    thread_name: str = "rt-prefetch") -> Iterator[Any]:
    q: "_queue.Queue" = _queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put that aborts on stop: a consumer that drops the
        # iterator mid-stream must not leave this thread blocked on a
        # full queue forever.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except _queue.Full:
                continue
        return False

    def _feed():
        try:
            for item in source:
                if stop.is_set():
                    return
                if transform is not None:
                    item = transform(item)
                if not _put(item):
                    return
            _put(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            _put(e)

    t = threading.Thread(target=_feed, daemon=True, name=thread_name)
    t.start()
    try:
        while True:
            if wait_cm is None:
                item = q.get()
            else:
                try:
                    item = q.get_nowait()
                except _queue.Empty:
                    with wait_cm():  # genuinely starving: charge it
                        item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # Signal stop, drain whatever the feeder already queued so its
        # blocked put() unblocks immediately, then join briefly (the
        # feeder may still be inside a blocking source read; it is a
        # daemon and exits at its next stop check).
        stop.set()
        try:
            while True:
                q.get_nowait()
        except _queue.Empty:
            pass
        t.join(timeout=1.0)
