"""Span plane: a bounded per-process ring of finished spans.

A copy of ``ray_tpu/util/spans.py``.  Every process records short
span records (collective ops, goodput phases, train steps, the serving
engine's request spans, explicit ``tracing.start_span`` blocks) into a
bounded deque.  A span is a plain dict

    {"name", "cat", "start", "end", "pid",
     "trace_id", "span_id", "parent_span_id",   # when trace-linked
     "tags": {...}}                             # e.g. op/backend/world

with wall-clock (``time.time``) endpoints, so records of several
processes merge on one axis (``util/timeline.build_trace``).

Recording is always on (the ring is bounded and an append is a dict and
a deque op).  ``flush`` ships the ring to a cluster controller in the
JAX package; the port has no runtime yet, so it returns False, the JAX
package's own answer without a connected runtime.  The runtime slice
(ROADMAP Queue 1 item 5) wires it.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 4096


class SpanRing:
    """Thread-safe bounded ring of finished span records."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._spans: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self.total_recorded = 0

    def record(self, name: str, start: float, end: float, *,
               cat: str = "span",
               tags: Optional[Dict[str, Any]] = None,
               trace: Optional[Dict[str, str]] = None) -> None:
        """Append one finished span.  ``trace`` carries explicit
        {trace_id, span_id, parent_span_id}; when omitted, the span
        links under the caller's active tracing context (if any) so
        timeline flow arrows can connect it to its submitter."""
        ev: Dict[str, Any] = {"name": str(name), "cat": str(cat),
                              "start": float(start), "end": float(end),
                              "pid": os.getpid()}
        if trace is None:
            from . import tracing as _tracing

            cur = _tracing.current_span_context()
            if cur:
                ev["trace_id"] = cur["trace_id"]
                ev["parent_span_id"] = cur["span_id"]
                # Serve request context: every span recorded inside a
                # request_scope carries the request id, so `rt trace
                # <id>` can assemble the cross-process hop chain.
                if cur.get("request_id") and \
                        "request_id" not in (tags or {}):
                    tags = dict(tags or {})
                    tags["request_id"] = cur["request_id"]
            ev["span_id"] = _tracing._new_id()
        else:
            for k in ("trace_id", "span_id", "parent_span_id"):
                if trace.get(k):
                    ev[k] = trace[k]
        if tags:
            ev["tags"] = dict(tags)
        with self._lock:
            self._spans.append(ev)
            self.total_recorded += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_ring: Optional[SpanRing] = None
_ring_lock = threading.Lock()


def ring() -> SpanRing:
    """The process-global span ring (created on first use)."""
    global _ring
    if _ring is None:
        with _ring_lock:
            if _ring is None:
                _ring = SpanRing()
    return _ring


def reset() -> SpanRing:
    """Fresh global ring (tests)."""
    global _ring
    with _ring_lock:
        _ring = SpanRing()
    return _ring


def record_span(name: str, start: float, end: float, *,
                cat: str = "span",
                tags: Optional[Dict[str, Any]] = None,
                trace: Optional[Dict[str, str]] = None) -> None:
    """Append one span to the process-global ring (never raises)."""
    try:
        ring().record(name, start, end, cat=cat, tags=tags, trace=trace)
    except Exception:
        pass


def snapshot() -> List[Dict[str, Any]]:
    return ring().snapshot()


def flush(source: Optional[str] = None) -> bool:
    """Ship this process's ring to the controller of a connected
    runtime.  The port has no runtime yet, so there is none and nothing
    is sent: False, as the JAX package answers without one (ROADMAP
    Queue 1 item 5 wires it)."""
    return False
