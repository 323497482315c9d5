"""Trace span contexts and serve request scopes.

A copy of ``ray_tpu/util/tracing.py``.  A span context is a
(trace_id, span_id) pair in a ``contextvars.ContextVar``: every thread
gets its own, and an asyncio task a copy of its spawner's.
``request_scope(rid)`` makes a serve request id the active context, so
``spans.record_span`` tags every span recorded inside it with the id
and ``LLMDeployment`` hands the id to the generation engine, whose
waiting/prefill/decode spans then carry it.  The task-submission half
(injecting the context into task specs, the worker's child context)
arrives with the runtime slice; ``trace_tree`` reassembles task records.

Usage::

    with tracing.request_scope("req-1"):
        for frame in deployment(payload):
            ...
"""

from __future__ import annotations

import contextvars
import os
import time
from typing import Any, Dict, List, Optional

_current: "contextvars.ContextVar[Optional[Dict[str, str]]]" = \
    contextvars.ContextVar("rt_span_ctx", default=None)


def _new_id(nbytes: int = 8) -> str:
    return os.urandom(nbytes).hex()


def current_span_context() -> Optional[Dict[str, str]]:
    """{"trace_id", "span_id"} of the active span, or None."""
    return _current.get()


def current_request_id() -> Optional[str]:
    """The request id of the active serve request context, or None.
    Request ids are minted at the ingress proxies (or honored from the
    client's ``X-RT-Request-Id`` header / ``rt-request-id`` gRPC
    metadata) and ride the span context through handle dispatch into
    the replica and the generation engine."""
    ctx = _current.get()
    return ctx.get("request_id") if ctx else None


class start_span:
    """Context manager opening a span under the current one.  On exit
    the finished span is also recorded into the process span ring
    (util/spans.py) so it shows up in the cluster timeline."""

    def __init__(self, name: str):
        self.name = name
        self._prev: Optional[Dict[str, str]] = None
        self.ctx: Dict[str, str] = {}

    def __enter__(self) -> "start_span":
        parent = _current.get()
        self.ctx = {
            "trace_id": (parent or {}).get("trace_id") or _new_id(16),
            "span_id": _new_id(),
        }
        if parent:
            self.ctx["parent_span_id"] = parent["span_id"]
            if parent.get("request_id"):
                self.ctx["request_id"] = parent["request_id"]
        self._prev = parent
        self._t0 = time.time()
        _current.set(self.ctx)
        return self

    def __exit__(self, *exc):
        _current.set(self._prev)
        try:
            from . import spans as _spans

            _spans.record_span(self.name, self._t0, time.time(),
                               cat="span", trace=self.ctx)
        except Exception:
            pass  # the timeline must never fail user code
        return False


class request_scope:
    """Context manager establishing a serve request context: the
    request id (plus a trace id derived from it) becomes the active
    span context, so ``spans.record_span`` auto-tags every span
    recorded inside with the request id and ``maybe_inject`` carries
    it across the actor-task hop into the replica.

    Re-entrant in the nesting sense: entering with the SAME id under
    an existing scope keeps the parent linkage; entering with a new id
    starts a fresh trace.  ``rid=None`` keeps any existing context
    untouched (no-op scope) — callers without an id never pay for one.
    """

    def __init__(self, rid: Optional[str]):
        self.rid = rid
        self._prev: Optional[Dict[str, str]] = None
        self._set = False

    def __enter__(self) -> "request_scope":
        if not self.rid:
            return self
        parent = _current.get()
        ctx = {"trace_id": (parent or {}).get("trace_id")
               or f"req-{self.rid}",
               "span_id": _new_id(),
               "request_id": self.rid}
        if parent:
            ctx["parent_span_id"] = parent["span_id"]
        self._prev = parent
        self._set = True
        _current.set(ctx)
        return self

    def __exit__(self, *exc):
        if self._set:
            _current.set(self._prev)
        return False


def trace_tree(task_records: List[Dict[str, Any]],
               trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Reassemble spans from the controller's task records (e.g.
    ``state.list_tasks()``): {trace_id: [span, ...]} with each span
    {span_id, parent_span_id, name, start, end, task_id}."""
    spans: Dict[str, List[Dict[str, Any]]] = {}
    for rec in task_records:
        tid = rec.get("trace_id")
        if not tid or (trace_id and tid != trace_id):
            continue
        times = list((rec.get("times") or {}).values()) or [0.0]
        spans.setdefault(tid, []).append({
            "trace_id": tid, "span_id": rec.get("span_id"),
            "parent_span_id": rec.get("parent_span_id", ""),
            "name": rec.get("name"), "task_id": rec.get("task_id"),
            "start": min(times), "end": max(times)})
    return spans
