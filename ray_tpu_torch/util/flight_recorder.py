"""Flight recorder: a bounded in-process ring of telemetry events,
dumped to a file on an uncaught exception or SIGTERM.

A copy of ``ray_tpu/util/flight_recorder.py``.  Every process keeps a
small ring of recent events (phase changes, collective ops, trainer
state); ``install()`` hooks SIGTERM and uncaught exceptions so the ring
is written to ``<dump_dir>/<source>.json`` before the process dies, and
the file stays behind for triage of a preempted or crashed worker.

SIGKILL and ``os._exit`` cannot be hooked.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 1024


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 source: str = ""):
        self._lock = threading.Lock()
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        # Keyed last-value slots for high-frequency state ("the task
        # running right now"): one overwritten entry instead of a
        # ring-flooding append per transition.
        self._sticky: Dict[str, Dict[str, Any]] = {}
        self.source = source
        self.dump_dir: Optional[str] = None
        self.last_dump_path: Optional[str] = None

    def record(self, kind: str, **fields: Any) -> None:
        ev = {"ts": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)

    def note(self, key: str, **fields: Any) -> None:
        """Overwrite the keyed slot (hot-path state: cheap, unbounded
        frequency, never evicts ring context)."""
        entry = {"ts": time.time()}
        entry.update(fields)
        with self._lock:
            self._sticky[key] = entry

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def sticky(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._sticky)

    def dump(self, reason: str = "",
             path: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``path`` (default:
        ``<dump_dir>/<source>.json``) atomically; returns the path or
        None if there is nowhere to write."""
        if path is None:
            if not self.dump_dir:
                return None
            path = os.path.join(self.dump_dir,
                                f"{self.source or f'proc-{os.getpid()}'}"
                                f".json")
        payload = {"source": self.source, "pid": os.getpid(),
                   "reason": reason, "ts": time.time(),
                   "sticky": self.sticky(), "events": self.events()}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            return None
        self.last_dump_path = path
        return path


_recorder: Optional[FlightRecorder] = None
_rec_lock = threading.Lock()
_installed = False


def get() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _rec_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, **fields: Any) -> None:
    """Append one event to the process-global ring (never raises)."""
    try:
        get().record(kind, **fields)
    except Exception:
        pass


def note(key: str, **fields: Any) -> None:
    """Overwrite the process-global keyed slot (never raises)."""
    try:
        get().note(key, **fields)
    except Exception:
        pass


def install(dump_dir: str, source: str = "",
            capacity: Optional[int] = None) -> FlightRecorder:
    """Point the global recorder at ``dump_dir`` and hook SIGTERM +
    uncaught exceptions to dump the ring before dying.  The FIRST
    install wins: a trainer fit() running inside a worker must not
    hijack the identity worker_main installed — the node agent finds
    the dump by the worker's source/dir, and re-pointing it would
    silently break cluster-wide postmortems.  Signal hooking silently
    degrades off the main thread."""
    global _installed
    rec = get()
    with _rec_lock:
        if _installed:
            return rec
        _installed = True
        rec.dump_dir = dump_dir
        if source:
            rec.source = source
        if capacity and capacity != rec._events.maxlen:
            with rec._lock:
                rec._events = deque(rec._events, maxlen=capacity)

    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        record("uncaught_exception", error=repr(exc))
        rec.dump(reason=f"uncaught exception: {exc_type.__name__}")
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook

    def _on_signal(signum, frame):
        rec.dump(reason=f"signal {signum}")
        # Preserve the pre-existing disposition: chain a handler (e.g.
        # a program's own graceful shutdown), keep living if the
        # process explicitly ignored SIGTERM, and otherwise re-deliver
        # with the default disposition so the exit status still says
        # "killed by SIGTERM" (supervisors key off it).
        if prev_term is signal.SIG_IGN:
            return
        if callable(prev_term):
            prev_term(signum, frame)
            return
        try:
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        except (OSError, ValueError):
            os._exit(128 + signum)

    try:
        prev_term = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _on_signal)
    except ValueError:
        pass  # not the main thread; excepthook still covers crashes
    return rec
