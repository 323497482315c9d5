"""Collective-op telemetry of the port's eager group ops: a copy of
``ray_tpu/collective/telemetry.py``.

Every eager collective of a ``TorchGroup`` records (op, backend, group
size, payload bytes, latency) into the process-local metrics registry:

  rt_collective_latency_seconds{op,backend,world}   latency histogram
  rt_collective_bus_bandwidth_bytes_per_sec{op,backend,world}
                                                    effective bus BW

with ``backend`` the ``collective.types.Backend`` value (``"nccl"``,
or ``"cpu"`` for gloo), as in the JAX package.  Bus bandwidth uses the
nccl-tests algbw->busbw factors (allreduce 2(n-1)/n, allgather and
reducescatter (n-1)/n, broadcast and p2p 1).  Each op is also appended
to the flight recorder ring and recorded as a span, and ``timed_op``
stamps the gang-op entry watchdog (``inflight_entries``).

The groups end the timed region after the op has completed (the NCCL
group synchronises the stream inside it), so the latency covers the
collective and not only its launch.  Collectives inside a step (ring
rotations, DTensor redistributions, the pipeline's shifts) do not pass
through here.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

# Latency boundaries tuned for collectives: 100µs .. 30s.
_BOUNDS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
           30.0)

_BUSBW_FACTOR = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "reducescatter": lambda n: (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "broadcast": lambda n: 1.0,
    "barrier": lambda n: 0.0,
    "send": lambda n: 1.0,
    "recv": lambda n: 1.0,
}


# ---------------------------------------------------- gang watchdog
# Entry stamps for the collective-entry watchdog: each rank stamps
# "I am inside op #seq of group G" on entry and clears it on exit.
# The worker flush loop ships the CURRENT inflight set to the
# controller every tick, which merges stamps across ranks; `rt
# doctor` flags gangs where some ranks are absent past the
# collective_watchdog_s deadline — naming the op AND the missing
# ranks, the diagnosis that previously required reading every rank's
# log by hand.
_inflight_lock = threading.Lock()
_inflight: Dict[Tuple[str, int], Dict[str, Any]] = {}


def _stamp_entry(op: str, backend: str, world_size: int,
                 group_name: str, rank: int, seq: int) -> None:
    with _inflight_lock:
        _inflight[(group_name, seq)] = {
            "group": group_name, "seq": int(seq), "op": op,
            "backend": backend, "world": int(world_size),
            "rank": int(rank), "since": time.time()}


def _stamp_exit(group_name: str, seq: int) -> None:
    with _inflight_lock:
        _inflight.pop((group_name, seq), None)


def inflight_entries() -> List[Dict[str, Any]]:
    """Snapshot of collectives this process is currently inside.
    Each entry carries ``age_s`` (a same-clock delta) so the
    controller can rebase the entry time onto ITS clock — absolute
    worker-host timestamps are not comparable across hosts."""
    now = time.time()
    with _inflight_lock:
        return [{**v, "age_s": max(now - v["since"], 0.0)}
                for v in _inflight.values()]


def record_op(op: str, backend: str, world_size: int, nbytes: int,
              seconds: float) -> None:
    try:
        from ..util import flight_recorder
        from ..util.metrics import Gauge, Histogram

        tags = {"op": op, "backend": backend, "world": str(world_size)}
        Histogram("rt_collective_latency_seconds",
                  "Eager collective op latency.",
                  boundaries=_BOUNDS,
                  tag_keys=("op", "backend", "world")).observe(
            seconds, tags=tags)
        factor = _BUSBW_FACTOR.get(op, lambda n: 1.0)(
            max(world_size, 1))
        if nbytes > 0 and seconds > 0 and factor > 0:
            # Same tag set as the histogram: groups of different sizes
            # must not overwrite one another's series.
            Gauge("rt_collective_bus_bandwidth_bytes_per_sec",
                  "Effective bus bandwidth of the last collective "
                  "(nccl-tests busbw convention).",
                  tag_keys=("op", "backend", "world")).set(
                nbytes * factor / seconds, tags=tags)
        flight_recorder.record("collective", op=op, backend=backend,
                               world=world_size, bytes=nbytes,
                               seconds=round(seconds, 6))
    except Exception:
        pass  # telemetry must never fail a collective


def _record_span(op: str, backend: str, world_size: int,
                 t0_wall: float, error: str = "") -> None:
    """Timeline span for one collective, tagged op/backend/world — the
    cluster timeline shows WHICH collective a rank sat in, not just the
    latency histogram the metrics carry."""
    try:
        from ..util import spans

        tags = {"op": op, "backend": backend, "world": str(world_size)}
        if error:
            tags["error"] = error
        spans.record_span(op, t0_wall, time.time(), cat="collective",
                          tags=tags)
    except Exception:
        pass


@contextmanager
def timed_op(op: str, backend: str, world_size: int, nbytes: int = 0,
             *, group_name: Optional[str] = None,
             rank: Optional[int] = None, seq: Optional[int] = None):
    # Flight-record the START too: a worker preempted mid-collective
    # must show WHICH op it was blocked in — completion-only records
    # would miss exactly the hung/preempted case postmortems exist for.
    try:
        from ..util import flight_recorder

        flight_recorder.record("collective_begin", op=op,
                               backend=backend, world=world_size,
                               bytes=nbytes)
    except Exception:
        flight_recorder = None
    stamped = group_name is not None and rank is not None \
        and seq is not None
    if stamped:
        _stamp_entry(op, backend, world_size, group_name, rank, seq)
    t0 = time.perf_counter()
    t0_wall = time.time()
    try:
        yield
    except BaseException as e:
        if flight_recorder is not None:
            flight_recorder.record(
                "collective_error", op=op, error=repr(e),
                seconds=round(time.perf_counter() - t0, 6))
        _record_span(op, backend, world_size, t0_wall, error=repr(e))
        raise
    finally:
        if stamped:
            _stamp_exit(group_name, seq)
    record_op(op, backend, world_size, nbytes,
              time.perf_counter() - t0)
    _record_span(op, backend, world_size, t0_wall)
