"""Goodput ledger: classify wall-clock into named training phases.

A copy of ``ray_tpu/util/goodput.py``.  The ledger attributes elapsed
time to one phase of a fixed taxonomy

    compute     running training steps on the device
    compile     the first step of a step function: lazy initialisation,
                the allocator's warm-up and the xprof harvest
    checkpoint  saving/restoring model state
    checkpoint_on_notice  an urgent save raced against a drain deadline
    restart     gang teardown and reschedule after a failure
    data_stall  the step loop waiting on input data
    idle        everything unattributed

through a context-manager API (``with ledger().phase("compute"): ...``).
Nested phases attribute time to the innermost one, so phase seconds
never double count and fractions sum to 1.

Every transition republishes the cumulative seconds as the
``rt_goodput_seconds{phase=...}`` gauge in the process-local registry
(``util/metrics``); ``summarize_sources`` re-aggregates those gauges
across processes.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

PHASES = ("compute", "compile", "checkpoint", "checkpoint_on_notice",
          "restart", "data_stall", "idle")

GAUGE_NAME = "rt_goodput_seconds"

# Multi-tenant attribution: the submitted-job id stamped on every
# published phase series ("who is paying for this cluster").  Defaults
# from RT_JOB_ID (the supervisor exports it into the entrypoint); train
# workers, spawned by node agents and not by the entrypoint, get it via
# set_job_id() from the gang bootstrap.
_job_id: Optional[str] = None


def set_job_id(job_id: str) -> None:
    """Stamp all subsequently published goodput series with this
    submitted-job id (and republish so the tag lands now)."""
    global _job_id
    _job_id = job_id or None
    led = _ledger
    if led is not None:
        led._republish()


def current_job_id() -> str:
    import os

    return _job_id if _job_id is not None \
        else os.environ.get("RT_JOB_ID", "")


class _PhaseSpan:
    """Re-entrant handle returned by ``phase()``; usable as a context
    manager or via explicit ``ledger().enter()/exit()``."""

    def __init__(self, ledger: "GoodputLedger", name: str):
        self._ledger = ledger
        self._name = name

    def __enter__(self) -> "_PhaseSpan":
        self._ledger.enter(self._name)
        return self

    def __exit__(self, *exc) -> None:
        self._ledger.exit()


class GoodputLedger:
    """Thread-safe wall-clock phase accountant for ONE process.

    Time between transitions is attributed to the top of the phase
    stack; time with an empty stack accrues to ``idle`` at snapshot
    time (idle = total - sum(named phases)).  The phase stack is meant
    to be driven from the training thread; concurrent phases from other
    threads interleave on the same stack (attribution stays consistent
    under the lock, but LIFO discipline is the caller's contract).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 publish: bool = True):
        self._clock = clock
        self._publish = publish
        self._lock = threading.Lock()
        self._t0 = clock()
        self._seconds: Dict[str, float] = {
            p: 0.0 for p in PHASES if p != "idle"}
        # Stack entries are (phase_name, wall_clock_start): the wall
        # timestamp turns every exit into a timeline span (see
        # util/spans.py) in addition to the cumulative-seconds gauge.
        self._stack: List[tuple] = []
        self._mark = self._t0

    # ------------------------------------------------------------ transitions
    def _attribute(self, now: float) -> None:
        if self._stack:
            self._seconds[self._stack[-1][0]] += now - self._mark
        self._mark = now

    def enter(self, name: str) -> None:
        if name not in self._seconds:
            raise ValueError(
                f"unknown goodput phase {name!r} (taxonomy: "
                f"{sorted(self._seconds)} — 'idle' is derived)")
        with self._lock:
            self._attribute(self._clock())
            self._stack.append((name, time.time()))
        self._republish()

    def exit(self) -> None:
        with self._lock:
            if not self._stack:
                return
            self._attribute(self._clock())
            name, wall_t0 = self._stack.pop()
        self._republish()
        if self._publish:
            try:
                from . import spans

                spans.record_span(name, wall_t0, time.time(),
                                  cat="phase")
            except Exception:
                pass  # telemetry must never take down training

    def phase(self, name: str) -> _PhaseSpan:
        """``with ledger().phase("compute"): ...``"""
        return _PhaseSpan(self, name)

    # --------------------------------------------------------------- reading
    def snapshot(self) -> Dict:
        """{"total": s, "seconds": {phase: s, ..., "idle": s}} — the
        in-progress phase is attributed up to now."""
        with self._lock:
            self._attribute(self._clock())
            total = max(self._mark - self._t0, 0.0)
            seconds = dict(self._seconds)
        idle = max(total - sum(seconds.values()), 0.0)
        seconds["idle"] = idle
        return {"total": total, "seconds": seconds}

    def fractions(self) -> Dict[str, float]:
        """Phase fractions of total wall-clock; sums to ~1.0 (exactly,
        modulo float rounding) once any time has elapsed."""
        snap = self.snapshot()
        total = snap["total"]
        if total <= 0:
            return {p: 0.0 for p in snap["seconds"]}
        return {p: s / total for p, s in snap["seconds"].items()}

    # ------------------------------------------------------------- publishing
    def _republish(self) -> None:
        if not self._publish:
            return
        try:
            from .metrics import Gauge

            g = Gauge(GAUGE_NAME,
                      "Cumulative wall-clock seconds per goodput phase.",
                      tag_keys=("phase", "job"))
            job = current_job_id()
            for p, s in self.snapshot()["seconds"].items():
                tags = {"phase": p}
                if job:
                    tags["job"] = job
                g.set(s, tags=tags)
        except Exception:
            pass  # telemetry must never take down the training path


_ledger: Optional[GoodputLedger] = None
_ledger_lock = threading.Lock()


def ledger() -> GoodputLedger:
    """The process-global ledger (created on first use)."""
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = GoodputLedger()
    return _ledger


def reset() -> GoodputLedger:
    """Fresh global ledger (tests / standalone benches)."""
    global _ledger
    with _ledger_lock:
        _ledger = GoodputLedger()
    return _ledger


def current_phase() -> Optional[str]:
    """Name of the phase currently on top of the global ledger's
    stack, or None.  Lets nested attributors (the sharded checkpoint
    save inside a ``checkpoint_on_notice`` block) avoid stealing the
    outer phase's wall-clock."""
    led = _ledger
    if led is None:
        return None
    with led._lock:
        return led._stack[-1][0] if led._stack else None


@contextmanager
def timed_phase(phase: str, metric: Optional[str] = None,
                description: str = "", tags: Optional[Dict] = None,
                tag_keys: tuple = ()):
    """Attribute a block to a goodput phase and (optionally) observe
    its duration histogram — the shared shape behind
    ``train.data_wait`` and checkpoint save/restore timing.  Ledger
    attribution covers the block even when it raises; the histogram
    observes only on success (a failed wait/save has no meaningful
    duration sample).  ``tags``/``tag_keys`` thread through to the
    histogram (e.g. the checkpoint plane's ``sharded`` tag)."""
    t0 = time.monotonic()
    with ledger().phase(phase):
        yield
    if metric:
        try:
            from .metrics import Histogram

            Histogram(metric, description,
                      tag_keys=tag_keys or tuple(tags or ())).observe(
                time.monotonic() - t0, tags=tags)
        except Exception:
            pass  # telemetry must never fail the training path


# ------------------------------------------------------------- aggregation
def summarize_sources(sources: Dict[str, List[Dict]]) -> Dict:
    """Cluster goodput summary from per-source metric snapshots (the
    controller's ``metrics_sources`` shape: {source: [metric dicts]}).

    Sums ``rt_goodput_seconds`` per phase across every reporting
    process; fractions normalize by the summed totals, so they sum to
    ~1.0 regardless of how many processes overlap in wall-clock.
    Series carrying a ``job`` tag additionally aggregate into
    ``per_job`` — the per-tenant cost attribution `rt jobs`/`rt
    telemetry` surface.
    """
    seconds: Dict[str, float] = {}
    per_source: Dict[str, Dict[str, float]] = {}
    per_job: Dict[str, Dict[str, float]] = {}
    for src, snaps in (sources or {}).items():
        for snap in snaps:
            if snap.get("name") != GAUGE_NAME:
                continue
            mine = per_source.setdefault(src, {})
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                phase = tags.get("phase", "?")
                v = float(s.get("value", 0.0))
                seconds[phase] = seconds.get(phase, 0.0) + v
                mine[phase] = v
                job = tags.get("job")
                if job:
                    jp = per_job.setdefault(job, {})
                    jp[phase] = jp.get(phase, 0.0) + v
    total = sum(seconds.values())
    fractions = ({p: s / total for p, s in seconds.items()}
                 if total > 0 else {})
    return {"total_seconds": total, "seconds": seconds,
            "fractions": fractions, "per_source": per_source,
            "per_job": per_job}
