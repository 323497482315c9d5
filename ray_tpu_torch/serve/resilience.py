"""Serve request-resilience plane — the pure state machines.

Role-equivalent to the reference's router-side fault handling (ref:
serve/_private/router.py retry-on-ActorDiedError + replica_scheduler
backoff, proxy request_timeout_s) rebuilt as three explicit, unit-
testable machines the routing layer composes:

  Deadline        one budget spanning every failover retry of a
                  request; expiry maps to HTTP 504 / gRPC
                  DEADLINE_EXCEEDED at the ingress.
  CircuitBreaker  per-replica consecutive-failure trip with jittered
                  exponential open windows (the PR-4 RestartBackoff
                  schedule) and a single half-open probe — a
                  black-holed replica stops receiving traffic before
                  the controller's health-probe tick notices it.
  AdmissionGate   bounded per-deployment wait queue over the replicas'
                  concurrent capacity; when full the OLDEST waiter is
                  shed (HTTP 429 / gRPC RESOURCE_EXHAUSTED) so
                  overload degrades into fast typed rejections instead
                  of a cluster-wide timeout pileup.

Everything here is plain Python over ``threading`` — no cluster, no
actor calls — so the trip/half-open/close transitions, deadline budget
accounting, and shed-oldest ordering are provable in pure unit tests.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

from ..core.errors import (ActorDiedError, NodeDiedError, ObjectLostError,
                           RayTpuError, WorkerCrashedError)
from ..util.backoff import RestartBackoff

# Faults that mean "the system lost the replica/result", never "the
# handler raised": these — and only these — are transparently retried
# onto a different replica.  A user exception travels as a TaskError
# dual of its original type and must surface exactly once.
SYSTEM_FAULTS = (ActorDiedError, WorkerCrashedError, ObjectLostError,
                 NodeDiedError)


def is_system_fault(exc: BaseException) -> bool:
    """True when a request failure is the runtime's fault (dead
    replica, crashed worker, lost result) rather than the handler's —
    the retry/breaker machinery acts ONLY on these."""
    return isinstance(exc, SYSTEM_FAULTS)


class RequestShedError(RayTpuError):
    """Admission control shed this request: the deployment's queue was
    full (HTTP 429 / gRPC RESOURCE_EXHAUSTED)."""

    def __init__(self, deployment: str = "?", queued: int = 0):
        super().__init__(
            f"request to {deployment!r} shed: admission queue full "
            f"({queued} waiting)")
        self.deployment = deployment
        self.queued = queued

    def __reduce__(self):
        return (type(self), (self.deployment, self.queued))


class RequestTimeoutError(RayTpuError, TimeoutError):
    """The request's deadline expired before a replica answered
    (HTTP 504 / gRPC DEADLINE_EXCEEDED)."""

    def __init__(self, deployment: str = "?", timeout_s: float = 0.0):
        super().__init__(
            f"request to {deployment!r} exceeded its "
            f"{timeout_s:.1f}s deadline")
        self.deployment = deployment
        self.timeout_s = timeout_s

    def __reduce__(self):
        return (type(self), (self.deployment, self.timeout_s))


class ReplicasUnavailableError(RayTpuError):
    """No routable replica would accept the request — every breaker is
    open or every failover target was consumed (HTTP 503 / gRPC
    UNAVAILABLE)."""

    def __init__(self, deployment: str = "?", detail: str = ""):
        super().__init__(
            f"no routable replica for {deployment!r}"
            + (f": {detail}" if detail else ""))
        self.deployment = deployment
        self.detail = detail

    def __reduce__(self):
        return (type(self), (self.deployment, self.detail))


class StreamInterruptedError(RayTpuError):
    """A streaming response died mid-stream from a SYSTEM fault after
    items were already delivered.  Typed so consumers can distinguish
    an interrupted stream from a completed one — the ingress renders it
    as a terminal error frame (HTTP) or error trailer (gRPC), never as
    silent truncation."""

    def __init__(self, deployment: str = "?", cause_repr: str = "",
                 items_delivered: int = 0):
        super().__init__(
            f"stream from {deployment!r} interrupted after "
            f"{items_delivered} item(s): {cause_repr}")
        self.deployment = deployment
        self.cause_repr = cause_repr
        self.items_delivered = items_delivered

    def __reduce__(self):
        return (type(self),
                (self.deployment, self.cause_repr,
                 self.items_delivered))


# --------------------------------------------------------------- deadline
class Deadline:
    """One request's time budget, spanning every failover retry.

    ``timeout_s <= 0`` means unbounded (every ``remaining()`` clamps to
    ``cap``).  The clock is injectable so budget accounting is exactly
    testable.
    """

    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.timeout_s = float(timeout_s or 0.0)
        self._start = clock()

    @property
    def bounded(self) -> bool:
        return self.timeout_s > 0

    def elapsed(self) -> float:
        return self._clock() - self._start

    def remaining(self, cap: float = 3600.0) -> float:
        """Seconds left in the budget (never negative), clamped to
        ``cap`` when the deadline is unbounded."""
        if not self.bounded:
            return cap
        return max(0.0, min(cap, self.timeout_s - self.elapsed()))

    @property
    def expired(self) -> bool:
        return self.bounded and self.elapsed() >= self.timeout_s


# --------------------------------------------------------- circuit breaker
_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-replica breaker: ``failure_threshold`` CONSECUTIVE system
    faults trip it OPEN; after a jittered backoff window one HALF-OPEN
    probe is admitted — success closes it (and resets the backoff),
    failure re-opens with the next, longer window.

    Not thread-safe on its own; the owning ``BreakerBoard`` serializes
    access.
    """

    def __init__(self, failure_threshold: int = 3,
                 reset_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Any = None):
        self.failure_threshold = max(1, int(failure_threshold))
        self._clock = clock
        self._state = _CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._open_for = 0.0
        self._probe_inflight = False
        # Jittered exponential open windows, reusing the PR-4 restart
        # backoff: repeated trips of the same replica wait longer each
        # time, and jitter decorrelates many handles probing one
        # half-open replica in the same instant.
        self._backoff = RestartBackoff(base_s=max(0.0, reset_s),
                                       max_s=max(reset_s, 30.0),
                                       multiplier=2.0, jitter=0.2)
        if rng is not None:
            self._backoff.rng = rng

    # -- transitions
    def record_failure(self) -> bool:
        """Record one system-fault failure; returns True when this
        call TRIPPED the breaker open (closed/half-open -> open)."""
        self._consecutive += 1
        if self._state == _HALF_OPEN:
            # The probe failed: straight back to open, longer window.
            self._probe_inflight = False
            self._trip()
            return True
        if self._state == _CLOSED and \
                self._consecutive >= self.failure_threshold:
            self._trip()
            return True
        return False

    def record_success(self) -> bool:
        """Record one success; returns True when this call CLOSED a
        tripped breaker (half-open probe succeeded)."""
        self._consecutive = 0
        self._probe_inflight = False
        if self._state in (_OPEN, _HALF_OPEN):
            self._state = _CLOSED
            self._backoff.reset()
            return True
        return False

    def _trip(self) -> None:
        self._state = _OPEN
        self._opened_at = self._clock()
        self._open_for = self._backoff.next_delay()

    # -- routing decision
    def allow(self) -> bool:
        """May the router send this replica a request right now?
        CLOSED: yes.  OPEN: no, until the backoff window elapses —
        then exactly ONE half-open probe is admitted."""
        if self._state == _CLOSED:
            return True
        if self._state == _OPEN and \
                self._clock() - self._opened_at >= self._open_for:
            self._state = _HALF_OPEN
            self._probe_inflight = False
        if self._state == _HALF_OPEN and not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    @property
    def state(self) -> str:
        # Read-only view: an elapsed open window still reads "open"
        # until a probe is actually admitted via allow().
        return self._state

    def snapshot(self) -> Dict[str, Any]:
        out = {"state": self._state,
               "consecutive_failures": self._consecutive}
        if self._state != _CLOSED:
            out["open_for_s"] = self._open_for
            out["opened_age_s"] = self._clock() - self._opened_at
        return out


class BreakerBoard:
    """Thread-safe registry of per-replica breakers for one
    deployment, with transition callbacks for observability (metric
    gauges + fire-and-forget reports to the serve controller)."""

    def __init__(self, failure_threshold: int = 3, reset_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[str, str], None]] = None):
        self._failure_threshold = failure_threshold
        self._reset_s = reset_s
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def _get(self, key: str) -> CircuitBreaker:
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = CircuitBreaker(
                self._failure_threshold, self._reset_s, self._clock)
        return br

    def allow(self, key: str) -> bool:
        with self._lock:
            return self._get(key).allow()

    def record_failure(self, key: str) -> bool:
        with self._lock:
            tripped = self._get(key).record_failure()
        if tripped and self._on_transition:
            self._safe_notify(key, _OPEN)
        return tripped

    def record_success(self, key: str) -> bool:
        with self._lock:
            closed = self._get(key).record_success()
        if closed and self._on_transition:
            self._safe_notify(key, _CLOSED)
        return closed

    def _safe_notify(self, key: str, state: str) -> None:
        try:
            self._on_transition(key, state)
        except Exception:
            pass  # observability must never fail the request path

    def state(self, key: str) -> str:
        with self._lock:
            br = self._breakers.get(key)
            return br.state if br else _CLOSED

    def prune(self, live_keys) -> List[tuple]:
        """Drop breakers for replicas that left the routing table (a
        replaced replica's key must not leak its failure history onto
        an unrelated future replica).  Returns ``[(key, state), ...]``
        of the pruned entries so the owner can retire observability
        state (an OPEN gauge for a dead replica must not read as a
        black-holed live one forever)."""
        live = set(live_keys)
        pruned = []
        with self._lock:
            for key in list(self._breakers):
                if key not in live:
                    pruned.append((key, self._breakers[key].state))
                    del self._breakers[key]
        return pruned

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: b.snapshot() for k, b in self._breakers.items()}


# -------------------------------------------------------- admission gate
class _Ticket:
    __slots__ = ("shed", "admitted")

    def __init__(self):
        self.shed = False
        self.admitted = False


class AdmissionGate:
    """Bounded per-deployment admission over the replicas' concurrent
    capacity.

    ``capacity`` (a callable, usually replicas x max_ongoing_requests)
    bounds requests actively dispatched through this gate; arrivals
    beyond it wait in a FIFO queue bounded by ``max_queued``.  When the
    queue is full, the OLDEST waiter is shed — its ``admit()`` raises
    ``RequestShedError`` — and the newcomer queues at the tail: under
    overload the requests most likely to have already timed out client-
    side are the ones rejected, and fresh requests still get served
    (shed-oldest, the reference's e2e-timeout-friendly policy).

    ``max_queued <= 0`` disables the gate entirely (admit always).
    """

    def __init__(self, max_queued: int,
                 capacity: Callable[[], int] = lambda: 0,
                 on_depth_change: Optional[
                     Callable[[int], None]] = None):
        self.max_queued = int(max_queued)
        self._capacity = capacity
        self._on_depth_change = on_depth_change
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._active = 0
        self._queue: "OrderedDict[_Ticket, float]" = OrderedDict()

    # -- introspection
    def depth(self) -> int:
        """Requests waiting (admitted-not-yet-dispatched)."""
        with self._lock:
            return len(self._queue)

    def active(self) -> int:
        with self._lock:
            return self._active

    # -- core admission (single-threaded logic, unit-testable)
    def _try_admit_locked(self, ticket: _Ticket) -> Optional[_Ticket]:
        """Admit ``ticket`` if capacity allows, else enqueue it —
        shedding the OLDEST waiter when the queue is full.  Returns
        the shed ticket (if any) so callers can count it."""
        cap = self._capacity() or 0
        if cap <= 0 or (self._active < cap and not self._queue):
            ticket.admitted = True
            self._active += 1
            return None
        shed = None
        if len(self._queue) >= self.max_queued:
            shed, _ = self._queue.popitem(last=False)  # oldest
            shed.shed = True
        self._queue[ticket] = time.monotonic()
        return shed

    def _promote_locked(self) -> None:
        """Admit waiters FIFO while capacity allows — called on every
        release AND from waiting admits, so capacity GROWTH (replica
        scale-up) drains the queue immediately instead of staying
        pinned at the concurrency the queue formed under."""
        while self._queue:
            cap = self._capacity() or 0
            if cap > 0 and self._active >= cap:
                break
            nxt, _ = next(iter(self._queue.items()))
            del self._queue[nxt]
            nxt.admitted = True
            self._active += 1

    def _release_locked(self) -> None:
        self._active -= 1
        self._promote_locked()

    # -- blocking API used by the router
    def admit(self, deadline: Optional[Deadline] = None,
              deployment: str = "?") -> "_Admission":
        """Block until admitted; raises ``RequestShedError`` if this
        request was shed, ``RequestTimeoutError`` if the deadline
        expired while queued.  Returns a context manager releasing the
        slot."""
        if self.max_queued <= 0:
            return _Admission(None)
        ticket = _Ticket()
        with self._cond:
            shed = self._try_admit_locked(ticket)
            depth = len(self._queue)
            if shed is not None:
                self._cond.notify_all()
        if self._on_depth_change:
            try:
                self._on_depth_change(depth)
            except Exception:
                pass
        while True:
            with self._cond:
                # Re-attempt promotion each pass: capacity may have
                # grown (scale-up) without any release happening.
                if not ticket.admitted and not ticket.shed:
                    self._promote_locked()
                if ticket.admitted:
                    return _Admission(self)
                if ticket.shed:
                    raise RequestShedError(deployment, self.max_queued)
                if deadline is not None and deadline.expired:
                    self._queue.pop(ticket, None)
                    raise RequestTimeoutError(
                        deployment,
                        deadline.timeout_s)
                wait = deadline.remaining(cap=1.0) if deadline \
                    else 1.0
                self._cond.wait(max(0.05, min(wait, 1.0)))

    def release(self) -> None:
        with self._cond:
            self._release_locked()
            depth = len(self._queue)
            self._cond.notify_all()
        if self._on_depth_change:
            try:
                self._on_depth_change(depth)
            except Exception:
                pass


class _Admission:
    """Context manager for one admitted request's capacity slot."""

    def __init__(self, gate: Optional[AdmissionGate]):
        self._gate = gate
        self._done = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def release(self) -> None:
        if self._done or self._gate is None:
            self._done = True
            return
        self._done = True
        self._gate.release()


# ----------------------------------------------------- routing (pure)
def select_replica(replicas: List[Any], breakers: BreakerBoard,
                   inflight: Dict[str, int], exclude=(),
                   rng: Any = None,
                   key_fn=lambda r: r.actor_id.hex()):
    """Breaker-aware power-of-two-choices: rank the not-yet-tried
    replicas by local in-flight count (two random candidates, lower
    count first; the rest follow as fallbacks), then walk the ranking
    and take the FIRST one whose breaker admits traffic.  ``allow()``
    is consulted only for replicas actually about to be used — a
    half-open breaker's single probe slot must not be burned on a
    candidate the router then discards.

    Returns ``(replica, key)`` or ``None`` when every candidate is
    excluded or breaker-blocked.  Drain exclusion happens upstream —
    a bled-off replica never reaches the routing table at all.
    """
    import random as _random

    rng = rng or _random
    candidates = [(key_fn(r), r) for r in replicas
                  if key_fn(r) not in exclude]
    if not candidates:
        return None
    if len(candidates) > 2:
        a, b = rng.sample(candidates, 2)
        rest = [c for c in candidates if c is not a and c is not b]
        rng.shuffle(rest)
        first, second = ((a, b) if inflight.get(a[0], 0)
                         <= inflight.get(b[0], 0) else (b, a))
        ranked = [first, second] + rest
    else:
        # Shuffle BEFORE the stable sort so ties don't always land on
        # the same replica (pow-2's tie randomization).
        rng.shuffle(candidates)
        ranked = sorted(candidates,
                        key=lambda kr: inflight.get(kr[0], 0))
    for key, replica in ranked:
        if breakers.allow(key):
            return replica, key
    return None
