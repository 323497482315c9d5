"""ClusterRuntime — the in-process core of every driver and worker.

Role-equivalent to the reference's CoreWorker (ref:
src/ray/core_worker/core_worker.h:166 with SubmitTask at
core_worker.cc:2484, NormalTaskSubmitter transport/normal_task_submitter.h:74,
ActorTaskSubmitter transport/actor_task_submitter.h:75): owns the
per-process memory store, resolves dependencies, leases workers from the
node agent, pushes tasks directly to leased workers, and routes actor
calls straight to the actor's worker process.  All IO runs on a dedicated
event-loop thread so user threads only ever block on local events.

Head-node bring-up (controller + agent subprocesses) mirrors
python/ray/_private/node.py:1407 start_head_processes.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from .config import RuntimeConfig
from .errors import (ActorDiedError, ActorError, GetTimeoutError,
                     ObjectLostError, TaskCancelledError, TaskError,
                     WorkerCrashedError)
from .ids import ActorID, JobID, NodeID, ObjectID
from .object_store import MemoryStore, SharedObjectStore
from .object_ref import ObjectRef
from .rpc import EventLoopThread, RemoteCallError, RpcClient, RpcError
from .runtime import BaseRuntime
from .task import ArgKind, TaskArg, TaskKind, TaskResult, TaskSpec

logger = logging.getLogger("ray_tpu_torch.runtime")

_PUSH_RETRY_STATES = ("PENDING", "RESTARTING")


class _StoreRef:
    """Memory-store descriptor for a value living in the object plane."""

    __slots__ = ("size", "node_hint")

    def __init__(self, size: int, node_hint: str = ""):
        self.size = size
        self.node_hint = node_hint


class _Submission:
    """Owner-side in-flight record for one normal task, for cancel().

    Tracks where the lease request currently waits (agent_addr +
    request_id while queued) and where the task runs once pushed
    (worker_addr/worker_id), so cancellation can be routed (ref:
    core_worker.cc CancelTask / node_manager CancelWorkerLease).
    """

    __slots__ = ("spec", "request_id", "cancelled", "force", "agent_addr",
                 "worker_addr", "worker_id", "pushed", "done",
                 "cancel_event")

    def __init__(self, spec):
        self.spec = spec
        self.request_id = uuid.uuid4().hex
        self.cancelled = False
        self.force = False
        self.agent_addr: Optional[str] = None
        self.worker_addr: Optional[str] = None
        self.worker_id = None
        self.pushed = False
        self.done = False
        # Interrupts dep-resolution waits; set on the io loop by cancel().
        self.cancel_event = asyncio.Event()


class _CancelledInFlight(Exception):
    """Internal: submission observed its cancel flag mid-flight."""


class _StreamState:
    """Owner-side state of one streaming-generator task (ref: the
    owner half of ObjectRefGenerator, _raylet.pyx:284): item refs
    arrive as stream_item notifies and queue here until the consumer
    nexts them; `done` latches on the final TaskResult."""

    __slots__ = ("ready", "produced", "consumed", "done", "error",
                 "total", "event", "lock", "worker_addr",
                 "error_delivered")

    def __init__(self):
        import collections
        import threading

        self.ready = collections.deque()   # ObjectIDs in yield order
        self.produced = 0
        self.consumed = 0
        self.done = False
        self.error: Optional[Any] = None
        self.total: Optional[int] = None
        self.event = threading.Event()
        self.lock = threading.Lock()
        self.worker_addr: Optional[str] = None
        self.error_delivered = False


class _PooledLease:
    """A granted worker lease cached by the owner for task reuse (ref:
    normal_task_submitter.h:74 — the submitter caches leased workers
    and pipelines same-shaped tasks onto them instead of paying a
    lease round-trip per task).  At most ONE task runs on a pooled
    lease at a time (matching OnWorkerIdle semantics), so queued tasks
    can never deadlock behind a blocked task on the same worker."""

    __slots__ = ("lease_id", "agent_addr", "worker_addr", "worker_id",
                 "gpu_ids", "idle_since", "dead", "inflight")

    def __init__(self, lease_id, agent_addr, worker_addr, worker_id,
                 gpu_ids):
        self.lease_id = lease_id
        self.agent_addr = agent_addr
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.gpu_ids = gpu_ids
        self.idle_since = 0.0
        self.dead = False
        # Pushes currently in flight on this lease (reported to the
        # agent so `rt list leases` can show pipeline depth).
        self.inflight = 0


class _SchedKeyState:
    """Owner-side per-scheduling-key submission state: a FIFO of tasks
    waiting for a worker, the pool of granted leases, and the set of
    in-flight lease requests (ref: SchedulingKey entries in
    normal_task_submitter.h — one task queue + worker set + pending
    lease request per (resource shape, runtime env) class)."""

    __slots__ = ("key", "base_payload", "queue", "leases", "idle",
                 "request_agents", "repump_scheduled")

    def __init__(self, key, base_payload):
        self.key = key
        self.base_payload = base_payload
        from collections import deque

        # (spec, _Submission, future-of-TaskResult) triples.
        self.queue = deque()
        self.leases: Dict[int, _PooledLease] = {}
        self.idle: List[_PooledLease] = []
        # request_id -> agent address currently holding that request.
        self.request_agents: Dict[str, str] = {}
        self.repump_scheduled = False


class ClusterRuntime(BaseRuntime):
    def __init__(self, config: RuntimeConfig, *,
                 address: Optional[str] = None,
                 num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 custom_resources: Optional[Dict[str, float]] = None,
                 namespace: str = "",
                 # Worker-role wiring (set by worker_main):
                 _connect: Optional[Dict[str, str]] = None,
                 _job_id: Optional[JobID] = None):
        from .object_store import POOL_NOT_PORTED

        if config.object_store_backend == "pool":
            # Before any process starts: the agent would die on it.
            raise NotImplementedError(POOL_NOT_PORTED)
        self._procs: List[subprocess.Popen] = []
        self._owns_head = False
        self.namespace = namespace
        self.is_worker = _connect is not None
        if _connect is not None:
            self.session = _connect["session"]
            self.controller_addr = _connect["controller"]
            self.agent_addr = _connect["agent"]
        elif address is not None:
            self.session, self.controller_addr, self.agent_addr = \
                self._connect_existing(config, address, num_cpus, num_gpus,
                                       custom_resources)
        else:
            self.session, self.controller_addr, self.agent_addr = \
                self._start_head(config, num_cpus, num_gpus,
                                 custom_resources)
            self._owns_head = True
        self.io = EventLoopThread("rt-io")
        from .object_store import create_store

        self.store = create_store(self.session, config)
        self.memory = MemoryStore()
        self._runtime_id = uuid.uuid4().hex[:16]
        self._ctl: Optional[RpcClient] = None
        self._agent: Optional[RpcClient] = None
        self._worker_clients: Dict[str, RpcClient] = {}
        self._actor_cache: Dict[ActorID, Dict] = {}
        # Batched actor registration: unnamed actor registrations
        # coalesce on a 5 ms window into one bulk register_actors RPC
        # (a 100-replica fan-out = a handful of controller round
        # trips).  Io-loop state only.
        self._actor_reg_buf: List = []
        self._actor_reg_flusher = None
        # Actors whose batched registration has not committed at the
        # controller yet: the submit path must wait these out before
        # polling get_actor, or a fast first call would read "unknown
        # actor" in the 5 ms window.  Marked on the caller's thread in
        # create_actor (program order guarantees the mark exists
        # before any call on the handle), cleared on the io loop.
        self._actor_reg_pending: Dict[ActorID, bool] = {}
        self._pending_returns: Set[ObjectID] = set()
        self._submissions: Dict[ObjectID, _Submission] = {}
        self._completion_events: Dict[ObjectID, asyncio.Event] = {}
        # RLock: taken on the ObjectRef.__del__ path (remove_local_ref),
        # which cyclic GC can fire on a thread already inside it.
        self._pending_lock = threading.RLock()
        # -- Distributed reference counting state (ref:
        # reference_count.h:66, redesigned: each process reports only its
        # 0<->1 holder transitions to the centralized controller
        # directory).  RLock: remove_local_ref runs from ObjectRef.__del__,
        # which GC may fire while this thread already holds the lock.
        self._refs_lock = threading.RLock()
        self._local_ref_counts: Dict[ObjectID, int] = {}
        self._submitted_holds: Dict[ObjectID, int] = {}  # in-flight args
        self._owned_ids: Set[ObjectID] = set()      # ids created here
        self._owned_plane: Set[ObjectID] = set()    # owned + in the plane
        self._escaped_refs: Set[ObjectID] = set()   # may have borrowers
        self._local_puts: Set[ObjectID] = set()     # put()s w/o embedded
        self._bg_ops: List = []                     # coalesced loop work
        self._bg_scheduled = False
        # RLock: _bg_submit is reachable from ObjectRef.__del__, and a
        # GC run triggered by an allocation under the lock (the drain
        # loop's list() copy) can re-enter on the same thread.
        self._bg_lock = threading.RLock()
        # Owned in-band refs that were pickled OUT of this process while
        # still pending: their values must be written through to the
        # object plane on completion (see promote_refs_to_plane).
        self._escaped: Set[ObjectID] = set()
        self._borrows_registered: Set[ObjectID] = set()
        self._free_on_complete: Set[ObjectID] = set()
        # Lineage: creation specs of owned plane objects, replayed when
        # every copy is lost (ref: object_recovery_manager.h:38).
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        self._reconstructing: Dict[ObjectID, asyncio.Future] = {}
        self._actor_submit_locks: Dict[ActorID, asyncio.Lock] = {}
        # Lease pool (ref: normal_task_submitter.h scheduling_key_entries_):
        # all state touched only on the io loop thread.
        self._sched_states: Dict[tuple, _SchedKeyState] = {}
        self._lease_sweeper: Optional[asyncio.Task] = None
        self._streams: Dict[str, _StreamState] = {}
        self._submit_buf: List[tuple] = []
        self._submit_buf_lock = threading.Lock()
        # Batched-exec channel: reply_id -> (status_fut, st, pl, item).
        self._reply_counter = itertools.count(1)
        self._reply_waiters: Dict[int, tuple] = {}
        self._shutdown_flag = False
        self._event_cursor = 0
        # Owner-side scheduling-transition events (queued ->
        # lease_requested -> pipelined/granted -> requeued), flushed
        # to the controller's task-event sink so `rt explain` can show
        # WHY a task landed where it did.  Buffer is bounded; a
        # submission storm drops oldest explainability events rather
        # than growing without limit.
        self._sched_ev_buf: List[Dict] = []
        self._sched_ev_lock = threading.Lock()
        self._sched_ev_dropped = 0
        self._sched_flusher_started = False
        # Hot-path introspection: completed phase records (sampled
        # tasks only) ride the same 0.5s task_events flush — zero
        # extra wakeups or RPCs on the submission path.
        self._hotpath_buf: List[Dict] = []
        # Actor replies awaiting redelivery across an owner reconnect
        # (reply_id set; guards double-spawn on repeated disconnects).
        self._redelivering: Set[int] = set()
        # Worker-role: current lease for blocked-CPU accounting.
        self.current_lease_id: Optional[int] = None
        self.io.run(self._async_init())
        job_id = _job_id
        self._registered_job_int: Optional[int] = None
        if job_id is None:
            r = self.io.run(self._ctl.call("register_job", {
                "driver": f"pid-{os.getpid()}",
                # Multi-tenant link: a submitted job's entrypoint
                # driver carries its submission id so leases/PGs
                # tagged with this internal job resolve to the tenant
                # for quota enforcement and goodput attribution.
                "tenant": os.environ.get("RT_JOB_ID", "")}))
            job_id = JobID.from_int(r["job_id"])
            self._registered_job_int = r["job_id"]
        super().__init__(config, job_id)
        if not self.is_worker:
            self.io.spawn(self._event_poll_loop())

    # ----------------------------------------------------------- bring-up
    @staticmethod
    def _session_name() -> str:
        # The random part keeps two drivers that start in the same second
        # with the same pid (separate pid namespaces) apart, down to their
        # shared-memory segment names.
        return f"{int(time.time())}_{os.getpid()}_{os.urandom(3).hex()}"

    def _start_head(self, config, num_cpus, num_gpus, custom):
        from . import node_launcher

        session = self._session_name()
        proc, controller_addr = node_launcher.start_controller(
            config, session, driver_pid=os.getpid())
        self._procs.append(proc)
        proc, agent_addr, _nid = node_launcher.start_node_agent(
            config, session, controller_addr, num_cpus=num_cpus,
            num_gpus=num_gpus, custom_resources=custom, is_head=True,
            tag="head")
        self._procs.append(proc)
        return session, controller_addr, agent_addr

    def _connect_existing(self, config, address, num_cpus, num_gpus, custom):
        """Driver connecting to a running cluster; needs a colocated agent.
        Starts one if this host has none (matching ray.init(address=...)
        semantics where the driver machine must run a raylet)."""
        probe = EventLoopThread("rt-probe")
        try:
            cli = RpcClient(address, connect_timeout=10.0)
            info = probe.run(self._probe(cli))
            session = info["session"]
            nodes = info["nodes"]
            from .net import host_of, is_local_address

            agent_addr = None
            for n in nodes:
                if n["alive"] and is_local_address(
                        host_of(n["agent_addr"])):
                    agent_addr = n["agent_addr"]
                    break
            if agent_addr is None:
                raise RuntimeError("no local node agent found to attach to")
            return session, address, agent_addr
        finally:
            probe.stop()

    @staticmethod
    async def _probe(cli: RpcClient):
        pong = await cli.call("ping")
        nodes = await cli.call("list_nodes", {})
        await cli.close()
        return {"session": pong["session"], "nodes": nodes}

    async def _async_init(self):
        self._ctl = RpcClient(self.controller_addr,
                              tag=f"rt-{os.getpid()}")
        await self._ctl.connect()
        self._agent = RpcClient(self.agent_addr, tag=f"rt-{os.getpid()}")
        await self._agent.connect()
        # Direct-write channel for per-object control notifies (see
        # NotifySideChannel): connected lazily on first notify, but
        # never DIALED from the io-loop thread (a GC-triggered release
        # there must not block the loop on a connect).
        from .rpc import NotifySideChannel

        io_thread = threading.current_thread()  # we're on the io loop
        self._side_channel = NotifySideChannel(
            self.agent_addr,
            avoid_dial=lambda: threading.current_thread() is io_thread)

    # ------------------------------------------------------------- helpers
    def _completion_event(self, oid: ObjectID) -> asyncio.Event:
        ev = self._completion_events.get(oid)
        if ev is None:
            ev = self._completion_events[oid] = asyncio.Event()
        return ev

    def _mark_pending(self, oids: List[ObjectID]) -> None:
        with self._pending_lock:
            self._pending_returns.update(oids)
        with self._refs_lock:
            self._owned_ids.update(oids)

    # ------------------------------------------ in-band -> plane promotion
    def promote_refs_to_plane(self, oids) -> None:
        """Write owned MEMORY-STORE-ONLY values through to the object
        plane when their refs escape this process — pickled into task
        args, a put payload, or a return value (ref: core_worker
        promoting inlined small objects to plasma once their ObjectRef
        is borrowed).  Without this, another process that receives such
        a ref polls the object directory forever: the value exists only
        in our address space.  Still-pending refs are remembered and
        promoted when their result arrives (_accept_returns)."""
        for oid in oids:
            # Order matters (TOCTOU): set the promotion promise FIRST,
            # then look for the value.  Whichever side sees both the
            # value and the promise does the write-through — a result
            # landing between our steps is promoted by the completion
            # path (which stores the value before reading _escaped
            # under the same lock).  Double promotion is idempotent.
            with self._refs_lock:
                if oid not in self._owned_ids or \
                        oid in self._owned_plane:
                    continue
                self._escaped.add(oid)
            ok, val = self.memory.get_nowait(oid)
            if not ok:
                continue  # pending: completion path fulfils the promise
            with self._refs_lock:
                self._escaped.discard(oid)
            if isinstance(val, (_StoreRef, TaskError)):
                continue
            self._write_through(oid, val)

    def _write_through(self, oid: ObjectID, val: Any) -> None:
        try:
            size = self.store.create_and_seal(oid, val)
        except Exception:
            logger.warning("in-band promotion of %s failed",
                           oid.hex()[:12], exc_info=True)
            return
        with self._refs_lock:
            self._owned_plane.add(oid)
        from .rpc import spawn_task

        async def _register():
            try:
                await self._agent.call("register_object",
                                       {"object_id": oid, "size": size})
            except Exception:
                pass  # consumers keep polling; next heartbeat re-syncs

        # Fire-and-forget: callers may already be ON the io loop
        # (completion path), so never block on it here.
        self.io.call_soon(lambda: spawn_task(_register(), self.io.loop))

    @staticmethod
    def _scan_embedded_refs(values) -> List[ObjectID]:
        """Ids of ObjectRefs nested anywhere inside ``values`` (one
        cloudpickle pass with the ref collector active)."""
        from ray_tpu_torch._vendor import cloudpickle

        from .object_ref import collect_embedded_refs

        interesting = [v for v in values
                       if not isinstance(v, (int, float, str, bytes,
                                             bool, type(None)))]
        if not interesting:
            return []
        with collect_embedded_refs() as found:
            try:
                # buffer_callback keeps large binary payloads (numpy
                # etc.) out-of-band and UNCOPIED — this pass only needs
                # the ref collector side effect, not the bytes.
                cloudpickle.dumps(interesting, protocol=5,
                                  buffer_callback=lambda _b: None)
            except Exception:
                return []
        return list(found)

    def _store_result_value(self, oid: ObjectID, value: Any) -> None:
        self.memory.put(oid, value)
        with self._refs_lock:
            escaped = oid in self._escaped
            self._escaped.discard(oid)
        if escaped and not isinstance(value, (_StoreRef, TaskError)):
            # A ref to this (then-pending) value left the process;
            # fulfil the promotion promise now that the value exists.
            # Off-loop: this path runs on the io loop and the seal can
            # ride store backpressure.
            loop = self.io.loop
            self.io.call_soon(
                lambda: loop.run_in_executor(None, self._write_through,
                                             oid, value))
        with self._pending_lock:
            self._pending_returns.discard(oid)
        ev = self._completion_events.get(oid)
        if ev is not None:
            ev.set()
        with self._refs_lock:
            free_now = (oid in self._free_on_complete
                        and self._local_ref_counts.get(oid, 0) == 0
                        and self._submitted_holds.get(oid, 0) == 0)
            self._free_on_complete.discard(oid)
        if free_now:
            self._release_object(oid)

    # --------------------------------------------- reference counting hooks
    def add_local_ref(self, object_id: ObjectID) -> None:
        with self._refs_lock:
            n = self._local_ref_counts.get(object_id, 0)
            self._local_ref_counts[object_id] = n + 1
            if n > 0 or object_id in self._owned_ids \
                    or object_id in self._borrows_registered \
                    or self._shutdown_flag:
                return
            # First local ref to a foreign object: we are a borrower —
            # tell the directory so the owner's release can't free it
            # from under us.
            self._borrows_registered.add(object_id)
        self._notify_async("add_borrower", {
            "object_id": object_id, "holder": self._runtime_id})

    def remove_local_ref(self, object_id: ObjectID) -> None:
        if self._shutdown_flag:
            return
        with self._refs_lock:
            n = self._local_ref_counts.get(object_id, 0) - 1
            if n > 0:
                self._local_ref_counts[object_id] = n
                return
            self._local_ref_counts.pop(object_id, None)
            if n < 0:  # ref born under a previous runtime in this process
                return
            if self._submitted_holds.get(object_id, 0) > 0:
                return  # release happens when the in-flight task finishes
            with self._pending_lock:
                if object_id in self._pending_returns:
                    # Fire-and-forget: the producing task still runs; the
                    # result is freed when it lands.
                    self._free_on_complete.add(object_id)
                    return
        self._release_object(object_id)

    def mark_ref_escaped(self, oid: ObjectID) -> None:
        """This ref left the process (pickled, or passed as a task
        arg): another process may register a borrow, so the eager
        local free in _release_object is off for it — only the
        controller-driven release (which waits out borrowers) may
        delete the primary copy."""
        with self._refs_lock:
            self._escaped_refs.add(oid)

    def _add_submitted_holds(self, oids: List[ObjectID]) -> None:
        """Pin args of an in-flight task (ref: reference_count.h
        submitted_task_ref_count) — `f.remote(g.remote())` drops the inner
        ref right after submission; the hold keeps the object alive until
        the consuming task completes."""
        with self._refs_lock:
            for oid in oids:
                self._escaped_refs.add(oid)
                self._submitted_holds[oid] = \
                    self._submitted_holds.get(oid, 0) + 1

    def _release_submitted_holds(self, oids: List[ObjectID]) -> None:
        for oid in oids:
            with self._refs_lock:
                n = self._submitted_holds.get(oid, 0) - 1
                if n > 0:
                    self._submitted_holds[oid] = n
                    continue
                self._submitted_holds.pop(oid, None)
                if self._local_ref_counts.get(oid, 0) > 0:
                    continue
                with self._pending_lock:
                    if oid in self._pending_returns:
                        self._free_on_complete.add(oid)
                        continue
            self._release_object(oid)

    def _release_object(self, oid: ObjectID) -> None:
        """All local holders are gone: drop the value and tell the
        directory (owner release or borrow removal)."""
        self.memory.delete(oid)
        with self._refs_lock:
            owned = oid in self._owned_ids
            self._owned_ids.discard(oid)
            plane = oid in self._owned_plane
            self._owned_plane.discard(oid)
            self._lineage.pop(oid, None)
            borrowed = oid in self._borrows_registered
            self._borrows_registered.discard(oid)
            escaped = oid in self._escaped_refs
            self._escaped_refs.discard(oid)
            local_put = oid in self._local_puts
            self._local_puts.discard(oid)
        if owned and plane:
            if not escaped:
                # Eager local free (ref: plasma's out-of-scope delete):
                # the ref never left this process, so no borrower can
                # exist — free the store bytes NOW so the allocator
                # reuses the (hot) block, instead of waiting out the
                # release round trip through the controller.  The
                # directory entry still retires below; the store
                # delete there becomes a no-op.
                try:
                    self.store.delete(oid)
                except Exception:
                    pass
            if self._shutdown_flag:
                return  # teardown owns cleanup; don't re-dial anything
            if local_put and not escaped:
                # Fast release: one NOTIFY to the local agent retires
                # the directory entry + published locations — no
                # controller owner_release/free_object round trip (no
                # borrowers or induced borrows can exist for a
                # never-pickled plain put).  Same-channel FIFO keeps
                # it behind the object's own registration.
                if self._side_channel.notify(
                        "owner_release_local", {"object_id": oid}):
                    return

                def _fast_release():
                    try:
                        self._agent.notify_nowait(
                            "owner_release_local", {"object_id": oid})
                    except Exception:
                        pass  # agent gone: node (and copy) is dying

                self._bg_submit(_fast_release)
            else:
                self._notify_async("owner_release", {"object_id": oid})
        elif borrowed:
            self._notify_async("remove_borrower", {
                "object_id": oid, "holder": self._runtime_id})

    def _bg_submit(self, fn) -> None:
        """Run ``fn`` on the event-loop thread, coalescing wakeups: a
        burst of background ops (register/release per put in a tight
        loop) pays ONE cross-thread self-pipe write while the loop is
        still draining, not one per op — the wakeup send contends on
        the GIL with the loop thread and was costing more than the ops
        themselves.  FIFO order is preserved, so a register queued
        before a release is written first."""
        with self._bg_lock:
            self._bg_ops.append(fn)
            if self._bg_scheduled:
                return
            self._bg_scheduled = True
        try:
            self.io.call_soon(self._bg_drain)
        except Exception:
            # Loop stopped (shutdown race): drop the ops — matching
            # the old fire-and-forget behavior — and unlatch so a
            # later submit doesn't silently no-op forever.
            with self._bg_lock:
                self._bg_ops.clear()
                self._bg_scheduled = False

    def _bg_drain(self) -> None:
        while True:
            with self._bg_lock:
                if not self._bg_ops:
                    self._bg_scheduled = False
                    return
                # Swap, don't copy+clear: a GC-triggered re-entrant
                # submit landing mid-copy would be wiped by clear().
                ops, self._bg_ops = self._bg_ops, []
            for fn in ops:
                try:
                    fn()
                except Exception:
                    pass

    def _notify_async(self, method: str, payload: Dict) -> None:
        """Fire-and-forget controller notification from any thread
        (including GC running __del__); must never block or raise."""
        if self._shutdown_flag:
            return
        try:
            self._bg_submit(lambda: self.io.loop.create_task(
                self._notify_ignore_errors(method, payload)))
        except Exception:
            pass

    async def _notify_ignore_errors(self, method: str,
                                    payload: Dict) -> None:
        try:
            await self._ctl.call(method, payload)
        except (RpcError, RemoteCallError, asyncio.CancelledError):
            pass

    @property
    def caller_tag(self) -> str:
        """Tag this runtime registers on worker connections; workers
        notify stream items back to it."""
        return f"owner-{self._runtime_id}"

    # ----------------------------------------- scheduler explainability
    def _sched_event(self, spec: TaskSpec, state: str,
                     **detail) -> None:
        """Record one owner-side scheduling transition with reason
        tags (ref: the task-state machine in gcs_task_manager — here
        extended with the owner's lease-pool decisions, which the
        reference leaves invisible).  Any thread; never raises."""
        try:
            ev = {"task_id": spec.task_id.hex(), "state": state,
                  "ts": time.time(), "name": spec.display_name(),
                  "kind": spec.kind.name,
                  "attempt": getattr(spec, "sched_attempt", 0)}
            if detail:
                ev["detail"] = {k: v for k, v in detail.items()
                                if v is not None}
            with self._sched_ev_lock:
                self._sched_ev_buf.append(ev)
                if len(self._sched_ev_buf) > 10000:
                    # Counted, not silent: the drop tally rides the
                    # next flush into the controller's
                    # task_events_dropped so a gapped `rt explain`
                    # chain is attributable to backpressure.
                    self._sched_ev_dropped += 5000
                    del self._sched_ev_buf[:5000]
                start = not self._sched_flusher_started
                if start:
                    self._sched_flusher_started = True
            if start:
                from .rpc import spawn_task

                self.io.call_soon(
                    lambda: spawn_task(self._sched_event_flush_loop(),
                                       self.io.loop))
        except Exception:
            pass

    async def _sched_event_flush_loop(self) -> None:
        while not self._shutdown_flag:
            await asyncio.sleep(0.5)
            with self._sched_ev_lock:
                batch, self._sched_ev_buf = self._sched_ev_buf, []
                dropped, self._sched_ev_dropped = \
                    self._sched_ev_dropped, 0
                hp_batch, self._hotpath_buf = self._hotpath_buf, []
            if not batch and not dropped and not hp_batch:
                continue
            payload = {"events": batch, "dropped": dropped}
            if hp_batch:
                payload["hotpath"] = hp_batch
                payload["source"] = self.caller_tag
            try:
                await self._ctl.call("task_events", payload)
            except (RpcError, RemoteCallError,
                    asyncio.CancelledError):
                # Explainability is best-effort, but keep the drop
                # tally for the next successful flush.  (Hot-path
                # records are sampled observability — dropped.)
                with self._sched_ev_lock:
                    self._sched_ev_dropped += dropped

    def _hotpath_record(self, spec: TaskSpec, hp: List[float]) -> None:
        """Io loop: stamp OWNER_DONE, fold the vector into a phase
        record, and buffer it for the task_events flush tick.  Never
        raises — this sits on the result-accept path."""
        try:
            from ..util import hotpath as _hotpath

            hp[_hotpath.OWNER_DONE] = time.perf_counter()
            rec = _hotpath.record_from_stamps(hp, spec.display_name())
            if rec is None:
                return
            with self._sched_ev_lock:
                self._hotpath_buf.append(rec)
                if len(self._hotpath_buf) > 4096:
                    del self._hotpath_buf[:2048]
                start = not self._sched_flusher_started
                if start:
                    self._sched_flusher_started = True
            if start:
                from .rpc import spawn_task

                self.io.call_soon(
                    lambda: spawn_task(self._sched_event_flush_loop(),
                                       self.io.loop))
        except Exception:
            pass

    async def _worker_client(self, addr: str) -> RpcClient:
        cli = self._worker_clients.get(addr)
        if cli is None or not cli.connected:
            cli = RpcClient(addr, tag=self.caller_tag,
                            connect_timeout=10.0)
            cli.on_notify("stream_item", self._on_stream_item)
            cli.on_notify("task_results", self._on_task_results)
            cli.on_disconnect(
                lambda a=addr: self._on_worker_disconnect(a))
            await cli.connect()
            self._worker_clients[addr] = cli
        return cli

    # ---------------------------------------------- streaming generators
    def _on_stream_item(self, p: Dict) -> None:
        """Io-loop: a generator task yielded item ``index`` (ref:
        the owner-side report handling behind ObjectRefGenerator)."""
        st = self._streams.get(p["task_id"].hex())
        if st is None:
            return
        oid = p["object_id"]
        kind, data = p["entry"]
        with self._refs_lock:
            self._owned_ids.add(oid)
            if kind != "inline":
                self._owned_plane.add(oid)
        if kind == "inline":
            from . import serialization

            self.memory.put(oid, serialization.unpack(data))
        else:
            size, node_hint = data
            self.memory.put(oid, _StoreRef(size, node_hint))
        with st.lock:
            st.ready.append(oid)
            st.produced = max(st.produced, p["index"])
        st.event.set()

    def _finalize_stream(self, spec: TaskSpec,
                         result: Optional[TaskResult],
                         error: Optional[Any] = None) -> None:
        st = self._streams.get(spec.task_id.hex())
        sentinel = spec.return_object_ids()[0]
        sub = self._submissions.pop(sentinel, None)
        if sub is not None:
            sub.done = True
        if st is not None:
            with st.lock:
                st.done = True
                if result is not None and result.ok:
                    st.total = result.streamed
                else:
                    st.error = (result.error if result is not None
                                else error)
            st.event.set()
        self._store_result_value(sentinel, None)
        if result is not None:
            for emb in result.transit_refs or []:
                self._notify_async("remove_borrower", {
                    "object_id": emb,
                    "holder": f"transit:{spec.task_id.hex()}"})

    def _stream_put_error(self, oid: ObjectID, err: Any) -> None:
        with self._refs_lock:
            self._owned_ids.add(oid)
        self.memory.put(oid, err)

    def _stream_close(self, task_id) -> None:
        """Drop a stream's owner-side state (consumer exhausted or
        abandoned it); a still-running producer gets a best-effort
        cancel so its backpressure wait can't spin forever."""
        st = self._streams.pop(task_id.hex(), None)
        if st is None or st.done:
            return
        from .ids import ObjectID as _OID

        sentinel = _OID.for_task_return(task_id, 0)
        sub = self._submissions.get(sentinel)
        if sub is not None and not sub.done:
            sub.cancelled = True
            self.io.call_soon(sub.cancel_event.set)
            try:
                self.io.run(self._cancel_inflight(sub), timeout=5.0)
            except Exception:
                pass

    def stream_ack(self, task_id, consumed: int,
                   worker_addr: Optional[str]) -> None:
        """Generator consumer thread: release executor backpressure."""
        if worker_addr is None:
            return

        async def _send():
            try:
                cli = await self._worker_client(worker_addr)
                await cli.notify("stream_ack", {
                    "task_id": task_id, "consumed": consumed})
            except (RpcError, OSError):
                pass  # worker gone; the final result surfaces it

        from .rpc import spawn_task

        self.io.call_soon(lambda: spawn_task(_send(), self.io.loop))

    async def _event_poll_loop(self):
        """Long-poll controller pubsub to invalidate actor caches and
        stream this job's worker logs to the console (ref:
        src/ray/pubsub long-poll subscriber + log_monitor.py driver
        streaming)."""
        channels = ["actor", "node"]
        stream_logs = getattr(self.config, "log_to_driver", True)
        if stream_logs:
            channels.append("worker_logs")
        while not self._shutdown_flag:
            try:
                r = await self._ctl.call("poll_events", {
                    "cursor": self._event_cursor,
                    "channels": channels, "timeout": 10.0},
                    timeout=15.0)
            except (RpcError, asyncio.TimeoutError, RemoteCallError):
                await asyncio.sleep(0.5)
                continue
            self._event_cursor = r.get("cursor", self._event_cursor)
            if r.get("cursor_expired"):
                # Events were trimmed past our cursor: cached actor states
                # may silently be stale (a missed DEAD would route calls to
                # a gone address forever).  Full resync: drop the cache so
                # the next _actor_info falls through to the controller.
                self._actor_cache.clear()
                continue
            for _seq, ch, data in r.get("events", []):
                if ch == "actor":
                    aid = data["actor_id"]
                    cached = self._actor_cache.get(aid)
                    if cached is not None:
                        cached["state"] = data["state"]
                        cached["worker_addr"] = data.get("worker_addr", "")
                elif ch == "worker_logs" and stream_logs:
                    self._print_worker_logs(data)

    def _print_worker_logs(self, rec) -> None:
        """Print a worker-log batch belonging to THIS job, tagged like
        the reference's ``(pid=..., ip=...)`` prefix."""
        if rec.get("job_id") != self.job_id.hex():
            return
        prefix = (f"({rec.get('pid')}, "
                  f"node={str(rec.get('node_id', ''))[:8]}) ")
        out = "".join(prefix + line + "\n"
                      for line in rec.get("lines", []))
        if out:
            sys.stdout.write(out)
            sys.stdout.flush()

    # ------------------------------------------------- dependency resolution
    async def _resolve_deps(self, spec: TaskSpec,
                            sub: Optional[_Submission] = None) -> None:
        """Owner-side resolution (ref: dependency_resolver.h): wait for
        owned pending refs; inline small owned values; leave plane refs for
        the executor to pull.  A cancelled submission interrupts the wait
        — otherwise cancel() on a dep-blocked task would hang forever."""
        for arg in spec.args:
            if arg.kind != ArgKind.OBJECT_REF:
                continue
            oid = arg.object_id
            with self._pending_lock:
                pending = oid in self._pending_returns
            if pending:
                waiters = [asyncio.ensure_future(
                    self._completion_event(oid).wait())]
                if sub is not None:
                    waiters.append(asyncio.ensure_future(
                        sub.cancel_event.wait()))
                try:
                    await asyncio.wait(
                        waiters, return_when=asyncio.FIRST_COMPLETED)
                finally:
                    for w in waiters:
                        w.cancel()
                if sub is not None and sub.cancelled:
                    raise _CancelledInFlight()
            ok, val = self.memory.get_nowait(oid)
            if ok and not isinstance(val, _StoreRef):
                if isinstance(val, TaskError):
                    raise val
                arg.kind = ArgKind.VALUE
                arg.value = val
                arg.object_id = None

    # ------------------------------------------------------- normal tasks
    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        if spec.is_streaming:
            self._streams[spec.task_id.hex()] = _StreamState()
        oids = spec.return_object_ids()
        self._mark_pending(oids)
        self._sched_event(spec, "QUEUED",
                          strategy=spec.scheduling.kind,
                          resources=dict(spec.resources.amounts),
                          poolable=self._poolable(spec))
        held = [a.object_id for a in spec.args
                if a.kind == ArgKind.OBJECT_REF and a.object_id is not None]
        self._add_submitted_holds(held)
        embedded = self._scan_embedded_refs(
            [a.value for a in spec.args if a.kind == ArgKind.VALUE])
        if embedded:
            self.promote_refs_to_plane(embedded)
        sub = _Submission(spec)
        for oid in oids:
            self._submissions[oid] = sub
        # Submission coalescing: a burst of .remote() calls from the
        # user thread wakes the io loop ONCE — the drain callback
        # spawns every buffered submission (call_soon_threadsafe is a
        # lock+futex pair per call otherwise; a 300-task batch paid
        # 300 of them).
        with self._submit_buf_lock:
            self._submit_buf.append((spec, sub, held))
            first = len(self._submit_buf) == 1
        if first:
            self.io.call_soon(self._drain_submit_buf)
        if spec.is_streaming:
            from .object_ref import ObjectRefGenerator

            return [ObjectRefGenerator(spec.task_id, oids[0], self)]
        return [ObjectRef(o) for o in oids]

    def _drain_submit_buf(self) -> None:
        """Io loop: spawn every submission buffered since the wakeup."""
        from .rpc import spawn_task

        with self._submit_buf_lock:
            batch, self._submit_buf = self._submit_buf, []
        for spec, sub, held in batch:
            spawn_task(self._submit_normal(spec, sub, held),
                       self.io.loop)

    async def _submit_normal(self, spec: TaskSpec,
                             sub: Optional[_Submission] = None,
                             held: Optional[List[ObjectID]] = None) -> None:
        sub = sub or _Submission(spec)
        try:
            await self._submit_normal_inner(spec, sub)
        finally:
            if held:
                self._release_submitted_holds(held)

    async def _submit_normal_inner(self, spec: TaskSpec,
                                   sub: _Submission) -> None:
        try:
            await self._resolve_deps(spec, sub)
        except _CancelledInFlight:
            self._fail_returns(spec, TaskError.from_exception(
                TaskCancelledError(
                    f"task {spec.display_name()} was cancelled")))
            return
        except TaskError as e:
            self._fail_returns(spec, e)
            return
        attempts_left = spec.max_retries
        if spec.is_streaming:
            # Streaming tasks never retry: items already delivered to
            # the consumer cannot be un-consumed, so a replay would
            # duplicate them (documented deviation: the reference
            # replays generators and dedups by item index).
            attempts_left = 0
        recoveries_left = 3  # bound on lost-arg reconstruct-and-retry
        delay = self.config.task_retry_delay_ms / 1000.0
        while True:
            try:
                if sub.cancelled:
                    raise _CancelledInFlight()
                if self._poolable(spec):
                    result = await self._submit_via_pool(spec, sub)
                else:
                    result = await self._lease_and_push(spec, sub)
            except _CancelledInFlight:
                self._fail_returns(spec, TaskError.from_exception(
                    TaskCancelledError(
                        f"task {spec.display_name()} was cancelled")))
                return
            except (RpcError, WorkerCrashedError) as e:
                if sub.cancelled:
                    # force-cancel killed the worker mid-push; report
                    # cancellation, not a crash, and never retry.
                    self._fail_returns(spec, TaskError.from_exception(
                        TaskCancelledError(
                            f"task {spec.display_name()} was cancelled")))
                    return
                if attempts_left != 0:
                    if attempts_left > 0:
                        attempts_left -= 1
                    spec.sched_attempt += 1
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, 2.0)
                    continue
                self._fail_returns(spec, TaskError.from_exception(
                    WorkerCrashedError(str(e))))
                return
            except RemoteCallError as e:
                self._fail_returns(spec, TaskError.from_exception(e.cause))
                return
            if not result.ok:
                if getattr(result, "requeue", False):
                    # Direct-path push landed on a worker whose running
                    # task is blocked: resubmit through a fresh lease.
                    self._sched_event(spec, "REQUEUED",
                                      worker=sub.worker_addr,
                                      reason="worker_blocked")
                    await asyncio.sleep(0.01)
                    continue
                err = result.error
                if spec.is_streaming:
                    self._finalize_stream(spec, result)
                    return
                if isinstance(err, ObjectLostError) and not sub.cancelled \
                        and recoveries_left > 0 \
                        and await self._recover_lost_args(spec) \
                        and (recoveries_left := recoveries_left - 1) >= 0:
                    # An argument's copies were lost while the task was in
                    # flight; the owner reconstructed them — retry without
                    # consuming the user's retry budget (ref:
                    # task_manager.cc resubmit on OBJECT_UNRECONSTRUCTABLE
                    # is owner-driven, not a task failure).
                    spec.sched_attempt += 1
                    continue
                if spec.retry_exceptions and attempts_left != 0 \
                        and not sub.cancelled:
                    if attempts_left > 0:
                        attempts_left -= 1
                    spec.sched_attempt += 1
                    await asyncio.sleep(delay)
                    continue
                self._fail_returns(spec, err if isinstance(err, TaskError)
                                   else TaskError.from_exception(err))
                return
            self._accept_returns(spec, result)
            return

    async def _renv_blobs_present(self, key: str, wire) -> bool:
        """Throttled check that the controller still holds this env's
        package blobs — its KV applies an LRU cap (runtime_env_cache_
        bytes), and a worker spawned against an evicted blob fails.
        A positive result is cached for 30 s."""
        checked = getattr(self, "_renv_checked", None)
        if checked is None:
            checked = self._renv_checked = {}
        now = asyncio.get_event_loop().time()
        if now - checked.get(key, -1e9) < 30.0:
            return True
        digests = ([wire["working_dir_pkg"]]
                   if wire.get("working_dir_pkg") else []) + \
            [e["pkg"] for e in wire.get("py_modules_pkgs", [])]
        for digest in digests:
            found = await self._ctl.call(
                "kv_keys", {"prefix": f"runtime_env/pkg/{digest}"})
            if not found:
                checked.pop(key, None)
                return False
        checked[key] = now
        return True

    async def _runtime_env_payload(self, spec: TaskSpec):
        """Package + upload the task's runtime_env once per driver; the
        lease payload carries only the small wire spec (ref: worker
        pool keyed by runtime-env hash, worker_pool.h:216)."""
        raw = getattr(spec, "runtime_env", None)
        if not raw:
            return None
        import json as _json

        cache = getattr(self, "_renv_cache", None)
        if cache is None:
            cache = self._renv_cache = {}
        key = _json.dumps(raw, sort_keys=True)
        fut = cache.get(key)
        if fut is not None:
            # Concurrent submitters share one packaging pass; a cached
            # failure re-raises for every awaiter.
            wire = await fut
            if wire is None or await self._renv_blobs_present(key, wire):
                return wire
            cache.pop(key, None)  # blobs LRU-evicted: re-package below
            fut = None
        loop = asyncio.get_event_loop()
        fut = cache[key] = loop.create_future()
        from .. import runtime_env as renv

        try:
            # Zip + hash can be hundreds of MiB — keep it off the io
            # loop, which also carries every other RPC of this driver.
            wire, blobs = await loop.run_in_executor(
                None, lambda: renv.package(renv.normalize(raw) or {}))
            if len(wire) <= 1:  # only the hash of an empty env
                wire = None
            else:
                for kv_key, data in blobs.items():
                    existing = await self._ctl.call("kv_keys",
                                                    {"prefix": kv_key})
                    if not existing:
                        await self._ctl.call(
                            "kv_put", {"key": kv_key, "value": data})
        except (ValueError, TypeError) as e:
            # Surface as a task failure (the submit loop's except clauses
            # resolve the returns); never let it escape the io-loop task,
            # which would leave the ObjectRef unresolved forever.
            err = RemoteCallError(e)
            fut.set_exception(err)
            fut.exception()  # consumed; avoid 'never retrieved' warnings
            raise err from None
        except Exception as e:
            cache.pop(key, None)  # transient (e.g. RPC): allow retry
            fut.set_exception(e)
            fut.exception()
            raise
        fut.set_result(wire)
        return wire

    # ------------------------------------------- pooled lease submission
    # Ref: transport/normal_task_submitter.h:74,182 — the owner keeps a
    # per-scheduling-key task queue and a pool of granted leases; an
    # idle leased worker takes the next queued task directly (one push
    # RPC), a lease with no work is returned after a short keep-alive,
    # and at most `lease_request_limit` lease requests are in flight
    # per key (each advertising the remaining backlog for autoscaling).

    @staticmethod
    def _poolable(spec: TaskSpec) -> bool:
        # DEFAULT-strategy tasks only: SPREAD must hit the agent per
        # task to keep spreading, and PG/affinity-bound leases carry
        # placement state that must not outlive one task.
        return spec.scheduling.kind == "DEFAULT"

    def _sched_key(self, spec: TaskSpec, env_key: str) -> tuple:
        return (tuple(sorted(spec.resources.amounts.items())),
                spec.scheduling.kind, env_key, spec.job_id.hex())

    async def _submit_via_pool(self, spec: TaskSpec,
                               sub: _Submission) -> TaskResult:
        renv_wire = await self._runtime_env_payload(spec)
        env_key = (renv_wire or {}).get("hash", "") if renv_wire else ""
        key = self._sched_key(spec, env_key)
        st = self._sched_states.get(key)
        if st is None:
            payload = {
                "resources": dict(spec.resources.amounts),
                "strategy": spec.scheduling.kind,
                "job_id": spec.job_id.hex(),
            }
            if renv_wire is not None:
                payload["runtime_env"] = renv_wire
            st = self._sched_states[key] = _SchedKeyState(key, payload)
        if self._lease_sweeper is None:
            from .rpc import spawn_task

            self._lease_sweeper = spawn_task(self._lease_sweep_loop())
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        if spec.hp is not None:
            from ..util.hotpath import POOL_ENQUEUE

            spec.hp[POOL_ENQUEUE] = time.perf_counter()
        st.queue.append((spec, sub, fut,
                         asyncio.get_event_loop().time()))
        self._pump_key(st)
        waiters = [asyncio.ensure_future(fut),
                   asyncio.ensure_future(sub.cancel_event.wait())]
        try:
            await asyncio.wait(waiters,
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            waiters[1].cancel()
        if not fut.done():
            # Cancelled while still queued: the pump drops the entry.
            fut.cancel()
            raise _CancelledInFlight()
        return fut.result()  # re-raises push/lease errors

    def _pump_key(self, st: _SchedKeyState) -> None:
        """Assign queued tasks to idle pooled leases and top up lease
        requests toward min(backlog, lease_request_limit)."""
        from .rpc import spawn_task

        while st.idle:
            item = self._next_queued(st)
            if item is None:
                break
            pl = st.idle.pop()
            spawn_task(self._lease_worker_loop(st, pl, item))
        # Request NEW capacity only for items no about-to-idle lease
        # picked up within a beat (10ms) — a sequential caller's next
        # task otherwise races the lease loop's idle-append and spawns
        # a spurious lease request (and often a brand-new worker) per
        # call.  With no leases at all, request immediately (cold
        # start must not wait); the sweeper re-pumps every 100ms so
        # genuine backlog still scales out.
        if st.leases:
            now = asyncio.get_event_loop().time()
            # FIFO queue => enqueue times are ascending: the aged
            # items are a PREFIX, so stop at the first young one (and
            # at the request cap) — a full scan per submission would
            # be O(queue) and quadratic over a deep backlog.
            aged = 0
            cap = self.config.lease_request_limit
            for entry in st.queue:
                if now - entry[3] <= 0.01:
                    break
                if not entry[2].done():
                    aged += 1
                    if aged >= cap:
                        break
        else:
            aged = len(st.queue)
        want = min(aged, self.config.lease_request_limit)
        while len(st.request_agents) < want:
            rid = uuid.uuid4().hex
            st.request_agents[rid] = self.agent_addr
            spawn_task(self._request_pool_lease(st, rid))
        if aged < len(st.queue) and not st.repump_scheduled:
            # Some items are inside the request grace: re-pump just
            # after it expires so scale-out requests go out BEFORE the
            # (longer) pipeline grace lets a busy lease steal them —
            # fresh workers must win for long tasks to stay parallel.
            st.repump_scheduled = True

            def _repump():
                st.repump_scheduled = False
                if st.queue:
                    self._pump_key(st)

            asyncio.get_event_loop().call_later(0.015, _repump)

    def _next_queued(self, st: _SchedKeyState, min_age: float = 0.0):
        """Pop the next live queue item; with ``min_age``, only items
        queued at least that long (pipelining waits out the grace
        window so fresh lease grants keep long tasks parallel)."""
        now = asyncio.get_event_loop().time()
        while st.queue:
            head = st.queue[0]
            spec, sub, fut, t_enq = head
            if fut.done():
                st.queue.popleft()
                continue
            if sub.cancelled:
                st.queue.popleft()
                fut.set_exception(_CancelledInFlight())
                continue
            if min_age > 0.0 and now - t_enq < min_age:
                # Young item: hold it for a FRESH lease (the
                # delayed re-pump requests capacity at ~15ms; a
                # busy lease may only steal items older than
                # the pipeline grace).
                return None
            st.queue.popleft()
            return spec, sub, fut, t_enq
        return None

    async def _lease_worker_loop(self, st: _SchedKeyState,
                                 pl: _PooledLease, item=None) -> None:
        """Feed queued tasks to one leased worker with up to
        ``lease_pipeline_depth`` pushes in flight (ref: OnWorkerIdle +
        pipelining, normal_task_submitter.h:144).  The worker runs one
        task at a time from an explicit queue and hands back queued
        tasks if its running task blocks — a requeued item goes to
        the front of the owner queue for another lease."""
        from .rpc import spawn_task

        depth = max(1, self.config.lease_pipeline_depth)
        grace = self.config.lease_pipeline_grace_ms / 1000.0
        inflight: set = set()
        stalled = False   # worker reported blocked: stop feeding it
        stall_round = 0
        while True:
            batch = []
            while not pl.dead and not stalled \
                    and len(inflight) + len(batch) < depth:
                if item is not None:
                    nxt, item = item, None
                else:
                    # The FIRST task takes this worker immediately;
                    # extras pipeline only after the grace window (a
                    # fresh lease grant should claim young items so
                    # long tasks stay parallel).
                    nxt = self._next_queued(
                        st, min_age=0.0 if not (inflight or batch)
                        else grace)
                if nxt is None:
                    break
                batch.append(nxt)
            if batch:
                inflight.update(await self._exec_batch_send(
                    st, pl, batch, len(inflight)))
            pl.inflight = len(inflight)
            if not inflight:
                if pl.dead:
                    self._pump_key(st)
                    return
                if stalled:
                    # The worker is blocked on a task pushed by some
                    # OTHER owner: back off before probing again (an
                    # immediate probe would requeue-spin a hot notify
                    # loop against the blocked worker).
                    stalled = False
                    await asyncio.sleep(
                        min(0.005 * (2 ** min(stall_round, 5)), 0.1))
                    stall_round += 1
                    continue
                pl.idle_since = asyncio.get_event_loop().time()
                st.idle.append(pl)
                return
            if len(inflight) < depth and st.queue:
                # Head item still inside its grace window: re-check
                # shortly instead of sleeping until a push completes.
                done, inflight = await asyncio.wait(
                    inflight, timeout=grace,
                    return_when=asyncio.FIRST_COMPLETED)
            else:
                done, inflight = await asyncio.wait(
                    inflight, return_when=asyncio.FIRST_COMPLETED)
            statuses = {t.result() for t in done}
            if "requeue" in statuses:
                # A requeue in the batch wins over any "ok" from the
                # same round: the worker IS blocked right now, and an
                # arbitrary set-iteration order must not un-stall us
                # into bouncing more work off it.
                stalled = True
            elif "ok" in statuses:
                stalled = False
                stall_round = 0

    async def _exec_batch_send(self, st: _SchedKeyState,
                               pl: _PooledLease, items,
                               inflight_before: int = 0) -> list:
        """Ship a batch of tasks to a leased worker as ONE notify
        frame; per-item results come back batched as task_results
        notifies (ref: the push/report split in core_worker.proto —
        batching amortizes frame encode, syscalls, and context
        switches across the batch).  Returns one status future per
        item resolving to "ok" | "requeue" | "dead"."""
        loop = asyncio.get_event_loop()
        rfuts = []
        payload_tasks = []
        for pos, item in enumerate(items):
            spec, sub, fut, _t = item
            rid = next(self._reply_counter)
            sub.agent_addr = pl.agent_addr
            sub.worker_addr = pl.worker_addr
            sub.worker_id = pl.worker_id
            sub.pushed = True
            depth = inflight_before + pos
            self._sched_event(
                spec, "PIPELINED", lease_id=pl.lease_id,
                agent=pl.agent_addr, worker=pl.worker_addr,
                depth=depth,
                reason=("idle_lease" if depth == 0
                        else "pipelined_behind_busy_lease"))
            if spec.is_streaming:
                stream = self._streams.get(spec.task_id.hex())
                if stream is not None:
                    stream.worker_addr = pl.worker_addr
            rfut = loop.create_future()
            self._reply_waiters[rid] = ("pool", rfut, st, pl, item)
            if spec.hp is not None:
                from ..util.hotpath import OWNER_SEND

                spec.hp[OWNER_SEND] = time.perf_counter()
            payload_tasks.append({"spec": spec, "reply_id": rid})
            rfuts.append(rfut)
        try:
            worker = await self._worker_client(pl.worker_addr)
            await worker.notify("exec_batch", {
                "tasks": payload_tasks, "lease_id": pl.lease_id,
                "gpu_ids": pl.gpu_ids,
                "caller_tag": self.caller_tag})
        except Exception:  # noqa: BLE001 — handled as a dead lease
            self._on_worker_disconnect(pl.worker_addr)
        return rfuts

    def _on_task_results(self, payload: Dict) -> None:
        """Io loop: batched results from a leased worker."""
        for rid, res in payload["results"]:
            ent = self._reply_waiters.pop(rid, None)
            if ent is None:
                continue
            if ent[0] == "actor":
                _kind, afut, _addr = ent
                if not afut.done():
                    afut.set_result(res)
                continue
            _kind, rfut, st, pl, item = ent
            spec, sub, fut, _t = item
            if getattr(res, "requeue", False):
                # The worker's running task blocked in get(): fail
                # over to another lease, keeping rough order.
                self._sched_event(spec, "REQUEUED",
                                  lease_id=pl.lease_id,
                                  worker=pl.worker_addr,
                                  reason="worker_blocked")
                st.queue.appendleft(item)
                sub.pushed = False
                self._pump_key(st)
                if not rfut.done():
                    rfut.set_result("requeue")
                continue
            hp = getattr(res, "hp", None)
            if hp is not None:
                from ..util.hotpath import OWNER_REPLY_RECV

                hp[OWNER_REPLY_RECV] = time.perf_counter()
            if not fut.done():
                fut.set_result(res)
            if not rfut.done():
                rfut.set_result("ok")

    def _on_worker_disconnect(self, addr: str) -> None:
        """Io loop: a leased worker's connection died — fail its
        in-flight batched tasks (their submit loops retry) and release
        the lease."""
        err = RpcError(f"connection to {addr} lost")
        to_pump = {}
        for rid, ent in list(self._reply_waiters.items()):
            if ent[0] == "actor":
                # Don't fail the call outright: the reply frame may
                # have been LOST in a connection reregistration race
                # (the worker re-buffers undeliverable replies).
                # Re-dial — which re-registers our tag and triggers
                # the worker's redelivery — and only fail once the
                # grace expires (the PROGRESS reply-loss flake).
                _kind, afut, a_addr = ent
                if a_addr != addr:
                    continue
                if afut.done():
                    # Already resolved (e.g. caller-side cancel)
                    # with the entry still parked: no reply frame
                    # will ever pop it now that the worker is gone,
                    # so drop it here or it leaks forever.
                    self._reply_waiters.pop(rid, None)
                elif rid not in self._redelivering:
                    self._redelivering.add(rid)
                    from .rpc import spawn_task

                    spawn_task(self._await_reply_redelivery(
                        rid, afut, addr))
                continue
            _kind, rfut, st, pl, item = ent
            if pl.worker_addr != addr:
                continue
            self._reply_waiters.pop(rid, None)
            if not pl.dead:
                pl.dead = True
                st.leases.pop((pl.agent_addr, pl.lease_id), None)
                self._return_lease_async(pl, worker_failed=True)
            spec, sub, fut, _t = item
            if not fut.done():
                fut.set_exception(err)
            if not rfut.done():
                rfut.set_result("dead")
            to_pump[id(st)] = st
        for st in to_pump.values():
            self._pump_key(st)

    async def _await_reply_redelivery(self, rid: int, afut, addr: str
                                      ) -> None:
        """An actor-call reply's connection died with the call in
        flight.  Reconnect (re-registering the caller tag, which is
        the worker's redelivery trigger) and give the re-buffered
        reply a grace window to arrive before declaring the call
        lost.  A worker that is actually dead fails the re-dial, so
        real death still surfaces promptly."""
        grace = self.config.reply_redelivery_grace_s
        try:
            try:
                await self._worker_client(addr)
            except Exception:  # noqa: BLE001 — worker truly gone
                self._reply_waiters.pop(rid, None)
                if not afut.done():
                    afut.set_exception(RpcError(
                        f"connection to {addr} lost"))
                return
            try:
                await asyncio.wait_for(asyncio.shield(afut), grace)
                return  # redelivered (or resolved elsewhere)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                # Either afut was cancelled caller-side or this task
                # is being torn down — in both cases the waiter entry
                # is dead and nothing else will remove it.
                self._reply_waiters.pop(rid, None)
                raise
            except Exception:  # noqa: BLE001 — resolved with error
                return
            self._reply_waiters.pop(rid, None)
            if not afut.done():
                afut.set_exception(RpcError(
                    f"connection to {addr} lost (reply not "
                    f"redelivered within {grace:.0f}s)"))
        finally:
            self._redelivering.discard(rid)

    async def _request_pool_lease(self, st: _SchedKeyState,
                                  rid: str) -> None:
        try:
            payload = dict(st.base_payload)
            payload["request_id"] = rid
            agent_addr = self.agent_addr
            hops = 0
            while True:
                st.request_agents[rid] = agent_addr
                agent = await self._agent_for(agent_addr)
                payload["owner_tag"] = self._owner_tag_for(agent_addr)
                grant = await agent.call("request_lease", payload)
                if grant is None:
                    raise RemoteCallError(RuntimeError(
                        f"agent {agent_addr} returned an empty lease "
                        f"grant"))
                if grant.get("cancelled"):
                    return  # queue drained; sweeper yanked the request
                if grant.get("ok"):
                    break
                if grant.get("retry_at") and hops < 8:
                    agent_addr = grant["retry_at"]
                    hops += 1
                    payload["no_spill"] = hops >= 4
                    continue
                raise RemoteCallError(ValueError(
                    grant.get("error", "lease request failed")))
            pl = _PooledLease(grant["lease_id"], agent_addr,
                              grant["worker_addr"],
                              grant.get("worker_id"),
                              grant.get("gpu_ids", []))
            logger.debug("pool lease %s granted by %s (worker %s)",
                         pl.lease_id, agent_addr, grant["worker_addr"])
            # Keyed by (agent, id): lease ids are per-agent counters —
            # two agents both granting "lease 1" must not collide in
            # the pool (a collision silently leaks the overwritten
            # lease's CPU on its agent FOREVER; found via chaos test).
            st.leases[(pl.agent_addr, pl.lease_id)] = pl
            pl.idle_since = asyncio.get_event_loop().time()
            st.idle.append(pl)
            st.request_agents.pop(rid, None)
            self._pump_key(st)
        except (RpcError, RemoteCallError) as e:
            # Fail the queued tasks ONLY when this key has no other
            # way to serve them: no pooled lease (busy ones drain the
            # queue when they go idle) and no other in-flight request.
            # Otherwise one hop-capped or dropped request must not
            # take down tasks another lease would have run (the old
            # one-lease-per-task path only failed its own task).
            st.request_agents.pop(rid, None)
            if st.leases or st.request_agents:
                return
            while st.queue:
                _spec, _sub, fut, _t = st.queue.popleft()
                if not fut.done():
                    fut.set_exception(e)
        finally:
            st.request_agents.pop(rid, None)
            # A request can resolve {cancelled} in a race with a task
            # that enqueued AFTER the sweeper fired the cancel; the
            # pump would then never run again for this key (the
            # sweeper only acts on empty queues).  Re-pump ONLY when
            # nothing else can serve the queue — a busy lease drains
            # it when it goes idle, and pumping while a failing agent
            # is the only target would spin request/fail with no
            # backoff.
            if st.queue and not st.leases and not st.request_agents:
                self._pump_key(st)

    def _return_lease_async(self, pl: _PooledLease,
                            worker_failed: bool = False) -> None:
        from .rpc import spawn_task

        async def _ret():
            try:
                agent = await self._agent_for(pl.agent_addr)
                await agent.call("return_lease", {
                    "lease_id": pl.lease_id,
                    "worker_failed": worker_failed})
                logger.debug("returned lease %s to %s (failed=%s)",
                             pl.lease_id, pl.agent_addr, worker_failed)
            except (RpcError, RemoteCallError) as e:
                logger.debug("return of lease %s to %s failed: %r",
                             pl.lease_id, pl.agent_addr, e)

        spawn_task(_ret(), self.io.loop)

    async def _lease_sweep_loop(self) -> None:
        """Return leases idle past the keep-alive, cancel lease
        requests whose backlog drained, and refresh the per-key
        backlog the local agent advertises as autoscaler demand (ref:
        lease_timeout_ms_ + CancelWorkerLeaseIfNeeded +
        ReportWorkerBacklog in normal_task_submitter.h — backlog is a
        periodic report per scheduling key, NOT a field frozen into a
        queued lease request for up to an hour)."""
        last_backlog: Dict[tuple, int] = {}
        last_pool_report = 0.0
        while not self._shutdown_flag:
            await asyncio.sleep(0.1)
            now = asyncio.get_event_loop().time()
            ttl = self.config.lease_keepalive_s
            if now - last_pool_report >= 0.45:
                last_pool_report = now
                await self._report_lease_pools()
            for key, st in list(self._sched_states.items()):
                if st.queue:
                    # Re-pump: items past the request grace get their
                    # scale-out lease requests here.
                    self._pump_key(st)
                # Queue size BEYOND in-flight lease requests (each
                # queued request already stands for one task in the
                # agent's demand vector).
                backlog = max(0, len(st.queue) - len(st.request_agents))
                if backlog != last_backlog.get(key) or backlog:
                    last_backlog[key] = backlog
                    try:
                        await self._agent.notify("report_backlog", {
                            "owner": self._runtime_id,
                            "key": repr(key),
                            "resources": dict(
                                st.base_payload["resources"]),
                            "backlog": backlog})
                    except (RpcError, OSError):
                        pass
                if not st.queue:
                    for rid, agent_addr in list(st.request_agents.items()):
                        self._cancel_lease_request_async(rid, agent_addr)
                    for pl in [p for p in st.idle
                               if now - p.idle_since > ttl]:
                        st.idle.remove(pl)
                        st.leases.pop((pl.agent_addr, pl.lease_id),
                                      None)
                        self._return_lease_async(pl)
                if not st.queue and not st.leases \
                        and not st.request_agents:
                    self._sched_states.pop(key, None)
                    last_backlog.pop(key, None)

    async def _report_lease_pools(self) -> None:
        """Ship this owner's pooled-lease pipeline depths to the
        granting agents (sweeper cadence) so the agent's lease ledger
        — `rt list leases` — shows how deep each held lease is
        pipelined, owner-side state the agent cannot observe."""
        by_agent: Dict[str, Dict[int, int]] = {}
        for st in self._sched_states.values():
            for pl in st.leases.values():
                if not pl.dead:
                    by_agent.setdefault(pl.agent_addr, {})[
                        pl.lease_id] = pl.inflight
        for addr, leases in by_agent.items():
            # Never DIAL for this: the report rides the sweep loop,
            # and a blackholed peer agent would block every sweep
            # duty (re-pump, idle returns, backlog reports) for the
            # whole connect timeout.  Only already-connected clients
            # get the notify; a lease implies one normally exists.
            if addr == self.agent_addr:
                agent = self._agent
            else:
                agent = getattr(self, "_peer_agent_clients",
                                {}).get(addr)
            if agent is None or not agent.connected:
                continue
            try:
                # notify_nowait, not notify: notify() awaits drain(),
                # and a peer that is connected but not reading would
                # park the sweep loop on transport backpressure — the
                # same every-sweep-duty stall the no-DIAL rule above
                # exists to prevent, just one layer down.
                agent.notify_nowait("report_lease_pool", {
                    "owner": self._runtime_id, "leases": leases})
            except (RpcError, RemoteCallError, OSError):
                pass

    def _cancel_lease_request_async(self, rid: str,
                                    agent_addr: str) -> None:
        from .rpc import spawn_task

        async def _cancel():
            try:
                agent = await self._agent_for(agent_addr)
                await agent.call("cancel_lease_request",
                                 {"request_id": rid})
            except (RpcError, RemoteCallError):
                pass

        spawn_task(_cancel(), self.io.loop)

    async def _lease_and_push(self, spec: TaskSpec,
                              sub: _Submission) -> TaskResult:
        payload = {
            "resources": dict(spec.resources.amounts),
            "strategy": spec.scheduling.kind,
            "request_id": sub.request_id,
            "job_id": spec.job_id.hex(),
        }
        renv_wire = await self._runtime_env_payload(spec)
        if renv_wire is not None:
            payload["runtime_env"] = renv_wire
        if spec.scheduling.kind == "PLACEMENT_GROUP":
            payload["pg_id"] = spec.scheduling.placement_group_id
            payload["bundle_index"] = spec.scheduling.bundle_index
        agent_addr = self.agent_addr
        if spec.scheduling.kind == "NODE_AFFINITY" and \
                spec.scheduling.node_id is not None:
            addr = await self._agent_addr_of(spec.scheduling.node_id)
            if addr is not None:
                agent_addr = addr
                payload["no_spill"] = True
        if spec.scheduling.kind == "PLACEMENT_GROUP":
            addr = await self._pg_agent_addr(payload["pg_id"],
                                             payload["bundle_index"])
            if addr is not None:
                agent_addr = addr
        # Lease loop with spillback redirects (ref:
        # normal_task_submitter.h:182 RequestNewWorkerIfNeeded).
        hops = 0
        while True:
            sub.agent_addr = agent_addr
            agent = await self._agent_for(agent_addr)
            payload["owner_tag"] = self._owner_tag_for(agent_addr)
            self._sched_event(spec, "LEASE_REQUESTED",
                              agent=agent_addr, hops=hops,
                              strategy=spec.scheduling.kind,
                              reason=("spillback_redirect" if hops
                                      else "local_agent"))
            logger.debug("lease req %s -> %s (hops=%d)",
                         spec.display_name(), agent_addr, hops)
            grant = await agent.call("request_lease", payload)
            logger.debug("lease rsp %s <- %s: %s", spec.display_name(),
                         agent_addr, grant and
                         {k: grant[k] for k in ("ok", "retry_at", "error",
                                                "lease_id")
                          if k in grant})
            if grant is None:  # defensive: agent bug, not retryable
                raise RemoteCallError(RuntimeError(
                    f"agent {agent_addr} returned an empty lease grant"))
            if grant.get("cancelled") or sub.cancelled:
                if grant.get("ok"):
                    await agent.call("return_lease",
                                     {"lease_id": grant["lease_id"]})
                raise _CancelledInFlight()
            if grant.get("ok"):
                break
            if grant.get("retry_at") and hops < 8:
                agent_addr = grant["retry_at"]
                hops += 1
                payload["no_spill"] = hops >= 4
                continue
            raise RemoteCallError(ValueError(
                grant.get("error", "lease request failed")))
        lease_id = grant["lease_id"]
        node_id = grant.get("node_id")
        self._sched_event(spec, "GRANTED", lease_id=lease_id,
                          agent=agent_addr,
                          node=(node_id.hex() if hasattr(node_id,
                                                         "hex")
                                else node_id),
                          worker=grant["worker_addr"], hops=hops)
        sub.worker_addr = grant["worker_addr"]
        sub.worker_id = grant.get("worker_id")
        sub.pushed = True
        if spec.is_streaming:
            stream = self._streams.get(spec.task_id.hex())
            if stream is not None:
                stream.worker_addr = grant["worker_addr"]
        try:
            worker = await self._worker_client(grant["worker_addr"])
            reply = await worker.call("push_task", {
                "spec": spec, "gpu_ids": grant.get("gpu_ids", []),
                "lease_id": lease_id,
                "caller_tag": self.caller_tag})
            return reply
        finally:
            try:
                await agent.call("return_lease", {"lease_id": lease_id})
            except RpcError:
                pass

    _peer_agent_clients: Dict[str, RpcClient]

    def _owner_tag_for(self, agent_addr: str) -> str:
        """The connection tag this process uses toward ``agent_addr`` —
        sent with lease requests so the agent can reclaim leases whose
        owner process died without returning them (the agent watches
        the tagged connection; see node_agent._on_owner_conn_lost)."""
        return (f"rt-{os.getpid()}" if agent_addr == self.agent_addr
                else f"rt-peer-{self._runtime_id}")

    async def _agent_for(self, addr: str) -> RpcClient:
        if addr == self.agent_addr:
            return self._agent
        if not hasattr(self, "_peer_agent_clients"):
            self._peer_agent_clients = {}
        cli = self._peer_agent_clients.get(addr)
        if cli is None or not cli.connected:
            cli = RpcClient(addr, tag=f"rt-peer-{self._runtime_id}")
            await cli.connect()
            self._peer_agent_clients[addr] = cli
        return cli

    async def _agent_addr_of(self, node_id: NodeID) -> Optional[str]:
        nodes = await self._ctl.call("list_nodes", {})
        for n in nodes:
            if n["node_id"] == node_id and n["alive"]:
                return n["agent_addr"]
        return None

    async def _pg_agent_addr(self, pg_id, bundle_index) -> Optional[str]:
        deadline = asyncio.get_event_loop().time() + 60.0
        while asyncio.get_event_loop().time() < deadline:
            info = await self._ctl.call("get_placement_group",
                                        {"pg_id": pg_id})
            if info is None:
                return None
            if info["state"] == "CREATED":
                if bundle_index < 0:
                    # Any bundle's node will do; pick the first.
                    placement = info["placement"]
                    if placement:
                        return next(iter(placement.values()))["agent_addr"]
                    return None
                ent = info["placement"].get(bundle_index)
                return ent["agent_addr"] if ent else None
            if info["state"] == "REMOVED":
                return None
            await asyncio.sleep(0.05)
        return None

    def _fail_returns(self, spec: TaskSpec, err: TaskError) -> None:
        if spec.is_streaming:
            self._finalize_stream(spec, None, error=err)
            return
        for oid in spec.return_object_ids():
            sub = self._submissions.pop(oid, None)
            if sub is not None:
                sub.done = True
            self._store_result_value(oid, err)

    def _accept_returns(self, spec: TaskSpec, result: TaskResult) -> None:
        if spec.is_streaming:
            self._finalize_stream(spec, result)
            return
        hp = getattr(result, "hp", None)
        if hp is not None:
            self._hotpath_record(spec, hp)
        from . import serialization

        oids = spec.return_object_ids()
        for oid, (kind, data) in zip(oids, result.returns):
            sub = self._submissions.pop(oid, None)
            if sub is not None:
                sub.done = True
            if kind == "inline":
                # Unpacking materializes any embedded ObjectRefs, whose
                # __init__ hooks register this process's borrows (queued
                # on this same connection, so they reach the controller
                # before the transit release below).
                self._store_result_value(oid, serialization.unpack(data))
            else:  # ("store", (size, node_hint))
                size, node_hint = data
                with self._refs_lock:
                    self._owned_plane.add(oid)
                    if spec.kind == TaskKind.NORMAL:
                        # Deterministic re-execution source for recovery;
                        # actor results are not reconstructable (state).
                        self._lineage[oid] = spec
                self._store_result_value(oid, _StoreRef(size, node_hint))
        # Ownership handoff complete: drop the worker's transit borrows on
        # refs that travelled inside inline return values (the worker
        # registered them before its own references died).
        for emb in getattr(result, "transit_refs", None) or []:
            self._notify_async("remove_borrower", {
                "object_id": emb,
                "holder": f"transit:{spec.task_id.hex()}"})

    # ------------------------------------------------------------- actors
    def create_actor(self, spec: TaskSpec) -> None:
        self._pack_creation_values(spec)
        payload = {
            "spec": spec, "class_name": spec.name.split(".")[0],
            "method_names": spec.method_names,
            "detached": spec.lifetime == "detached",
            "owner_addr": self._runtime_id}
        if spec.actor_name:
            # Named actors keep the synchronous path: the name-conflict
            # refusal must raise HERE, in the caller's frame.
            r = self.io.run(self._ctl.call("register_actor", payload))
            if not r.get("ok"):
                raise ValueError(
                    r.get("error", "actor registration failed"))
            payload = None  # already registered
        else:
            self._actor_reg_pending[spec.actor_id] = True
        held = [a.object_id for a in spec.args
                if a.kind == ArgKind.OBJECT_REF and a.object_id is not None]
        self._add_submitted_holds(held)
        self.io.call_soon(lambda: self.io.loop.create_task(
            self._create_actor_async(spec, held, payload)))

    def _pack_creation_values(self, spec: TaskSpec) -> None:
        """Pack each VALUE creation argument into bytes, once, here: the
        controller keeps the creation spec (replayed on restart) and
        the node agent forwards it, and neither may decode a value (a
        torch object in a model config would import torch into that
        control-plane process).  Refs embedded in the values escape
        with them, so in-band ones are promoted to the plane."""
        from . import serialization
        from .object_ref import collect_embedded_refs

        with collect_embedded_refs() as embedded:
            for arg in spec.args:
                if arg.kind == ArgKind.VALUE:
                    arg.kind = ArgKind.PACKED
                    arg.value = serialization.dumps(arg.value)
        if embedded:
            self.promote_refs_to_plane(embedded)

    async def _create_actor_async(self, spec: TaskSpec,
                                  held: Optional[List[ObjectID]]
                                  = None,
                                  reg_payload: Optional[Dict]
                                  = None) -> None:
        try:
            if reg_payload is not None:
                # Unnamed actor: registration rides the coalescing
                # batch (it cannot hit a name conflict, so deferring
                # the result off the caller's thread loses nothing).
                try:
                    r = await self._register_actor_batched(reg_payload)
                except (RpcError, RemoteCallError) as e:
                    r = {"ok": False, "error": repr(e)}
                finally:
                    self._actor_reg_pending.pop(spec.actor_id, None)
                if not r.get("ok"):
                    # The controller never learned this actor exists,
                    # so callers polling get_actor would only see an
                    # opaque "unknown actor" after the full grace.
                    # Leave a LOCAL terminal cache entry instead: the
                    # first method call fails fast with the real
                    # registration error (death_reason set marks it
                    # as locally authoritative — controller-mirrored
                    # DEAD entries from the event poll carry none).
                    reason = (f"actor registration failed: "
                              f"{r.get('error', 'unknown error')}")
                    logger.warning("actor %s: %s",
                                   spec.actor_id.hex()[:8], reason)
                    self._actor_cache[spec.actor_id] = {
                        "actor_id": spec.actor_id, "state": "DEAD",
                        "worker_addr": "", "death_reason": reason,
                        "class_name": spec.name.split(".")[0],
                        "method_names": spec.method_names,
                        "max_concurrency": spec.max_concurrency,
                        "concurrency_groups": {},
                        "method_options": {}}
                    return
            await self._create_actor_inner(spec)
        finally:
            self._actor_reg_pending.pop(spec.actor_id, None)
            if held:
                self._release_submitted_holds(held)

    async def _register_actor_batched(self, payload: Dict) -> Dict:
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._actor_reg_buf.append((payload, fut))
        if self._actor_reg_flusher is None or \
                self._actor_reg_flusher.done():
            from .rpc import spawn_task

            self._actor_reg_flusher = spawn_task(
                self._flush_actor_regs())
        return await fut

    async def _flush_actor_regs(self) -> None:
        """Drain the registration buffer in bulk register_actors RPCs;
        the 5 ms sleep IS the coalescing window (everything enqueued
        while a flush's RPC is in flight batches into the next)."""
        while self._actor_reg_buf:
            await asyncio.sleep(0.005)
            items, self._actor_reg_buf = self._actor_reg_buf, []
            if not items:
                continue
            try:
                r = await self._ctl.call(
                    "register_actors",
                    {"items": [p for p, _f in items]})
                results = r.get("results") or []
            except (RpcError, RemoteCallError) as e:
                for _p, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for (_p, fut), res in zip(items, results):
                if not fut.done():
                    fut.set_result(res if res is not None
                                   else {"ok": False})
            for _p, fut in items[len(results):]:
                if not fut.done():
                    fut.set_result({"ok": False,
                                    "error": "short bulk reply"})

    async def _create_actor_inner(self, spec: TaskSpec) -> None:
        """Creation-path fault tolerance (ref: gcs_actor_manager.h:90
        — creation failures from infrastructure (node/worker death)
        reschedule the actor elsewhere; only user-code failures and
        placement impossibility are terminal).  The lease+push loop
        below retries RpcErrors with backoff long enough to outlive
        the health-check window during which a dying node still looks
        routable."""
        last_err: Optional[BaseException] = None
        for attempt in range(6):
            if attempt:
                # A previous attempt MAY have reached the worker right
                # before its connection died; if the actor came up,
                # creating a second instance would be worse than wrong.
                try:
                    info = await self._ctl.call(
                        "get_actor", {"actor_id": spec.actor_id})
                except RpcError:
                    info = None
                if info is not None and info.get("state") == "ALIVE":
                    return
                await asyncio.sleep(min(0.2 * (2 ** (attempt - 1)),
                                        2.0))
            try:
                await self._create_actor_attempt(spec)
                return
            except RpcError as e:
                # Infrastructure: agent/worker connection lost mid-
                # create (a node going down) — retry on fresh routing.
                last_err = e
                continue
            except (RemoteCallError, ValueError) as e:
                last_err = e
                break
        try:
            await self._ctl.call("actor_died", {
                "actor_id": spec.actor_id, "creation_failed": True,
                "reason": f"creation failed: {last_err}"})
        except RpcError:
            pass

    async def _create_actor_attempt(self, spec: TaskSpec) -> None:
        try:
            await self._resolve_deps(spec)
            payload = {
                "resources": dict(spec.resources.amounts),
                "strategy": spec.scheduling.kind,
                "is_actor": True, "actor_id": spec.actor_id,
                "job_id": spec.job_id.hex(),
            }
            renv_wire = await self._runtime_env_payload(spec)
            if renv_wire is not None:
                payload["runtime_env"] = renv_wire
            if spec.scheduling.kind == "PLACEMENT_GROUP":
                payload["pg_id"] = spec.scheduling.placement_group_id
                payload["bundle_index"] = spec.scheduling.bundle_index
            agent_addr = self.agent_addr
            if spec.scheduling.kind == "PLACEMENT_GROUP":
                addr = await self._pg_agent_addr(payload["pg_id"],
                                                 payload["bundle_index"])
                if addr is not None:
                    agent_addr = addr
            elif spec.scheduling.kind == "NODE_AFFINITY" and \
                    spec.scheduling.node_id is not None:
                addr = await self._agent_addr_of(spec.scheduling.node_id)
                if addr is not None:
                    agent_addr = addr
                    payload["no_spill"] = True
            hops = 0
            while True:
                agent = await self._agent_for(agent_addr)
                grant = await agent.call("request_lease", payload)
                if grant.get("ok"):
                    break
                if grant.get("retry_at") and hops < 8:
                    agent_addr = grant["retry_at"]
                    hops += 1
                    continue
                raise ValueError(grant.get("error", "lease failed"))
            worker = await self._worker_client(grant["worker_addr"])
            r = await worker.call("create_actor", {
                "spec": spec, "gpu_ids": grant.get("gpu_ids", []),
                "lease_id": grant["lease_id"]})
            if r.get("ok"):
                # The worker's reply means actor_started committed at
                # the controller, so the first method call can skip
                # the get_actor poll entirely — prime the cache with
                # the fields _actor_info consumers read.  A later
                # death still invalidates it (the pubsub actor-event
                # hook and the submit paths pop dead entries).
                self._actor_cache[spec.actor_id] = {
                    "actor_id": spec.actor_id, "state": "ALIVE",
                    "worker_addr": grant["worker_addr"],
                    "class_name": spec.name.split(".")[0],
                    "method_names": spec.method_names,
                    "death_reason": "",
                    "max_concurrency": spec.max_concurrency,
                    "concurrency_groups": dict(
                        getattr(spec, "concurrency_groups", {}) or {}),
                    "method_options": dict(
                        getattr(spec, "method_options", {}) or {})}
        except RpcError:
            raise  # infra failure: _create_actor_inner retries
        except (RemoteCallError, ValueError):
            raise  # terminal: user code / placement impossibility

    def submit_actor_task(self, spec: TaskSpec) -> List[ObjectRef]:
        if spec.is_streaming:
            self._streams[spec.task_id.hex()] = _StreamState()
        oids = spec.return_object_ids()
        self._mark_pending(oids)
        if spec.is_streaming:
            # cancel(gen) must find a routable submission — actor
            # tasks normally have none, but a runaway stream needs
            # the worker-side cancel path.
            sub = _Submission(spec)
            for oid in oids:
                self._submissions[oid] = sub
        held = [a.object_id for a in spec.args
                if a.kind == ArgKind.OBJECT_REF and a.object_id is not None]
        self._add_submitted_holds(held)
        embedded = self._scan_embedded_refs(
            [a.value for a in spec.args if a.kind == ArgKind.VALUE])
        if embedded:
            self.promote_refs_to_plane(embedded)
        self.io.call_soon(lambda: self.io.loop.create_task(
            self._submit_actor(spec, held)))
        if spec.is_streaming:
            from .object_ref import ObjectRefGenerator

            return [ObjectRefGenerator(spec.task_id, oids[0], self)]
        return [ObjectRef(o) for o in oids]

    async def _actor_info(self, actor_id: ActorID,
                          wait_alive: bool = True,
                          timeout: Optional[float] = None) -> Dict:
        if timeout is None:
            timeout = self.config.actor_ready_timeout_s
        deadline = asyncio.get_event_loop().time() + timeout
        # A batched registration still in flight means get_actor would
        # read "unknown actor" spuriously — wait the 5 ms window out
        # (bounded by the ready deadline like every other wait here).
        while actor_id in self._actor_reg_pending and \
                asyncio.get_event_loop().time() < deadline:
            await asyncio.sleep(0.002)
        # A handle can also cross PROCESSES inside the creator's
        # batching window (serve controller -> driver): grant unknown
        # actors a short grace before declaring them dead, so the
        # remote registration flush can land.
        unknown_grace = asyncio.get_event_loop().time() + \
            min(5.0, timeout)
        delay = 0.02
        while True:
            info = self._actor_cache.get(actor_id)
            if info is not None and info["state"] == "DEAD" and \
                    info.get("death_reason"):
                # Locally-authoritative terminal entry (e.g. the
                # batched registration failed, so the controller has
                # no record to poll): fail fast with the real reason.
                raise ActorDiedError(actor_id.hex(),
                                     info["death_reason"])
            if info is None or info["state"] not in ("ALIVE",) or \
                    not info.get("worker_addr"):
                info = await self._ctl.call("get_actor",
                                            {"actor_id": actor_id})
                if info is not None:
                    self._actor_cache[actor_id] = info
            if info is None:
                if wait_alive and \
                        asyncio.get_event_loop().time() < unknown_grace:
                    await asyncio.sleep(delay)
                    delay = min(delay * 1.5, 0.5)
                    continue
                raise ActorDiedError(actor_id.hex(), "unknown actor")
            if info["state"] == "ALIVE" and info.get("worker_addr"):
                return info
            if info["state"] == "DEAD":
                raise ActorDiedError(
                    actor_id.hex(), info.get("death_reason") or "actor dead")
            if not wait_alive or \
                    asyncio.get_event_loop().time() > deadline:
                raise ActorDiedError(actor_id.hex(),
                                     f"actor stuck in {info['state']}")
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 0.5)

    async def _submit_actor(self, spec: TaskSpec,
                            held: Optional[List[ObjectID]] = None) -> None:
        """Actor calls execute in submission order for max_concurrency=1
        actors: the per-actor lock is taken in coroutine creation order
        (FIFO) and held across dep resolution + push, so the worker's
        single-threaded executor receives them in program order — and a
        restarted actor needs no seq handshake (ref: the role of
        ActorSubmitQueue in transport/actor_task_submitter.h, redesigned
        around in-order connection delivery)."""
        try:
            ordered = spec.max_concurrency <= 1 and not spec.unordered
            if ordered and spec.max_retries == 0:
                # Pipelined fast path: the submit lock covers only
                # dep-resolution + the frame WRITE, so wire order (and
                # therefore worker execution order) still equals
                # program order while replies overlap.  Retriable actor
                # methods take the serial path below — a retry after a
                # pipelined failure could execute behind younger calls,
                # which the lock-across-reply path can't.
                await self._submit_actor_pipelined(spec)
            elif ordered:
                lock = self._actor_submit_locks.setdefault(
                    spec.actor_id, asyncio.Lock())
                async with lock:
                    await self._submit_actor_inner(spec)
            else:
                await self._submit_actor_inner(spec)
        finally:
            if held:
                self._release_submitted_holds(held)

    async def _submit_actor_pipelined(self, spec: TaskSpec) -> None:
        lock = self._actor_submit_locks.setdefault(
            spec.actor_id, asyncio.Lock())
        fut = None
        worker = None
        async with lock:
            try:
                await self._resolve_deps(spec)
            except TaskError as e:
                self._fail_returns(spec, e)
                return
            try:
                info = await self._actor_info(spec.actor_id)
            except ActorDiedError as e:
                self._fail_returns(spec, ActorError.from_exception(e))
                return
            try:
                if spec.is_streaming:
                    stream = self._streams.get(spec.task_id.hex())
                    if stream is not None:
                        stream.worker_addr = info["worker_addr"]
                    ssub = self._submissions.get(
                        spec.return_object_ids()[0])
                    if ssub is not None:
                        ssub.worker_addr = info["worker_addr"]
                        ssub.pushed = True
                worker = await self._worker_client(info["worker_addr"])
                rid = next(self._reply_counter)
                fut = asyncio.get_event_loop().create_future()
                self._reply_waiters[rid] = (
                    "actor", fut, info["worker_addr"])
                try:
                    worker.notify_nowait("exec_actor", {
                        "spec": spec, "reply_id": rid,
                        "caller_id": self._runtime_id,
                        "caller_tag": self.caller_tag})
                except RpcError:
                    self._reply_waiters.pop(rid, None)
                    fut = None
            except RpcError:
                fut = None  # dial failed: serial path refreshes state
            if fut is None:
                self._actor_cache.pop(spec.actor_id, None)
                await self._submit_actor_inner(spec)
                return
        await worker.drain()
        try:
            reply = await fut
        except RpcError:
            # Connection died with the call in flight.  No retry budget
            # on this path (max_retries == 0): resolve to death/loss the
            # way the serial path's no-budget branch does.
            self._actor_cache.pop(spec.actor_id, None)
            try:
                await self._actor_info(spec.actor_id, timeout=5.0)
                reason = "actor task connection lost mid-call"
            except ActorDiedError as de:
                reason = str(de.reason)
            self._fail_returns(spec, ActorError.from_exception(
                ActorDiedError(spec.actor_id.hex(), reason)))
            return
        except RemoteCallError as e:
            self._fail_returns(spec, ActorError.from_exception(e.cause))
            return
        if not reply.ok:
            err = reply.error
            self._fail_returns(spec, err if isinstance(err, TaskError)
                               else ActorError.from_exception(err))
            return
        self._accept_returns(spec, reply)

    async def _submit_actor_inner(self, spec: TaskSpec) -> None:
        try:
            await self._resolve_deps(spec)
        except TaskError as e:
            self._fail_returns(spec, e)
            return
        attempts_left = spec.max_retries
        while True:
            try:
                info = await self._actor_info(spec.actor_id)
            except ActorDiedError as e:
                self._fail_returns(spec, ActorError.from_exception(e))
                return
            try:
                if spec.is_streaming:
                    stream = self._streams.get(spec.task_id.hex())
                    if stream is not None:
                        stream.worker_addr = info["worker_addr"]
                    ssub = self._submissions.get(
                        spec.return_object_ids()[0])
                    if ssub is not None:
                        ssub.worker_addr = info["worker_addr"]
                        ssub.pushed = True
                worker = await self._worker_client(info["worker_addr"])
                reply = await worker.call("push_actor_task", {
                    "spec": spec, "caller_id": self._runtime_id,
                    "caller_tag": self.caller_tag})
            except (RpcError, RemoteCallError) as e:
                # Worker gone: refresh state; retry while restarting if the
                # method has a retry budget, else surface death.
                self._actor_cache.pop(spec.actor_id, None)
                if isinstance(e, RemoteCallError):
                    self._fail_returns(spec,
                                       ActorError.from_exception(e.cause))
                    return
                if attempts_left != 0:
                    if attempts_left > 0:
                        attempts_left -= 1
                    await asyncio.sleep(0.1)
                    continue
                try:
                    await self._actor_info(spec.actor_id, timeout=5.0)
                    reason = "actor task connection lost mid-call"
                except ActorDiedError as de:
                    reason = str(de.reason)
                self._fail_returns(spec, ActorError.from_exception(
                    ActorDiedError(spec.actor_id.hex(), reason)))
                return
            if not reply.ok:
                err = reply.error
                self._fail_returns(spec, err if isinstance(err, TaskError)
                                   else ActorError.from_exception(err))
                return
            self._accept_returns(spec, reply)
            return

    def kill_actor(self, actor_id: ActorID, no_restart: bool) -> None:
        self._actor_cache.pop(actor_id, None)

        async def _kill():
            # A kill racing this owner's own batched registration
            # would reach the controller BEFORE the actor exists and
            # be silently ignored — the actor would then start and
            # run forever.  Wait the coalescing window out (bounded),
            # like _actor_info does for method calls.
            deadline = asyncio.get_event_loop().time() + 10.0
            while actor_id in self._actor_reg_pending and \
                    asyncio.get_event_loop().time() < deadline:
                await asyncio.sleep(0.002)
            return await self._ctl.call("kill_actor", {
                "actor_id": actor_id, "no_restart": no_restart})

        self.io.run(_kill())

    def get_named_actor(self, name: str, namespace: str = ""):
        info = self.io.run(self._ctl.call("lookup_named_actor", {
            "name": name, "namespace": namespace}))
        if info is None or info["state"] == "DEAD":
            raise ValueError(f"No actor named {name!r} in namespace "
                             f"{namespace!r}")
        from .api import ActorHandle

        groups = info.get("concurrency_groups") or {}
        return ActorHandle(info["actor_id"], info["class_name"],
                           info["method_names"], namespace,
                           info.get("max_concurrency", 1),
                           has_groups=bool(groups),
                           method_options=info.get("method_options"),
                           group_names=sorted(groups))

    # ------------------------------------------------------------- objects
    def put(self, value: Any) -> ObjectRef:
        from . import serialization
        from .object_ref import collect_embedded_refs

        oid = ObjectID.for_put(self.current_task_id(), self.next_put_index())
        with collect_embedded_refs() as embedded:
            payload, views = serialization.serialize(value)
        if embedded:
            # Refs nested in a put payload escape to whoever gets the
            # container: their in-band values must be pullable.
            self.promote_refs_to_plane(list(embedded))
        size = self.store.seal_parts(oid, payload, views)
        with self._refs_lock:
            self._owned_ids.add(oid)
            self._owned_plane.add(oid)  # puts have no lineage (ref parity)
            if not embedded:
                # Eligible for the agent-local fast release: a plain
                # put with no embedded refs has no induced borrows to
                # cascade on the controller.
                self._local_puts.add(oid)
        # Fire-and-forget registration, written from THIS thread over
        # the notify side channel — the sealed bytes are already
        # readable locally (get() maps them directly) and remote pulls
        # poll the directory with re-checks, so registration latency
        # is absorbed; skipping the io-loop wakeup + round trip
        # removes most of the driver-side cost of a large put.
        if not self._side_channel.notify(
                "register_object", {"object_id": oid, "size": size}):
            # Side channel down: fall back to an ACKED call on the main
            # agent connection — a notify here could be swallowed by a
            # half-open socket's deferred flush, silently leaving the
            # object unregistered (remote pulls would hang forever).
            def _send_register():
                def _check(f):
                    if f.cancelled() or f.exception() is not None:
                        asyncio.ensure_future(
                            self._register_object_retry(oid, size))

                try:
                    self._agent.call_nowait(
                        "register_object",
                        {"object_id": oid, "size": size}
                    ).add_done_callback(_check)
                except Exception:
                    # Not connected (reconnect window): full dial.
                    asyncio.ensure_future(
                        self._register_object_retry(oid, size))

            self._bg_submit(_send_register)
        self.memory.put(oid, _StoreRef(size))
        return ObjectRef(oid)

    async def _register_object_retry(self, oid: ObjectID,
                                     size: int) -> None:
        try:
            await self._agent.call("register_object",
                                   {"object_id": oid, "size": size})
        except (RpcError, RemoteCallError):
            pass  # agent gone: the node (and this copy) is dying anyway

    # Worker-role callback (set by worker_main): fired when the
    # executing task blocks/unblocks in get().
    on_block = None

    def _notify_blocked(self, blocked: bool) -> None:
        """Worker-role hook: release/reacquire lease CPU while blocked in
        get (driver has no lease; no-op)."""
        if self.on_block is not None:
            try:
                self.on_block(blocked)
            except Exception:
                pass
        lease_id = self.current_lease_id
        if lease_id is None:
            return
        method = "task_blocked" if blocked else "task_unblocked"
        try:
            self.io.run(self._agent.call(method, {"lease_id": lease_id}),
                        timeout=5.0)
        except Exception:
            pass

    def _fetch_store_value(self, oid: ObjectID,
                           timeout: Optional[float],
                           size_hint: int = 0) -> Any:
        """Pull a plane object into the local node store and map it,
        reconstructing from lineage if every copy was lost.

        ``size_hint`` > 0 means the caller already knows the object's
        packed size (a _StoreRef descriptor — our own put or a local
        task result): try mapping the local store directly before
        paying the agent pull round trip.  Both backends make the
        direct read safe: the pool copies out under a cross-process
        read pin, segment mappings stay valid past unlink.  A miss
        (spilled, evicted, or produced on another node) falls through
        to the normal pull, which restores/transfers the copy.

        The map can
        race a spill/eviction in the window after the pull reply — a
        missing segment means re-pull (which restores), not data loss.
        A failed pull of an object WITH lineage is also retried: under
        node-kill chaos the node holding a just-reconstructed copy can
        die in the window between reconstruction and this pull, which
        must mean "reconstruct again", not "not reconstructable"
        (an interleaving that lost refs)."""
        if size_hint > 0:
            try:
                return self.store.get(oid, size_hint)
            except (FileNotFoundError, OSError):
                pass  # not local anymore: pull restores/transfers it
        for attempt in range(3):
            r = self.io.run(self._pull_with_recovery(oid, timeout))
            if not r.get("ok"):
                with self._refs_lock:
                    recoverable = oid in self._lineage
                if recoverable and attempt < 2:
                    continue
                raise ObjectLostError(oid.hex())
            try:
                return self.store.get(oid, r["size"])
            except FileNotFoundError:
                continue
        raise ObjectLostError(oid.hex())

    async def _pull_with_recovery(self, oid: ObjectID,
                                  timeout: Optional[float]) -> Dict:
        t = timeout if timeout is not None else 3600.0
        can_recover = oid in self._lineage
        r = await self._agent.call("pull_object", {
            "object_id": oid, "timeout": t, "fail_fast": can_recover})
        if r.get("ok") or not can_recover:
            return r
        if not await self._reconstruct_object(oid):
            return r
        return await self._agent.call("pull_object",
                                      {"object_id": oid, "timeout": t})

    async def _recover_lost_args(self, spec: TaskSpec) -> bool:
        """A pushed task failed with ObjectLostError: check its plane-ref
        args against the directory and reconstruct the missing ones we
        have lineage for.  Returns True if anything was recovered (the
        caller retries the push)."""
        recovered = False
        for arg in spec.args:
            if arg.kind != ArgKind.OBJECT_REF or arg.object_id is None:
                continue
            oid = arg.object_id
            if oid not in self._lineage:
                continue
            try:
                loc = await self._ctl.call("locate_object",
                                           {"object_id": oid})
            except RpcError:
                loc = None
            # The directory lags node death by the health-check window
            # (its "alive" filter is heartbeat-based), so a listed copy
            # may be on a node that is already gone — trusting it here
            # is exactly the interleaving that marked a
            # reconstructable object unreconstructable.  Confirm a
            # listed copy actually answers before believing it.
            confirmed = False
            for ent in (loc or {}).get("nodes") or []:
                try:
                    agent = await self._agent_for(ent["agent_addr"])
                    r = await asyncio.wait_for(
                        agent.call("objects_exist",
                                   {"object_ids": [oid]}), 3.0)
                    if r.get(oid):
                        confirmed = True
                        break
                except (RpcError, RemoteCallError,
                        asyncio.TimeoutError, OSError):
                    continue
            if confirmed:
                # A live copy exists: the executor's pull failure was
                # transient (e.g. raced a spill or the pull targeted a
                # dying node) — retrying the task is enough.
                recovered = True
                continue
            if not await self._reconstruct_object(oid):
                return False
            recovered = True
        return recovered

    async def _reconstruct_object(self, oid: ObjectID,
                                  depth: int = 0) -> bool:
        """Re-execute the task that created ``oid`` (ref:
        object_recovery_manager.h:38,90 — lineage reconstruction).  Upstream
        plane dependencies that are themselves gone are reconstructed
        first, depth-bounded.  Puts and actor-task results carry no
        lineage and surface ObjectLostError instead."""
        if depth > 8:
            return False
        spec = self._lineage.get(oid)
        if spec is None:
            return False
        inflight = self._reconstructing.get(oid)
        if inflight is not None:
            ok = await asyncio.shield(inflight)
            if ok:
                return True
            # The attempt we piggybacked on failed — its failure may
            # have been a transient interleaving (its target node died
            # mid-resubmit).  Fall through and attempt reconstruction
            # OURSELVES instead of propagating a possibly-stale False
            # (an interleaving that lost refs).
            if self._reconstructing.get(oid) is not None:
                # Someone else already started the retry; join it.
                return await asyncio.shield(
                    self._reconstructing[oid])
        fut = asyncio.get_event_loop().create_future()
        self._reconstructing[oid] = fut
        ok = False
        try:
            for arg in spec.args:
                if arg.kind != ArgKind.OBJECT_REF or arg.object_id is None:
                    continue
                try:
                    loc = await self._ctl.call(
                        "locate_object", {"object_id": arg.object_id})
                except RpcError:
                    loc = None
                if not (loc and loc["nodes"]):
                    if not await self._reconstruct_object(arg.object_id,
                                                          depth + 1):
                        return False
            logger = __import__("logging").getLogger("ray_tpu_torch")
            logger.warning("reconstructing lost object %s by re-executing "
                           "task %s", oid.hex()[:16], spec.display_name())
            self._mark_pending(spec.return_object_ids())
            await self._submit_normal(spec)
            got, val = self.memory.get_nowait(oid)
            ok = got and not isinstance(val, TaskError)
            return ok
        finally:
            self._reconstructing.pop(oid, None)
            if not fut.done():
                fut.set_result(ok)

    def get(self, refs: List[ObjectRef],
            timeout: Optional[float]) -> List[Any]:
        deadline = time.monotonic() + timeout if timeout is not None else None
        # Release this worker's lease CPU while blocked on ANY ref that
        # is not already local — including refs owned by OTHER processes
        # (ref: core_worker NotifyDirectCallTaskBlocked).  Scoping this
        # to our own pending returns deadlocks a fixed-size worker pool:
        # a task get()ing another owner's not-yet-produced object holds
        # its lease while the producing task queues behind it forever.
        needs_wait = []
        for r in refs:
            ok, _ = self.memory.get_nowait(r.id)
            if not ok:
                needs_wait.append(r.id)
        blocked = bool(needs_wait)
        if blocked:
            self._notify_blocked(True)
        try:
            if len(needs_wait) > 1:
                # One shared wait for the whole batch (see
                # MemoryStore.wait_for_many) — but only for refs whose
                # results arrive THROUGH the memory store (our own
                # pending returns); plane refs resolve via pulls below.
                with self._pending_lock:
                    batched = [o for o in needs_wait
                               if o in self._pending_returns]
                if len(batched) > 1:
                    remaining = (max(deadline - time.monotonic(), 0.0)
                                 if deadline is not None else None)
                    self.memory.wait_for_many(batched, remaining)
            out = []
            for r in refs:
                remaining = None
                if deadline is not None:
                    remaining = max(deadline - time.monotonic(), 0.0)
                with self._pending_lock:
                    pending = r.id in self._pending_returns
                if pending or self.memory.contains(r.id):
                    val = self.memory.wait_for(r.id, remaining)
                else:
                    val = self._fetch_store_value(r.id, remaining)
                if isinstance(val, _StoreRef):
                    val = self._fetch_store_value(r.id, remaining,
                                                  size_hint=val.size)
                if isinstance(val, TaskError):
                    raise val
                out.append(val)
            return out
        finally:
            if blocked:
                self._notify_blocked(False)
    # NOTE on _fetch_store_value for values we produced locally: the pull
    # is satisfied by the local directory lookup, no copy happens.

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float],
             fetch_local: bool) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = time.monotonic() + timeout if timeout is not None else None
        ready: List[ObjectRef] = []
        not_ready = list(refs)
        delay = 0.005
        while len(ready) < num_returns:
            progressed = False
            # Local checks first (memory store / owned-pending) — free.
            foreign: List[ObjectRef] = []
            for r in list(not_ready):
                ok, _ = self.memory.get_nowait(r.id)
                if ok:
                    ready.append(r)
                    not_ready.remove(r)
                    progressed = True
                    if len(ready) >= num_returns:
                        break
                    continue
                with self._pending_lock:
                    if r.id not in self._pending_returns:
                        foreign.append(r)
            # Foreign refs: ONE bulk directory probe per pass instead of
            # two RPCs per ref per poll (otherwise O(refs x
            # polls) controller load from any wait loop).  The local
            # agent is the fallback source of truth for copies whose
            # controller publication failed or lagged.
            if foreign and len(ready) < num_returns:
                oids = [r.id for r in foreign]
                try:
                    res = self.io.run(self._ctl.call(
                        "locate_objects", {"object_ids": oids}),
                        timeout=5.0)
                except Exception:
                    res = {}
                missing = [o for o in oids if not res.get(o)]
                if missing:
                    try:
                        local = self.io.run(self._agent.call(
                            "objects_exist", {"object_ids": missing}),
                            timeout=5.0)
                        res = {**local, **{k: v for k, v in res.items()
                                           if v}}
                    except Exception:
                        pass
                for r in foreign:
                    if res.get(r.id):
                        ready.append(r)
                        if r in not_ready:
                            not_ready.remove(r)
                        progressed = True
                        if len(ready) >= num_returns:
                            break
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not progressed:
                time.sleep(delay)
                delay = min(delay * 1.5, 0.05)  # back off when idle
            else:
                delay = 0.005
        if fetch_local and ready:
            # Honour the caller's deadline during the fetch too: a timed
            # wait() must not block indefinitely pulling remote values
            # (bounded by one deadline).  Refs whose fetch misses the deadline
            # are demoted back to not_ready — matching the reference's
            # contract that fetch_local readiness means "value is local".
            pending = list(ready)
            while pending:
                remaining = (max(0.0, deadline - time.monotonic())
                             if deadline is not None else None)
                try:
                    self.get(pending, timeout=remaining)
                    break
                except TaskError:
                    # The errored ref's value is now local (memory
                    # store); keep fetching the rest.  Resolved refs
                    # drop out, so each pass shrinks pending.
                    resident = self._locally_resident(pending)
                    nxt = [r for r in pending if r not in resident]
                    if len(nxt) == len(pending):
                        break  # defensive: no progress, stop looping
                    pending = nxt
                except GetTimeoutError:
                    resident = self._locally_resident(pending)
                    still_remote = [r for r in pending
                                    if r not in resident]
                    for r in still_remote:
                        ready.remove(r)
                    not_ready = still_remote + not_ready
                    break
        return ready, not_ready

    def _locally_resident(self, refs: List[ObjectRef]) -> set:
        """Subset of ``refs`` whose values are resident on this node
        (memory store — incl. error values — or local shm).  ONE
        batched agent probe for the rest, so callers stay O(1) RPCs."""
        resident = set()
        unknown: List[ObjectRef] = []
        for r in refs:
            ok, _ = self.memory.get_nowait(r.id)
            (resident.add if ok else unknown.append)(r)
        if unknown:
            try:
                res = self.io.run(self._agent.call(
                    "objects_exist",
                    {"object_ids": [r.id for r in unknown]}),
                    timeout=2.0)
                for r in unknown:
                    if res.get(r.id):
                        resident.add(r)
            except Exception:
                pass  # unreachable agent: treat as non-resident
        return resident

    def cancel(self, ref: ObjectRef, force: bool) -> None:
        """Cancel the task producing ``ref`` (ref: core_worker.cc
        CancelTask).  Queued lease requests are yanked from the agent;
        running tasks get TaskCancelledError raised in their executing
        thread (force=True kills the worker process instead).  Actor
        tasks are not cancellable (they would break call ordering) —
        a warning is emitted, matching the surfaced-gap contract."""
        sub = self._submissions.get(ref.id)
        if sub is None or sub.done:
            # Debug, not warning: bulk cancellation sweeps routinely
            # race completion by design (100k-queue benchmarks would
            # emit 100k log lines at warning level).
            logger.debug(
                "cancel(%s): no in-flight submission (already finished, "
                "unknown, or an actor task — not cancellable)", ref)
            return
        sub.cancelled = True
        sub.force = force
        self.io.call_soon(sub.cancel_event.set)
        try:
            self.io.run(self._cancel_inflight(sub), timeout=10.0)
        except Exception:
            pass  # flag checks in the submit loop still stop the task

    async def _cancel_inflight(self, sub: _Submission) -> None:
        if not sub.pushed:
            if sub.agent_addr is not None:
                agent = await self._agent_for(sub.agent_addr)
                await agent.call("cancel_lease_request",
                                 {"request_id": sub.request_id})
            return
        if sub.force:
            # Kill the worker process; the push RPC fails and the submit
            # loop reports TaskCancelledError (cancel flag suppresses
            # retries).
            agent = await self._agent_for(sub.agent_addr)
            await agent.call("kill_worker", {"worker_id": sub.worker_id})
        elif sub.worker_addr is not None:
            worker = await self._worker_client(sub.worker_addr)
            await worker.call("cancel_task",
                              {"task_id": sub.spec.task_id})

    # -------------------------------------------------------- introspection
    def cluster_resources(self) -> Dict[str, float]:
        nodes = self.io.run(self._ctl.call("list_nodes", {}))
        total: Dict[str, float] = {}
        for n in nodes:
            if n["alive"]:
                for k, v in n["resources"].items():
                    total[k] = total.get(k, 0.0) + v
        return total

    def available_resources(self) -> Dict[str, float]:
        nodes = self.io.run(self._ctl.call("list_nodes", {}))
        total: Dict[str, float] = {}
        for n in nodes:
            if n["alive"] and not n.get("draining"):
                # A draining node's capacity is leaving the cluster:
                # elastic gang sizing (ElasticScalingPolicy) must not
                # count chips that will be gone by the next attempt.
                for k, v in n["available"].items():
                    total[k] = total.get(k, 0.0) + v
        return total

    def nodes(self) -> List[Dict[str, Any]]:
        out = []
        for n in self.io.run(self._ctl.call("list_nodes", {})):
            out.append({
                "NodeID": n["node_id"].hex(), "Alive": n["alive"],
                "Resources": n["resources"], "AgentAddress": n["agent_addr"],
                "Labels": n["labels"], "IsHead": n.get("is_head", False),
                "Draining": n.get("draining", False),
                "DrainDeadline": n.get("drain_deadline", 0.0),
                "DrainReason": n.get("drain_reason", "")})
        return out

    def controller_call(self, method: str, payload=None, timeout=None):
        """Escape hatch used by util/state/collective layers."""
        return self.io.run(self._ctl.call(method, payload), timeout)

    def agent_call(self, method: str, payload=None, timeout=None):
        return self.io.run(self._agent.call(method, payload), timeout)

    # ------------------------------------------------------------ shutdown
    def shutdown(self) -> None:
        self._shutdown_flag = True
        try:
            # Give cached leases back so a departing driver doesn't pin
            # CPUs on a shared cluster until the keep-alive would expire.
            self.io.run(self._release_pooled_leases(), timeout=5.0)
        except Exception:
            pass
        if self._registered_job_int is not None and not self._owns_head:
            # A departing driver finishes its job so the controller
            # reaps its non-detached actors — a connect/disconnect
            # driver must not leak workers into the shared cluster.
            try:
                self.io.run(self._ctl.call(
                    "finish_job", {"job_id": self._registered_job_int}),
                    timeout=10.0)
            except Exception:
                pass
        try:
            if self._owns_head:
                try:
                    self.io.run(self._ctl.call("cluster_shutdown", {}),
                                timeout=5.0)
                except Exception:
                    pass
        finally:
            try:
                self._side_channel.close()
            except Exception:
                pass
            self.store.close()
            self.memory.clear()
            self.io.stop()
            for p in self._procs:
                try:
                    p.wait(timeout=3.0)
                except Exception:
                    try:
                        p.kill()
                    except Exception:
                        pass
            if self._owns_head:
                self._cleanup_shm()

    async def _release_pooled_leases(self) -> None:
        for st in list(self._sched_states.values()):
            for rid, agent_addr in list(st.request_agents.items()):
                self._cancel_lease_request_async(rid, agent_addr)
            for pl in list(st.leases.values()):
                try:
                    agent = await self._agent_for(pl.agent_addr)
                    await asyncio.wait_for(
                        agent.call("return_lease",
                                   {"lease_id": pl.lease_id}), 2.0)
                except Exception:
                    pass
            st.leases.clear()
            st.idle.clear()
        self._sched_states.clear()

    def _cleanup_shm(self) -> None:
        shm_dir = "/dev/shm"
        prefix = f"rtt_{self.session}_"
        try:
            for name in os.listdir(shm_dir):
                if name.startswith(prefix):
                    try:
                        os.unlink(os.path.join(shm_dir, name))
                    except OSError:
                        pass
        except OSError:
            pass
