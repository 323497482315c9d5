"""Worker process entry point — executes tasks and hosts actors.

Role-equivalent to the reference's default_worker.py + the execution half
of CoreWorker (ref: python/ray/_private/workers/default_worker.py, task
execution handler _raylet.pyx:2244, TaskReceiver + ActorSchedulingQueue in
src/ray/core_worker/transport/task_receiver.h).  The worker registers with
its node agent, serves direct task pushes from owners, and on actor
creation becomes that actor's dedicated process with per-caller ordered
method queues, a thread pool honoring ``max_concurrency``, and native
asyncio execution for coroutine methods.

GPU isolation: the GPU ids granted with the worker's first lease are
exported as ``CUDA_VISIBLE_DEVICES`` *before* user code runs, as the
reference does (ref: python/ray/_private/accelerators/nvidia_gpu.py); a
CPU lease exports an empty value.  CUDA reads the variable when it
initialises, so the agent binds the worker to that id set and hands it
only leases with the same ids afterwards.  The worker imports no torch
of its own: user code does.
"""

from __future__ import annotations

import os as _os_early
import time as _time_early

# Startup-phase anchors (rt_worker_startup_seconds): the agent stamps
# RT_SPAWN_TS at fork; everything between it and this line is the
# "spawn" phase (fork + interpreter boot + site), everything from here
# to the end of this module's import is the "import" phase.  These two
# lines must stay ABOVE the heavy imports to measure them.
_SPAWN_TS = float(_os_early.environ.get("RT_SPAWN_TS") or 0.0)
_IMPORT_T0 = _time_early.time()

import asyncio  # noqa: E402
import faulthandler  # noqa: E402
import inspect  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import signal as _signal  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

# NOTE: cloudpickle (via serialization/rpc lazy accessors), torch,
# telemetry, and the collective stack are imported lazily at first
# use — a prestarted pool worker must be cheap to fork, and most
# workers never touch most of that stack until their first frame.
from . import runtime as runtime_mod  # noqa: E402
from . import serialization  # noqa: E402
from .cluster_runtime import ClusterRuntime  # noqa: E402
from .config import RuntimeConfig  # noqa: E402
from .errors import ActorError, TaskCancelledError, TaskError  # noqa: E402
from .ids import ActorID, JobID, WorkerID  # noqa: E402
from .rpc import RpcClient, RpcError, RpcServer, spawn_task  # noqa: E402
from .task import ArgKind, TaskResult, TaskSpec  # noqa: E402
from ..util import hotpath  # noqa: E402  (stdlib-only; stamp slots)

_IMPORT_DONE = _time_early.time()

logger = logging.getLogger("ray_tpu_torch.worker")


class Worker:
    def __init__(self):
        self.session = os.environ["RT_SESSION_NAME"]
        self.controller_addr = os.environ["RT_CONTROLLER_ADDR"]
        self.agent_addr = os.environ["RT_AGENT_ADDR"]
        self.node_id_hex = os.environ["RT_NODE_ID"]
        self.config = RuntimeConfig.from_env()
        self.worker_id = WorkerID.from_random()
        self.server = RpcServer()
        self.runtime: Optional[ClusterRuntime] = None
        self._func_cache: Dict[str, Any] = {}
        self._task_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec")
        # Actor state.
        self.actor_id: Optional[ActorID] = None
        self.actor_instance: Any = None
        self.actor_executor: Optional[ThreadPoolExecutor] = None
        self.actor_lock = threading.Lock()
        self._exit_event = asyncio.Event()
        # Cancellation state: ids cancelled before execution started
        # (bounded FIFO — a cancel that never matches a push must not
        # accumulate forever), and the (task_id, thread ident) currently
        # running in _task_executor.
        from collections import OrderedDict

        self._cancelled_task_ids: "OrderedDict[Any, None]" = OrderedDict()
        self._current_sync_task: Optional[Tuple[Any, int]] = None
        # Task-event buffer: state transitions recorded here (any
        # thread), flushed in batches to the agent -> controller (ref:
        # task_event_buffer.h:222 periodic flush to GcsTaskManager).
        self._event_buf: List[Dict] = []
        self._event_lock = threading.Lock()
        # Streaming-generator state: per-task caller tag (notify
        # target) and ack counters for executor backpressure.
        self._stream_callers: Dict[str, str] = {}
        self._stream_acks: Dict[str, Dict[str, Any]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # Pipelined normal-task queue (see push_task).
        from collections import deque as _deque

        self._task_queue: "_deque" = _deque()
        self._task_runner: Optional[asyncio.Task] = None
        self._task_running = False
        self._exec_blocked = False
        self._gpus_bound = False
        # Batched-exec result buffer: caller_tag -> [(reply_id, res)].
        self._result_buf: Dict[str, list] = {}
        self._flush_scheduled = False
        # Undeliverable peer notifies (owner connection mid-
        # reregistration): per-tag ordered backlog, redelivered when
        # the tag re-registers (the PROGRESS reply-loss flake: a
        # final push_actor_task reply dropped when notify_peer raced a
        # reconnect).  Loop-thread only; no lock needed.
        self._undelivered: Dict[str, "_deque"] = {}
        self._redelivery_task: Optional[asyncio.Task] = None
        # Streams declared lost by a backlog overflow: their item
        # frames are dropped and their final reply is poisoned.
        # Insertion-ordered (dict) so the size bound evicts the
        # OLDEST marks — an arbitrary eviction could drop a mark
        # whose poisoned reply is still pending, un-poisoning it.
        self._shed_streams: Dict[str, None] = {}
        for name in ["push_task", "exec_batch", "create_actor",
                     "push_actor_task", "exec_actor",
                     "cancel_task", "ping", "exit", "dump_stack",
                     "profile", "torch_profile", "stream_ack"]:
            self.server.register(name, getattr(self, name))

    async def start(self) -> None:
        self._loop = asyncio.get_event_loop()
        await self.server.start()
        self.runtime = ClusterRuntime(
            self.config,
            _connect={"session": self.session,
                      "controller": self.controller_addr,
                      "agent": self.agent_addr},
            _job_id=JobID.from_int(0))
        self.runtime.on_block = self._on_exec_block
        runtime_mod.set_runtime(self.runtime)
        await self._setup_runtime_env()
        agent = RpcClient(self.agent_addr,
                          tag=f"worker-{self.worker_id.hex()[:8]}",
                          connect_timeout=10.0)
        await agent.connect()
        phases = {"import": max(_IMPORT_DONE - _IMPORT_T0, 0.0),
                  "connect": max(time.time() - _IMPORT_DONE, 0.0)}
        if _SPAWN_TS:
            phases["spawn"] = max(_IMPORT_T0 - _SPAWN_TS, 0.0)
        await agent.call("register_worker", {
            "worker_id": self.worker_id, "addr": self.server.address,
            "pid": os.getpid(), "phases": phases})
        self._agent = agent
        # Event-loop health: scheduled-vs-actual lag ring, exported
        # with the metrics tick (rt_loop_lag_seconds -> rt doctor).
        self._loop_lag = hotpath.LoopLagSampler(self._loop)
        self._loop_lag.start()
        spawn_task(self._watch_agent())
        spawn_task(self._flush_loop())

    def _emit_event(self, spec: TaskSpec, state: str, **extra) -> None:
        ev = {"task_id": spec.task_id.hex(), "state": state,
              "ts": time.time(), "name": spec.display_name(),
              "kind": spec.kind.name, "node_id": self.node_id_hex,
              "worker_pid": os.getpid(),
              "attempt": getattr(spec, "sched_attempt", 0)}
        if spec.actor_id is not None:
            ev["actor_id"] = spec.actor_id.hex()
        ev.update(extra)
        with self._event_lock:
            self._event_buf.append(ev)
        # Mirror into the crash flight recorder so a preempted
        # worker's dump shows what it was executing: routine
        # transitions overwrite ONE sticky slot (flooding the ring at
        # batch-task rates would evict the train/collective context
        # the dump exists for); failures append as real ring events.
        from ray_tpu_torch.util import flight_recorder

        if state == "FAILED":
            flight_recorder.record("task_failed", name=ev["name"],
                                   task_id=ev["task_id"],
                                   error=extra.get("error"))
        else:
            flight_recorder.note("last_task", name=ev["name"],
                                 state=state, task_id=ev["task_id"])

    async def _flush_loop(self) -> None:
        """Ship task events + span drains + metric snapshots on one
        cadence (the span ring rides the same agent -> controller relay
        as task events; see util/spans.py)."""
        period = max(self.config.metrics_report_period_s, 0.25)
        source = f"worker-{self.node_id_hex[:8]}-{os.getpid()}"
        last_metrics = 0.0
        while True:
            await asyncio.sleep(min(period, 1.0))
            with self._event_lock:
                batch, self._event_buf = self._event_buf, []
            try:
                if batch:
                    await self._agent.call("report_task_events",
                                           {"events": batch})
                from ray_tpu_torch.util import spans as spans_mod

                span_batch = spans_mod.drain()
                if span_batch:
                    await self._agent.call("report_spans", {
                        "source": source,
                        "node_id": self.node_id_hex,
                        "spans": span_batch})
                # Gang watchdog: ship the set of collectives this
                # process is CURRENTLY inside (replace semantics per
                # source — an exited op vanishes on the next tick; a
                # hung one keeps refreshing, which is exactly the
                # signal the controller-side watchdog needs).  Only
                # chatty while collectives are in flight.
                # Only once user code joined a group: the package
                # imports torch, which this process must not pay for.
                entries = []
                if "ray_tpu_torch.collective" in sys.modules:
                    from ray_tpu_torch.collective import telemetry as _coll

                    entries = _coll.inflight_entries()
                if entries or getattr(self, "_had_coll_entries",
                                      False):
                    self._had_coll_entries = bool(entries)
                    await self._agent.call(
                        "report_collective_entries", {
                            "source": source, "entries": entries})
                now = time.time()
                if now - last_metrics >= period:
                    last_metrics = now
                    import sys as _sys

                    # Device-memory watermarks ride the metrics tick,
                    # but only once user code has already initialised
                    # CUDA — a worker without it must not drag torch in.
                    # (torch may be half imported by user code on
                    # another thread: read its cuda module defensively.)
                    cuda = getattr(_sys.modules.get("torch"), "cuda", None)
                    if getattr(cuda, "is_initialized", lambda: False)():
                        try:
                            from ray_tpu_torch.util import xprof as _xprof

                            _xprof.publish_device_memory()
                        except Exception:
                            pass
                    from ray_tpu_torch.util.metrics import registry

                    snap = registry().snapshot()
                    # Control-plane introspection rides the same tick:
                    # loop-lag quantiles + per-method RPC handler
                    # stats, synthesized in snapshot shape.
                    lag = getattr(self, "_loop_lag", None)
                    if lag is not None:
                        snap = snap + lag.metric_snaps()
                    snap = snap + self.server.stats.metric_snaps()
                    if snap:
                        await self._agent.call("report_metrics", {
                            "source": source,
                            "snapshot": snap})
            except RpcError:
                pass  # agent gone; _watch_agent will exit us

    async def _setup_runtime_env(self) -> None:
        """Materialize working_dir / py_modules before any user code can
        run (env_vars were set by the agent at spawn).  Packages come
        from the controller KV; extraction is content-addressed and
        shared across workers on this node (ref:
        python/ray/_private/runtime_env/working_dir.py)."""
        raw = os.environ.get("RT_RUNTIME_ENV")
        if not raw:
            return
        import json

        from .. import runtime_env as renv

        spec = json.loads(raw)
        if not (spec.get("working_dir_pkg")
                or spec.get("py_modules_pkgs")):
            return
        ctl = RpcClient(self.controller_addr, connect_timeout=10.0)
        try:
            root = os.path.join(self.config.session_dir_root, self.session,
                                "runtime_envs")
            os.makedirs(root, exist_ok=True)
            # Fetch only packages not already extracted on this node —
            # the content-addressed dir is the cross-worker cache.
            blobs = {}
            for digest in ([spec.get("working_dir_pkg")] if
                           spec.get("working_dir_pkg") else []) + \
                    [e["pkg"] for e in spec.get("py_modules_pkgs", [])]:
                if os.path.isdir(os.path.join(root, digest)):
                    continue
                key = f"runtime_env/pkg/{digest}"
                blobs[key] = await ctl.call("kv_get", {"key": key})

            def kv_get(key):
                return blobs.get(key)

            cwd, paths = renv.materialize(spec, kv_get, root)
            for p in reversed(paths):
                if p not in sys.path:
                    sys.path.insert(0, p)
            if cwd:
                os.chdir(cwd)
        finally:
            await ctl.close()

    async def _watch_agent(self) -> None:
        """Exit when the node agent goes away — a worker without its node
        has no store, no lease ledger, and no reason to live."""
        while True:
            await asyncio.sleep(1.0)
            if not self._agent.connected:
                logging.warning("agent connection lost; worker exiting")
                os._exit(0)

    # ------------------------------------------------------------ execution
    def _load_func(self, spec: TaskSpec):
        fn = self._func_cache.get(spec.func_id)
        if fn is None:
            from ray_tpu_torch._vendor import cloudpickle  # lazy: keep prestarted forks cheap

            fn = cloudpickle.loads(spec.func_blob)
            self._func_cache[spec.func_id] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        from .object_ref import ObjectRef

        vals = []
        timeout = self.config.arg_pull_timeout_s
        for a in spec.args:
            if a.kind == ArgKind.OBJECT_REF:
                # counted=False: the owner's submitted-task hold already
                # pins the arg for this task's duration — a borrow here
                # would just be 2 extra controller RPCs per arg.  Bounded
                # timeout: a lost arg must surface ObjectLostError so the
                # owner can reconstruct and retry, not hang for hours.
                ref = ObjectRef(a.object_id, counted=False)
                vals.append(self.runtime.get([ref], timeout)[0])
            elif a.kind == ArgKind.PACKED:
                vals.append(serialization.loads_message(a.value))
            else:
                vals.append(a.value)
        nkw = len(spec.kwargs_keys)
        if nkw:
            pos, kw_vals = vals[:-nkw], vals[-nkw:]
            return pos, dict(zip(spec.kwargs_keys, kw_vals))
        return vals, {}

    def _package_one(self, spec: TaskSpec, oid, value: Any,
                     transit: list) -> Tuple[str, Any]:
        """Package one return value: ("inline", bytes) or
        ("store", (size, node_hint)); store-path objects are sealed +
        registered, embedded refs get transit/induced borrows."""
        from .object_ref import collect_embedded_refs

        with collect_embedded_refs() as embedded:
            payload, views = serialization.serialize(value)
        if embedded:
            # Any of our own in-band values whose refs ride in this
            # return must become pullable by the receiver (in-band ->
            # plane promotion; see cluster_runtime.py).
            self.runtime.promote_refs_to_plane(list(embedded))
        size = serialization.packed_size(payload, views)
        if size <= self.config.object_inline_max_bytes:
            buf = bytearray(size)
            pos = 0
            buf[pos:pos + 4] = len(views).to_bytes(4, "little"); pos += 4
            buf[pos:pos + 8] = len(payload).to_bytes(8, "little"); pos += 8
            buf[pos:pos + len(payload)] = payload; pos += len(payload)
            for v in views:
                n = len(v)
                buf[pos:pos + 8] = n.to_bytes(8, "little"); pos += 8
                buf[pos:pos + n] = v; pos += n
            if embedded:
                # Ownership handoff: hold a transit borrow on each ref
                # embedded in the payload until the owner confirms
                # receipt (released in _accept_returns) — otherwise
                # this frame's refs die and free the objects before
                # the owner ever sees them.
                holder = f"transit:{spec.task_id.hex()}"
                for emb in embedded:
                    self.runtime.controller_call(
                        "add_borrower",
                        {"object_id": emb, "holder": holder})
                transit.extend(embedded)
            return ("inline", bytes(buf))
        self.runtime.store.seal_parts(oid, payload, views)
        self.runtime.agent_call(
            "register_object", {"object_id": oid, "size": size})
        if embedded:
            # Embedded refs live as long as the container payload:
            # the controller releases these borrows when the
            # container object itself is freed.
            self.runtime.controller_call(
                "link_induced_borrows",
                {"container": oid, "embedded": list(embedded)})
        return ("store", (size, self.node_id_hex))

    def _package_returns(self, spec: TaskSpec, result: Any) -> TaskResult:
        if spec.is_streaming:
            return self._stream_returns(spec, result)
        if spec.num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != spec.num_returns:
                raise ValueError(
                    f"Task {spec.display_name()} declared "
                    f"num_returns={spec.num_returns}, returned "
                    f"{len(values)}")
        entries = []
        transit: list = []
        oids = spec.return_object_ids()
        for oid, value in zip(oids, values):
            entries.append(self._package_one(spec, oid, value, transit))
        return TaskResult(task_id=spec.task_id, ok=True, returns=entries,
                          transit_refs=transit)

    # ------------------------------------------------- streaming returns
    def _stream_returns(self, spec: TaskSpec, result: Any) -> TaskResult:
        """Drive a generator task: each yielded value is packaged and
        pushed to the owner as a stream_item notify, with executor-side
        backpressure on unconsumed items (ref: _raylet.pyx:284
        ObjectRefGenerator + generator_waiter.h — the executor pauses
        when the owner lags).  Runs ON the executor thread; notify
        writes marshal to the worker's event loop."""
        import threading

        from .ids import ObjectID

        if not inspect.isgenerator(result) and \
                not hasattr(result, "__next__"):
            raise TypeError(
                f"num_returns='streaming' task "
                f"{spec.display_name()} returned "
                f"{type(result).__name__}, not a generator")
        tid = spec.task_id
        caller = self._stream_callers.get(tid.hex())
        state = self._stream_acks.setdefault(
            tid.hex(), {"consumed": 0, "event": threading.Event()})
        # 0 = unbounded (the reference default): a slow consumer must
        # never wedge the producer — and with it every task pipelined
        # behind this worker (a backpressure deadlock otherwise).
        max_pending = self.config.streaming_max_pending
        loop = self._loop
        idx = 0
        transit: list = []
        try:
            for item in result:
                idx += 1
                oid = ObjectID.for_task_return(tid, idx)
                entry = self._package_one(spec, oid, item, transit)
                payload = {"task_id": tid, "index": idx,
                           "object_id": oid, "entry": entry}
                if caller is not None:
                    loop.call_soon_threadsafe(
                        self._send_peer, caller, "stream_item",
                        payload)
                # Backpressure (bounded windows only): wait for the
                # owner to consume within max_pending of what we've
                # produced.  The wait is a BLOCKED state — it releases
                # the lease CPU and requeues tasks pipelined behind
                # this worker (without that, a stalled consumer
                # stalled every queued task forever).  A cancelled
                # task unblocks via the async-raise in cancel_task.
                if max_pending > 0 and \
                        idx - state["consumed"] > max_pending:
                    # Hysteresis: once blocked, stay blocked until the
                    # backlog drains to HALF the window.  Waking per
                    # consumed item would pay the blocked/unblocked
                    # agent round-trip (and pipeline requeue churn)
                    # for every streamed item once the consumer lags.
                    resume_gap = max(1, max_pending // 2)
                    self.runtime._notify_blocked(True)
                    try:
                        while idx - state["consumed"] > resume_gap:
                            state["event"].clear()
                            state["event"].wait(timeout=1.0)
                    finally:
                        self.runtime._notify_blocked(False)
            return TaskResult(task_id=tid, ok=True, returns=[],
                              transit_refs=transit, streamed=idx)
        except BaseException:
            # The failure TaskResult carries no transit list, so the
            # owner can't release the borrows of already-streamed
            # items — release them here or they pin objects forever.
            holder = f"transit:{tid.hex()}"
            for emb in transit:
                try:
                    self.runtime.controller_call(
                        "remove_borrower",
                        {"object_id": emb, "holder": holder})
                except Exception:
                    pass
            raise
        finally:
            self._stream_acks.pop(tid.hex(), None)
            self._stream_callers.pop(tid.hex(), None)

    def _bind_gpus(self, gpu_ids: List[int]) -> None:
        """Export the first lease's GPU ids (empty for a CPU lease).  The
        agent gives this worker only leases with the same ids later."""
        if not self._gpus_bound:
            os.environ[self.config.gpu_visible_devices_env] = ",".join(
                map(str, gpu_ids))
            self._gpus_bound = True

    def _execute_sync(self, spec: TaskSpec, fn, lease_id: Optional[int],
                      gpu_ids: List[int]) -> TaskResult:
        if lease_id is not None:
            self._bind_gpus(gpu_ids)
        prev_lease = self.runtime.current_lease_id
        if lease_id is not None:
            self.runtime.current_lease_id = lease_id
        prev_task = self.runtime._ctx.current_task_id
        self.runtime.set_current_task(spec.task_id)
        if spec.task_id in self._cancelled_task_ids:
            self._cancelled_task_ids.pop(spec.task_id, None)
            self.runtime.set_current_task(prev_task)
            self.runtime.current_lease_id = prev_lease
            return TaskResult(
                task_id=spec.task_id, ok=False,
                error=TaskError.from_exception(TaskCancelledError(
                    f"task {spec.display_name()} cancelled before start")))
        # Revoke any async exception still pending on this pooled thread
        # from a cancel that raced a previous task's completion — it must
        # not fire inside an unrelated task.
        import ctypes

        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(threading.get_ident()), None)
        self._current_sync_task = (spec.task_id, threading.get_ident())
        # Tracing: execute AS a child span of the submitter's context,
        # so nested .remote() calls inherit it and task events carry
        # the trace fields (ref: tracing_helper.py:88).
        span = None
        if spec.trace_ctx:
            from ..util import tracing as _tracing

            span = _tracing.child_context(spec.trace_ctx)
            _tracing.set_span_context(span)
        trace_extra = dict(span) if span else {}
        if spec.hp is not None:
            spec.hp[hotpath.EXEC_START] = time.perf_counter()
        self._emit_event(spec, "RUNNING", **trace_extra)
        try:
            pos, kwargs = self._resolve_args(spec)
            result = fn(*pos, **kwargs)
            out = self._package_returns(spec, result)
            self._emit_event(spec, "FINISHED", **trace_extra)
            return out
        except BaseException as e:  # noqa: BLE001 — shipped to owner
            kind = ActorError if spec.kind.name == "ACTOR_TASK" else TaskError
            self._emit_event(spec, "FAILED", error=repr(e),
                             **trace_extra)
            return TaskResult(task_id=spec.task_id, ok=False,
                              error=kind.from_exception(e))
        finally:
            if spec.hp is not None:
                spec.hp[hotpath.EXEC_END] = time.perf_counter()
            self._current_sync_task = None
            if spec.is_streaming:
                # A streaming task that failed before its generator
                # drive started (bad args, cancel-before-start, user
                # fn raised) must not leak its caller/ack entries.
                self._stream_callers.pop(spec.task_id.hex(), None)
                self._stream_acks.pop(spec.task_id.hex(), None)
            if span is not None:
                from ..util import tracing as _tracing

                _tracing.set_span_context(None)
            self.runtime.set_current_task(prev_task)
            self.runtime.current_lease_id = prev_lease

    # ---------------------------------------------------------- normal task
    async def push_task(self, p) -> TaskResult:
        spec: TaskSpec = p["spec"]
        env_err = os.environ.get("RT_RUNTIME_ENV_ERROR")
        if env_err:
            # This worker's runtime env failed to build (e.g. pip
            # install error); tasks fail FAST with the build error
            # instead of the agent respawning bootstraps forever (ref:
            # RuntimeEnvSetupError surfacing in runtime_env_agent).
            from .errors import RuntimeEnvSetupError

            return TaskResult(
                task_id=spec.task_id, ok=False,
                error=TaskError.from_exception(
                    RuntimeEnvSetupError(env_err)))
        if spec.is_streaming:
            self._stream_callers[spec.task_id.hex()] = \
                p.get("caller_tag", "")
        # Owners pipeline several pushes onto one leased worker (ref:
        # normal_task_submitter pipelining); an EXPLICIT queue (not
        # the executor's opaque one) lets the block hook return
        # unstarted tasks when the running task parks in get() — the
        # no-deadlock guarantee behind depth > 1.
        if self._exec_blocked and (self._task_running
                                   or self._task_queue):
            return TaskResult(task_id=spec.task_id, ok=False,
                              requeue=True)
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()
        self._task_queue.append((spec, p, fut))
        self._ensure_task_runner()
        return await fut

    def _ensure_task_runner(self) -> None:
        """(Re)start the drain task; a done-callback respawns it if a
        push raced the drain thread's final empty-check (that window
        spans a thread->loop handoff, so it is very real)."""
        if self._task_runner is None or self._task_runner.done():
            self._task_runner = spawn_task(self._task_runner_loop())
            self._task_runner.add_done_callback(
                lambda _t: (self._task_queue
                            and self._ensure_task_runner()))

    async def _task_runner_loop(self) -> None:
        """Drain the task queue in ONE executor submission: the thread
        body pops and executes tasks back-to-back (no per-task
        executor handoff), posting each result to the loop.  The
        block hook runs ON this same thread, so its requeue drain
        cannot race the popper."""
        loop = asyncio.get_event_loop()
        await loop.run_in_executor(self._task_executor,
                                   self._drain_queue_in_thread, loop)

    def _drain_queue_in_thread(self, loop) -> None:
        while True:
            try:
                spec, p, fut = self._task_queue.popleft()
            except IndexError:
                break
            if fut is not None and fut.done():
                continue
            self._task_running = True
            if spec.hp is not None:
                spec.hp[hotpath.WORKER_DISPATCH] = time.perf_counter()
            try:
                fn = self._load_func(spec)
                res = self._execute_sync(
                    spec, fn, p.get("lease_id"),
                    p.get("gpu_ids") or [])
            except BaseException as e:  # noqa: BLE001
                res = TaskResult(task_id=spec.task_id, ok=False,
                                 error=TaskError.from_exception(e))
            finally:
                self._task_running = False
            if spec.hp is not None:
                # Echo the stamp vector on the reply so the owner can
                # close the chain (REPLY_SENT lands at flush time).
                res.hp = spec.hp
            if fut is not None:
                loop.call_soon_threadsafe(
                    lambda f=fut, r=res:
                    f.set_result(r) if not f.done() else None)
            else:
                loop.call_soon_threadsafe(
                    self._queue_result, p, res)
        loop.call_soon_threadsafe(self._flush_results)

    # ---- batched exec channel (owner notifies exec_batch; results
    # ---- return as task_results notifies; ref: the push/report split
    # ---- in core_worker.proto, batched for frame/syscall amortization)
    async def exec_batch(self, p):
        if self._exec_blocked and (self._task_running
                                   or self._task_queue):
            for item in p["tasks"]:
                self._queue_result(
                    {"caller_tag": p["caller_tag"],
                     "reply_id": item["reply_id"]},
                    TaskResult(task_id=item["spec"].task_id, ok=False,
                               requeue=True))
            self._flush_results()
            return
        env_err = os.environ.get("RT_RUNTIME_ENV_ERROR")
        for item in p["tasks"]:
            spec = item["spec"]
            ctx = {"caller_tag": p["caller_tag"],
                   "reply_id": item["reply_id"],
                   "lease_id": p.get("lease_id"),
                   "gpu_ids": p.get("gpu_ids") or []}
            if env_err:
                from .errors import RuntimeEnvSetupError

                self._queue_result(ctx, TaskResult(
                    task_id=spec.task_id, ok=False,
                    error=TaskError.from_exception(
                        RuntimeEnvSetupError(env_err))),
                    flush_now=True)
                continue
            if spec.is_streaming:
                self._stream_callers[spec.task_id.hex()] = \
                    p["caller_tag"]
            if spec.hp is not None:
                spec.hp[hotpath.WORKER_RECV] = time.perf_counter()
            self._task_queue.append((spec, ctx, None))
        self._ensure_task_runner()

    def _queue_result(self, ctx, res: TaskResult,
                      flush_now: bool = False) -> None:
        self._result_buf.setdefault(ctx["caller_tag"], []).append(
            (ctx["reply_id"], res))
        if flush_now or sum(len(v) for v in
                            self._result_buf.values()) >= 8:
            self._flush_results()
        elif not self._flush_scheduled:
            # Flush after the current loop burst: results completing
            # together batch into one frame, nothing waits on a timer.
            self._flush_scheduled = True
            self._loop.call_soon(self._scheduled_flush)

    def _scheduled_flush(self) -> None:
        self._flush_scheduled = False
        self._flush_results()

    def _flush_results(self) -> None:
        buf, self._result_buf = self._result_buf, {}
        for tag, entries in buf.items():
            for _rid, res in entries:
                hp = getattr(res, "hp", None)
                if hp is not None:
                    hp[hotpath.REPLY_SENT] = time.perf_counter()
            self._send_peer(tag, "task_results", {"results": entries})

    # ---- peer-notify redelivery (the reply-loss fix): a notify that
    # ---- finds the peer's tag unregistered (its connection raced a
    # ---- re-registration) is re-buffered IN ORDER and retried when
    # ---- the tag re-registers, instead of being silently dropped —
    # ---- a lost final reply left the owner waiting forever.
    # Per-tag redelivery backlog cap: a fast unbounded streaming
    # producer could otherwise grow worker RSS without limit over the
    # whole redelivery window while its owner is disconnected.  On
    # overflow the buffered STREAMS are declared lost (a partially
    # redelivered stream with a missing index would hang the consumer
    # at exhaustion — strictly worse than an error): their item
    # frames are shed and their final reply is rewritten into a
    # stream error the owner raises.  Non-stream replies are kept —
    # they are the frames the redelivery buffer exists to save.
    _UNDELIVERED_CAP = 4096

    def _apply_shed(self, method, payload) -> bool:
        """Apply the shed-stream contract to one frame: True means
        the frame is a shed stream's item and must be dropped; a shed
        stream's final reply is poisoned in place.  Every path that
        emits or redelivers a frame must route through this."""
        if not self._shed_streams:
            return False
        if method == "stream_item" and \
                payload["task_id"].hex() in self._shed_streams:
            return True
        if method == "task_results":
            self._poison_shed_results(payload)
        return False

    def _send_peer(self, tag: str, method: str, payload) -> None:
        if self._apply_shed(method, payload):
            return
        q = self._undelivered.get(tag)
        if q is not None:
            # Preserve per-peer delivery order behind the backlog.
            if len(q) >= self._UNDELIVERED_CAP:
                self._shed_overflow(tag, q)
                if self._apply_shed(method, payload):
                    return
            q.append((method, payload, time.time()))
            return
        if not self.server.notify_peer(tag, method, payload):
            from collections import deque as _dq

            self._undelivered[tag] = _dq([(method, payload,
                                           time.time())])
            self._ensure_redelivery()

    def _shed_overflow(self, tag: str, q) -> None:
        """Redelivery backlog overflow: shed every buffered stream's
        item frames (marking the streams lost) and, failing that,
        drop the oldest frame outright."""
        shed = {f[1]["task_id"].hex() for f in q
                if f[0] == "stream_item"}
        if shed:
            self._shed_streams.update(dict.fromkeys(shed))
            while len(self._shed_streams) > 1024:  # bound, oldest out
                self._shed_streams.pop(
                    next(iter(self._shed_streams)), None)
            kept = [f for f in q if f[0] != "stream_item"]
            # Final replies already buffered for a just-shed stream
            # are poisoned NOW (which also retires their marks): a
            # mark must not sit live in the bound window waiting for
            # a delivery pass that may evict it first.
            for method, payload, _ts in kept:
                if method == "task_results":
                    self._poison_shed_results(payload)
            logger.warning(
                "redelivery backlog for %s overflowed; shed %d "
                "buffered stream frame(s) — %d stream(s) to this "
                "owner will fail instead of gapping", tag,
                len(q) - len(kept), len(shed))
            q.clear()
            q.extend(kept)
        if len(q) >= self._UNDELIVERED_CAP:
            logger.warning(
                "redelivery backlog for %s still full (%d); "
                "dropping oldest undelivered frame", tag, len(q))
            q.popleft()

    def _poison_shed_results(self, payload) -> None:
        """Rewrite a shed stream's final reply into an error: its
        item frames are gone, so a successful streamed=N result
        would leave the owner waiting for items that never come."""
        for _rid, res in payload.get("results", []):
            tid = getattr(res, "task_id", None)
            if tid is not None and getattr(res, "streamed", 0) \
                    and tid.hex() in self._shed_streams:
                res.ok = False
                res.error = TaskError.from_exception(RuntimeError(
                    "stream items were dropped while the owner was "
                    "disconnected (redelivery backlog overflow)"))
                res.streamed = 0
                self._shed_streams.pop(tid.hex(), None)

    def _ensure_redelivery(self) -> None:
        if self._redelivery_task is None or \
                self._redelivery_task.done():
            self._redelivery_task = spawn_task(self._redelivery_loop())

    async def _redelivery_loop(self) -> None:
        ttl = self.config.result_redelivery_timeout_s
        while self._undelivered:
            await asyncio.sleep(0.2)
            now = time.time()
            for tag in list(self._undelivered):
                q = self._undelivered[tag]
                while q and self.server.has_peer(tag):
                    method, payload, _ts = q[0]
                    # Frames buffered before a stream was shed (TTL
                    # expiry below, or an overflow mid-backlog) must
                    # get the same treatment _send_peer applies to
                    # fresh ones: skip its items, poison its reply —
                    # redelivering them would gap the stream.
                    if self._apply_shed(method, payload):
                        q.popleft()
                        continue
                    if not self.server.notify_peer(tag, method,
                                                   payload):
                        break
                    q.popleft()
                ttl_shed = False
                while q and now - q[0][2] > ttl:
                    method, payload, ts = q.popleft()
                    if method == "stream_item":
                        # Same contract as overflow shedding: once any
                        # item frame is gone the stream can never be
                        # redelivered whole, so its surviving frames
                        # are dropped and its final reply poisoned
                        # instead of handing the owner a gapped stream
                        # with a successful result.
                        self._shed_streams[
                            payload["task_id"].hex()] = None
                        ttl_shed = True
                    logger.warning(
                        "dropping undeliverable %s for %s after "
                        "%.0fs (owner never re-registered)",
                        method, tag, now - ts)
                if ttl_shed:
                    # Retire the new marks promptly where the final
                    # reply is already buffered, as _shed_overflow
                    # does — a live mark must not wait in the bound
                    # window on a delivery pass that may never come.
                    for method, payload, _ts in q:
                        if method == "task_results":
                            self._poison_shed_results(payload)
                if not q:
                    del self._undelivered[tag]

    def _on_exec_block(self, blocked: bool) -> None:
        """Runs on the TASK THREAD when the current task blocks in
        get(): marshal a queue drain to the loop so queued-behind
        tasks fail over instead of waiting out the block."""
        self._exec_blocked = blocked
        if blocked and self._loop is not None:
            self._loop.call_soon_threadsafe(self._requeue_queued)

    def _requeue_queued(self) -> None:
        if not self._exec_blocked:
            # The blocking get resolved before this callback ran — a
            # spurious drain would bounce the whole pipeline back to
            # the owner for nothing.
            return
        while self._task_queue:
            spec, ctx, fut = self._task_queue.popleft()
            res = TaskResult(task_id=spec.task_id, ok=False,
                             requeue=True)
            if fut is not None:
                if not fut.done():
                    fut.set_result(res)
            else:
                self._queue_result(ctx, res)
        self._flush_results()

    async def stream_ack(self, p):
        """Owner consumed stream items up to ``consumed`` — release
        executor backpressure (ref: generator_waiter.h signal)."""
        st = self._stream_acks.get(p["task_id"].hex())
        if st is not None:
            st["consumed"] = max(st["consumed"], int(p["consumed"]))
            st["event"].set()
        return {"ok": True}

    # -------------------------------------------------------------- actors
    async def create_actor(self, p):
        spec: TaskSpec = p["spec"]
        env_err = os.environ.get("RT_RUNTIME_ENV_ERROR")
        if env_err:
            from .errors import RuntimeEnvSetupError

            await self._agent.call("report_actor_failure", {
                "actor_id": spec.actor_id, "creation_failed": True,
                "reason": f"runtime env setup failed: {env_err}"})
            asyncio.get_event_loop().call_later(
                0.2, self._exit_event.set)
            return {"ok": False,
                    "error": repr(RuntimeEnvSetupError(env_err))}
        self._bind_gpus(p.get("gpu_ids") or [])
        self.runtime.current_lease_id = p.get("lease_id")
        cls = self._load_func(spec)
        loop = asyncio.get_event_loop()

        def _construct():
            self.runtime.set_current_task(spec.task_id)
            try:
                pos, kwargs = self._resolve_args(spec)
                return cls(*pos, **kwargs), None
            except BaseException as e:  # noqa: BLE001
                tb = traceback.format_exc()
                return None, (e, tb)
            finally:
                self.runtime.set_current_task(None)

        instance, err = await loop.run_in_executor(
            self._task_executor, _construct)
        if err is not None:
            exc, tb = err
            await self._agent.call("report_actor_failure", {
                "actor_id": spec.actor_id, "creation_failed": True,
                "reason": f"__init__ raised {exc!r}\n{tb}"})
            # Exit so the agent reaps this worker and frees the lease —
            # a worker that ran a failing __init__ may hold partial state.
            asyncio.get_event_loop().call_later(0.2, self._exit_event.set)
            return {"ok": False, "error": repr(exc)}
        self.actor_id = spec.actor_id
        self.runtime.current_actor_id = spec.actor_id
        self.actor_instance = instance
        n = max(1, spec.max_concurrency)
        self.actor_executor = ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="actor-exec")
        self._actor_max_concurrency = n
        # Named concurrency groups (ref: concurrency_group_manager.h:34
        # + fiber.h): each group gets its OWN thread pool (sync
        # methods) and asyncio semaphore (async methods), so a slow
        # group can never starve another — the default group is the
        # base actor_executor above.  Method -> group defaults come
        # from @ray_tpu_torch.method annotations on the class.
        self._group_executors: Dict[str, ThreadPoolExecutor] = {}
        self._group_sems: Dict[str, asyncio.Semaphore] = {}
        self._method_groups: Dict[str, str] = {}
        for gname, cap in (spec.concurrency_groups or {}).items():
            cap = max(1, int(cap))
            self._group_executors[gname] = ThreadPoolExecutor(
                max_workers=cap,
                thread_name_prefix=f"actor-{gname}")
            self._group_sems[gname] = asyncio.Semaphore(cap)
        for mname in spec.method_names:
            fn = getattr(instance, mname, None)
            mopts = getattr(fn, "__rt_method_options__", None)
            if mopts and mopts.get("concurrency_group"):
                self._method_groups[mname] = mopts["concurrency_group"]
        self._group_sems[""] = asyncio.Semaphore(n)
        # All-sync ordered actors take a queue+drain-thread fast path
        # in exec_actor (no per-call executor handoff); any coroutine
        # method forces the lock path so sync/async arrival order is
        # preserved.
        self._actor_all_sync = not any(
            inspect.iscoroutinefunction(getattr(instance, m, None))
            or inspect.isgeneratorfunction(getattr(instance, m, None))
            for m in spec.method_names)
        from collections import deque as _dq

        self._actor_call_queue: "_dq" = _dq()
        self._actor_drain: Optional[asyncio.Task] = None
        # max_concurrency=1: owners PIPELINE calls (frames arrive before
        # earlier replies are sent), so ordering must be enforced here —
        # one FIFO lock serializing sync and async methods in arrival
        # order (asyncio.Lock wakes waiters FIFO; handler tasks start in
        # frame-arrival order).  Ref: ActorSchedulingQueue in
        # transport/task_receiver.h executing in sequence-number order.
        self._actor_exec_lock = (asyncio.Lock()
                                 if n == 1
                                 and not self._group_executors
                                 else None)
        from .ids import NodeID

        # Through the agent's batched relay (one persistent controller
        # connection, bulk actors_started frames on a 5 ms window) —
        # NOT a fresh per-actor controller dial: a 100-replica fan-out
        # registers in a handful of round trips.
        r = await self._agent.call("report_actor_started", {
            "actor_id": spec.actor_id,
            "node_id": NodeID.from_hex(self.node_id_hex),
            "worker_addr": self.server.address})
        if r.get("kill"):
            self._exit_event.set()
            return {"ok": False, "error": "actor killed during creation"}
        return {"ok": True}

    async def push_actor_task(self, p) -> TaskResult:
        spec: TaskSpec = p["spec"]
        caller = p.get("caller_id", "?")
        if self.actor_instance is None:
            return TaskResult(
                task_id=spec.task_id, ok=False,
                error=ActorError.from_exception(
                    RuntimeError("actor not initialized on this worker")))
        method = getattr(self.actor_instance, spec.method_name, None)
        if method is None:
            return TaskResult(
                task_id=spec.task_id, ok=False,
                error=ActorError.from_exception(AttributeError(
                    f"actor has no method {spec.method_name!r}")))
        del caller
        if spec.is_streaming:
            self._stream_callers[spec.task_id.hex()] = \
                p.get("caller_tag", "")
        lock = getattr(self, "_actor_exec_lock", None)
        if lock is not None and getattr(self, "_actor_all_sync", False):
            # All-sync ordered actor: route through the SAME queue as
            # exec_batch arrivals.  Taking the lock directly here could
            # win it before an earlier exec_actor's drain task starts,
            # executing this later call first — mixed submission paths
            # must not violate arrival-order execution.
            loop = asyncio.get_event_loop()
            fut: asyncio.Future = loop.create_future()
            self._actor_call_queue.append((spec, method, fut))
            self._ensure_actor_drain()
            return await fut
        if lock is not None:
            async with lock:
                return await self._run_actor_method(spec, method)
        return await self._run_actor_method(spec, method)

    def _resolve_group(self, spec: TaskSpec) -> str:
        """Per-call override beats the method's declared group; ""
        (unknown groups fall back to the default pool with a warning
        rather than failing the call)."""
        group = spec.concurrency_group or \
            self._method_groups.get(spec.method_name, "")
        if group and group not in self._group_executors:
            logger.warning("unknown concurrency group %r for %s; "
                           "using default", group, spec.method_name)
            return ""
        return group

    async def _run_actor_method(self, spec: TaskSpec, method
                                ) -> TaskResult:
        group = self._resolve_group(spec)
        if inspect.iscoroutinefunction(method):
            sem = self._group_sems.get(group)
            if sem is not None:
                async with sem:
                    return await self._run_async_method(spec, method)
            return await self._run_async_method(spec, method)
        executor = self._group_executors.get(group,
                                             self.actor_executor)
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(
            executor, self._execute_sync, spec, method, None, [])

    async def _run_async_method(self, spec: TaskSpec, method) -> TaskResult:
        # NOTE: no set_current_task here — the task context is a
        # thread-local shared by every coroutine on this loop, and
        # concurrent async methods would cross-contaminate it (object
        # IDs stay unique regardless: the put counter is process-global).
        loop = asyncio.get_event_loop()
        # Tracing parity with _execute_sync: async methods execute AS a
        # child span of the submitter's context.  Safe to set here: the
        # span context is a contextvars.ContextVar and each RPC dispatch
        # runs in its own asyncio task with its own context copy, so
        # concurrent coroutines cannot cross-contaminate — and nested
        # .remote() calls made from this method now inherit the span
        # (previously a documented limitation of the thread-local).
        trace_extra = {}
        span = None
        if spec.trace_ctx:
            from ..util import tracing as _tracing

            span = _tracing.child_context(spec.trace_ctx)
            _tracing.set_span_context(span)
            trace_extra = dict(span or {})
        self._emit_event(spec, "RUNNING", **trace_extra)
        try:
            # Arg resolution may block on remote objects; keep it off the
            # event loop so other handlers stay live.
            pos, kwargs = await loop.run_in_executor(
                self._task_executor, self._resolve_args, spec)
            result = await method(*pos, **kwargs)
            out = await loop.run_in_executor(
                self._task_executor, self._package_returns, spec, result)
            self._emit_event(spec, "FINISHED", **trace_extra)
            return out
        except BaseException as e:  # noqa: BLE001
            self._emit_event(spec, "FAILED", error=repr(e),
                             **trace_extra)
            return TaskResult(task_id=spec.task_id, ok=False,
                              error=ActorError.from_exception(e))

    async def exec_actor(self, p):
        """Notify-based actor call: like push_actor_task but the
        result returns through the batched task_results channel (one
        response frame per burst instead of per call)."""
        spec: TaskSpec = p["spec"]
        ctx = {"caller_tag": p["caller_tag"],
               "reply_id": p["reply_id"]}
        if self.actor_instance is None:
            self._queue_result(ctx, TaskResult(
                task_id=spec.task_id, ok=False,
                error=ActorError.from_exception(RuntimeError(
                    "actor not initialized on this worker"))))
            return
        method = getattr(self.actor_instance, spec.method_name, None)
        if method is None:
            self._queue_result(ctx, TaskResult(
                task_id=spec.task_id, ok=False,
                error=ActorError.from_exception(AttributeError(
                    f"actor has no method {spec.method_name!r}"))))
            return
        if spec.is_streaming:
            self._stream_callers[spec.task_id.hex()] = \
                p.get("caller_tag", "")
        lock = getattr(self, "_actor_exec_lock", None)
        if lock is not None and self._actor_all_sync:
            # No generator/coroutine methods exist on this actor (the
            # _actor_all_sync predicate excludes them), so every call
            # takes THIS path — the lock path below can never
            # interleave out of arrival order with the queue.
            # Ordered all-sync actor: drain calls back-to-back on the
            # actor thread (arrival order == queue order == execution
            # order; one executor submission per burst).
            self._actor_call_queue.append((spec, method, ctx))
            self._ensure_actor_drain()
            return
        if lock is not None:
            async with lock:
                res = await self._run_actor_method(spec, method)
        else:
            res = await self._run_actor_method(spec, method)
        self._queue_result(ctx, res)

    def _ensure_actor_drain(self) -> None:
        if self._actor_drain is None or self._actor_drain.done():
            self._actor_drain = spawn_task(self._actor_drain_loop())
            self._actor_drain.add_done_callback(
                lambda _t: (self._actor_call_queue
                            and self._ensure_actor_drain()))

    async def _actor_drain_loop(self) -> None:
        loop = asyncio.get_event_loop()
        lock = self._actor_exec_lock
        async with lock:   # serialize vs push_actor_task arrivals
            await loop.run_in_executor(
                self.actor_executor, self._drain_actor_calls, loop)

    def _drain_actor_calls(self, loop) -> None:
        while True:
            try:
                spec, method, ctx = self._actor_call_queue.popleft()
            except IndexError:
                break
            res = self._execute_sync(spec, method, None, [])
            if isinstance(ctx, dict):  # exec_actor notify path
                loop.call_soon_threadsafe(self._queue_result, ctx, res)
            else:  # push_actor_task future
                loop.call_soon_threadsafe(
                    lambda f=ctx, r=res:
                    f.set_result(r) if not f.done() else None)
        loop.call_soon_threadsafe(self._flush_results)

    async def cancel_task(self, p):
        """Best-effort in-band cancellation (ref: core_worker CancelTask →
        KeyboardInterrupt in the executing thread).  A running task gets
        TaskCancelledError raised asynchronously in its thread; a queued
        task is marked so it errors out instead of starting."""
        tid = p["task_id"]
        cur = self._current_sync_task
        if cur is not None and cur[0] == tid:
            import ctypes

            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(cur[1]),
                ctypes.py_object(TaskCancelledError))
            if self._current_sync_task != cur:
                # The task finished before delivery; revoke so the
                # pending exception can't fire in the next task (the
                # next _execute_sync also clears at entry as a backstop).
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(cur[1]), None)
            return {"ok": True, "interrupted": True}
        self._cancelled_task_ids[tid] = None
        while len(self._cancelled_task_ids) > 512:
            self._cancelled_task_ids.popitem(last=False)
        return {"ok": True, "interrupted": False}

    # --------------------------------------------------------------- admin
    async def ping(self, _p):
        return {"ok": True, "actor": self.actor_id.hex()
                if self.actor_id else None}

    async def exit(self, _p):
        self._exit_event.set()
        return {"ok": True}

    async def dump_stack(self, _p):
        """All-thread stack dump (ref: profile_manager.py py-spy
        --dump, redesigned in-process — see util/profiling.py)."""
        from ..util.profiling import dump_stacks

        return {"ok": True, "stacks": dump_stacks()}

    async def profile(self, p):
        """Sampling profile of this worker's threads; returns folded
        stacks.  Runs in a thread so the RPC loop stays responsive."""
        from ..util.profiling import sample_profile

        duration = min(float(p.get("duration_s", 2.0)), 60.0)
        hz = min(float(p.get("hz", 100.0)), 500.0)
        folded = await asyncio.get_event_loop().run_in_executor(
            None, lambda: sample_profile(duration, hz))
        return {"ok": True, "folded": folded}

    async def torch_profile(self, p):
        """On-demand ``torch.profiler`` capture: trace what this
        worker's CUDA device and threads do for ``duration_s`` into a
        Chrome trace under the session and return its path and the
        device kernels it holds by name.  The capture runs on an
        executor thread while user code (a train loop) launches its
        kernels on another; CUPTI records the whole process's device
        activity.  Guarded: torch is only touched if user code ALREADY
        imported it in this process (control-plane work never pays the
        import); ``force`` opts into importing it anyway."""
        if "torch" not in sys.modules and not p.get("force"):
            return {"ok": False,
                    "error": "torch not imported in this worker "
                             "(pass force=True to load it)"}
        duration = min(float(p.get("duration_s", 3.0)), 120.0)
        log_dir = p.get("log_dir") or os.path.join(
            self.config.session_dir_root, self.session, "profiles",
            f"torch-{self.node_id_hex[:8]}-{os.getpid()}-"
            f"{int(time.time())}")

        def _capture():
            import json

            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(log_dir, exist_ok=True)
            with profile(activities=acts) as prof:
                # The capture window: activity on OTHER threads (the
                # train loop) lands in the trace while we sleep.
                time.sleep(duration)
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            kernels: Dict[str, int] = {}
            for e in events:
                if e.get("cat") == "kernel":
                    kernels[e["name"]] = kernels.get(e["name"], 0) + 1
            return path, kernels

        try:
            path, kernels = await asyncio.get_event_loop().run_in_executor(
                None, _capture)
        except BaseException as e:  # noqa: BLE001 — shipped to caller
            return {"ok": False, "error": repr(e)}
        return {"ok": True, "path": path, "kernels": kernels}

    async def run_forever(self):
        await self._exit_event.wait()


def main() -> None:
    logging.basicConfig(
        level=getattr(logging,
                      os.environ.get("RT_LOG_LEVEL", "INFO").upper(),
                      logging.INFO),
        format=f"%(asctime)s worker[{os.getpid()}] %(levelname)s %(message)s")
    # Debug hook: `kill -USR1 <worker pid>` dumps every thread's stack
    # to the worker log (the reference exposes py-spy via the dashboard;
    # this is the dependency-free equivalent for hung-worker triage).
    faulthandler.register(_signal.SIGUSR1, all_threads=True)
    # Crash flight recorder: dump the telemetry ring on SIGTERM or an
    # uncaught exception so postmortems on preempted slices are
    # possible.  Must install from the main thread (signal handler).
    try:
        from ray_tpu_torch.util import flight_recorder

        cfg = RuntimeConfig.from_env()
        flight_recorder.install(
            dump_dir=os.path.join(cfg.session_dir_root,
                                  os.environ["RT_SESSION_NAME"],
                                  "flight"),
            source=f"worker-{os.environ['RT_NODE_ID'][:8]}"
                   f"-{os.getpid()}")
    except Exception:
        logging.debug("flight recorder install failed", exc_info=True)

    async def _run():
        w = Worker()
        await w.start()
        await w.run_forever()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    sys.exit(0)


if __name__ == "__main__":
    main()
