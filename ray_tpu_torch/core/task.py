"""Task specifications — the unit shipped from submitter to executor.

Role-equivalent to the reference's TaskSpecification (ref:
src/ray/common/task/task_spec.h, common.proto TaskSpec).  A spec carries the
function (by content-hash into the cluster function table, so hot loops
don't reship code), argument slots (inline value or object reference),
resource demand, retry policy, and scheduling strategy.
"""

from __future__ import annotations

import enum
import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID, TaskID
from .resources import ResourceSet


class TaskKind(enum.Enum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


class ArgKind(enum.Enum):
    VALUE = 0      # inline serialized value
    OBJECT_REF = 1  # must be resolved before dispatch
    # An actor's creation value, pickled by its owner
    # (``serialization.dumps``): only the worker decodes it, so the
    # controller and the node agent, which hold the creation spec for
    # restarts, never load the value's classes (torch among them).
    PACKED = 2


@dataclass
class TaskArg:
    kind: ArgKind
    value: Any = None                  # VALUE: the object; PACKED: bytes
    object_id: Optional[ObjectID] = None  # for OBJECT_REF


@dataclass
class SchedulingStrategy:
    """Where a task may run.

    Covers the reference's strategy set (ref:
    python/ray/util/scheduling_strategies.py): default hybrid, SPREAD,
    node-affinity, and placement-group bundles.
    """

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id: Optional[NodeID] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    kind: TaskKind
    func_id: str                       # sha256 hex of the function blob
    func_blob: Optional[bytes] = None  # present on first submission
    method_name: str = ""              # for ACTOR_TASK
    args: List[TaskArg] = field(default_factory=list)
    kwargs_keys: List[str] = field(default_factory=list)  # trailing args are kwargs
    num_returns: int = 1
    resources: ResourceSet = field(default_factory=ResourceSet)
    max_retries: int = 0
    retry_exceptions: bool = False
    # Execution attempt number, bumped by the owner's retry loop and
    # carried in task events so a retry's RUNNING can supersede the
    # previous attempt's FAILED headline state regardless of which
    # host's clock stamped which event.
    sched_attempt: int = 0
    name: str = ""
    scheduling: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Optional[Dict[str, Any]] = None
    # Actor-specific.
    actor_id: Optional[ActorID] = None
    max_restarts: int = 0
    max_concurrency: int = 1
    # Named concurrency groups (ref: concurrency_group_manager.h:34):
    # creation specs carry {group: capacity}; actor-task specs carry
    # the explicit per-call group override ("" = the method's default
    # group, resolved executor-side).
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    concurrency_group: str = ""
    # Creation specs: per-method defaults from @ray_tpu_torch.method
    # ({name: {"concurrency_group": ..., "num_returns": ...}}), so
    # handles reconstructed by name lookup keep them.
    method_options: Dict[str, Dict[str, Any]] = field(
        default_factory=dict)
    # Actor-task specs: True when the actor executes per concurrency
    # group — submission must not serialize calls (a dedicated signal;
    # max_concurrency stays the actor's honest value).
    unordered: bool = False
    actor_name: str = ""               # named actor registration
    namespace: str = ""
    seq_no: int = 0                    # per-actor submission order
    method_names: List[str] = field(default_factory=list)  # actor methods
    lifetime: Optional[str] = None     # None | "detached"
    # Lineage: owner address is attached by the submitting worker.
    owner_hint: str = ""
    # Tracing: submitter's span context (ref: tracing_helper.py:88
    # span injection through submission); None when tracing is off.
    trace_ctx: Optional[Dict[str, str]] = None
    # Hot-path introspection: preallocated perf_counter stamp slots
    # (util/hotpath.py slot layout) on the sampled 1-in-N task; None
    # for the unsampled fast path.
    hp: Optional[List[float]] = None

    # num_returns sentinel for streaming generators (ref:
    # num_returns="streaming" / ObjectRefGenerator, _raylet.pyx:284):
    # the executor reports yielded items incrementally; return ids are
    # minted per yield as for_task_return(task_id, index).
    STREAMING: int = -1

    @property
    def is_streaming(self) -> bool:
        return self.num_returns == TaskSpec.STREAMING

    def return_object_ids(self) -> List[ObjectID]:
        if self.is_streaming:
            # The index-0 sentinel anchors submission bookkeeping
            # (pending set, cancel routing); item ids start at 1.
            return [ObjectID.for_task_return(self.task_id, 0)]
        return [
            ObjectID.for_task_return(self.task_id, i + 1)
            for i in range(self.num_returns)
        ]

    def display_name(self) -> str:
        if self.name:
            return self.name
        if self.kind == TaskKind.ACTOR_TASK:
            return f"actor.{self.method_name}"
        return self.func_id[:8]


def func_id_of(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


@dataclass
class TaskResult:
    """Executor -> owner report for one finished task."""

    task_id: TaskID
    ok: bool
    # Per-return: ("inline", payload_bytes) or ("store", object_id) entries.
    returns: List[Tuple[str, Any]] = field(default_factory=list)
    error: Optional[Any] = None  # serialized exception (TaskError)
    worker_log: str = ""
    # ObjectRef ids embedded in inline return payloads; the executor holds
    # a transit borrow on each until the owner confirms receipt (ownership
    # handoff, ref: reference_count.h borrowed-refs protocol).
    transit_refs: List[ObjectID] = field(default_factory=list)
    # Streaming tasks: how many items were yielded before completion
    # (items themselves travel as stream_item notifies).
    streamed: int = 0
    # True: the worker returned the task UNEXECUTED (its current task
    # blocked in get(), so queued work must fail over to another
    # worker instead of deadlocking behind it) — the owner re-enqueues.
    requeue: bool = False
    # Hot-path introspection: the sampled spec's stamp vector echoed
    # back with the worker-side slots filled (util/hotpath.py).
    hp: Optional[List[float]] = None
