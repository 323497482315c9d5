"""Per-worker training session in one process: report, goodput blocks,
device prefetch and sharded checkpoints.

Counterpart of ``ray_tpu/train/session.py``.  The JAX session lives in
a training worker of the runtime and ships each ``report`` to the
trainer through a result-queue actor; the port has no runtime yet, so
its session works in a single process:

- ``report`` and ``_observe_step`` are the JAX package's: the report
  cadence is the step cadence, so each report observes
  ``rt_train_step_time_seconds`` and sets ``rt_train_step``,
  ``rt_train_tokens_per_sec`` and, with a declared FLOPs-per-token
  figure and a known device peak, ``rt_train_mfu`` and
  ``rt_train_achieved_flops_per_sec``, plus a ``train_step`` span;
- ``checkpoint_on_notice`` and ``data_wait`` attribute their blocks to
  goodput phases;
- ``iter_device_batches`` overlaps the host-to-device copy of the next
  batches with the step on the current one;
- ``save_sharded_checkpoint`` / ``load_sharded_checkpoint`` run over
  ``train/sharded_checkpoint.py``.

A ``result_queue``, interruption polling (which reads the queue) and
``get_dataset_shard`` arrive with the runtime and data slices (ROADMAP
Queue 1 item 5) and raise NotImplementedError until then.
"""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .checkpoint import Checkpoint
from .config import TelemetryConfig

_session: Optional["TrainSession"] = None

_NO_RUNTIME = ("arrives with the runtime slice of the port (ROADMAP "
               "Queue 1 item 5)")


@dataclass
class TrainSession:
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    result_queue: Any = None
    checkpoint: Optional[Checkpoint] = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    storage_dir: str = ""
    telemetry: Optional[TelemetryConfig] = None
    # Per-attempt id, identical across the gang's ranks: the sharded
    # save's commit nonce (save_id = "<step>:<attempt_id>").
    attempt_id: str = ""
    _report_index: int = 0
    _last_report_ts: Optional[float] = None
    _clock: Any = time.monotonic  # injectable for telemetry tests
    _interrupt: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.result_queue is not None:
            raise NotImplementedError(
                f"a result queue (reports shipped to a trainer) "
                f"{_NO_RUNTIME}")

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        """Observe one step's telemetry; the metrics and checkpoint stay
        with the caller (there is no trainer to ship them to)."""
        self._report_index += 1
        self._observe_step(metrics)

    # ------------------------------------------------- drain/preemption
    def interruption(self) -> Optional[Dict[str, Any]]:
        """The drain notice for this gang, or None.  Notices reach the
        JAX session through its result queue, which the port's session
        has not: it never polls, and the notice stays None."""
        return self._interrupt

    def interrupted(self) -> bool:
        return self.interruption() is not None

    def _observe_step(self, metrics: Dict[str, Any]) -> None:
        """Per-step telemetry: the report cadence IS the step cadence,
        so the delta between reports is the end-to-end step time (incl.
        data wait + host overhead); tokens/sec and achieved MFU derive
        from the declared TelemetryConfig figures."""
        try:
            from ..util.metrics import Gauge, Histogram

            now = self._clock()
            last, self._last_report_ts = self._last_report_ts, now
            step = metrics.get("step", self._report_index)
            Gauge("rt_train_step",
                  "Latest reported training step.").set(float(step))
            if last is None:
                return
            dt = max(now - last, 1e-9)
            Histogram("rt_train_step_time_seconds",
                      "Wall-clock between session.report calls "
                      "(per-step time).").observe(dt)
            # Timeline span per step, tagged step/rank: the per-rank
            # step rows and the critical-path summary
            # (util/timeline.critical_path_summary) are built from these.
            try:
                from ..util import spans

                wall_end = time.time()
                spans.record_span(
                    "step", wall_end - dt, wall_end, cat="train_step",
                    tags={"step": int(float(step)),
                          "rank": self.world_rank})
            except Exception:
                pass
            tel = self.telemetry or TelemetryConfig()
            tokens = float(metrics.get("tokens",
                                       tel.tokens_per_step or 0.0))
            if tokens <= 0:
                return
            tps = tokens / dt
            Gauge("rt_train_tokens_per_sec",
                  "Per-worker training throughput.").set(tps)
            if tel.model_flops_per_token > 0:
                peak = tel.resolved_peak_flops() * max(
                    tel.devices_per_worker, 1)
                if peak > 0:    # an unknown device has no peak: no MFU
                    Gauge("rt_train_mfu",
                          "Achieved model FLOPs utilization (0-1) from "
                          "the declared FLOPs-per-token figure.").set(
                        tps * tel.model_flops_per_token / peak)
                Gauge("rt_train_achieved_flops_per_sec",
                      "Achieved model FLOP/s per worker from the "
                      "declared FLOPs-per-token figure.").set(
                    tps * tel.model_flops_per_token)
        except Exception:
            pass  # telemetry must never fail a training step

    def iter_device_batches(self, batches, *, depth: int = 2,
                            transfer=None, sharding=None,
                            global_batch_size=None, device=None):
        """Device-prefetching wrapper for this worker's step loop; see
        the module-level ``iter_device_batches``."""
        return iter_device_batches(batches, depth=depth,
                                   transfer=transfer, sharding=sharding,
                                   global_batch_size=global_batch_size,
                                   device=device)

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint

    # ------------------------------------------- sharded checkpointing
    def save_sharded_checkpoint(self, tree: Any, *, step: int,
                                specs: Any = None,
                                mesh_axes: Optional[Dict[str, int]]
                                = None,
                                meta: Optional[Dict] = None,
                                metrics: Optional[Dict] = None,
                                report: bool = True,
                                wait_timeout_s: float = 120.0,
                                mesh=None) -> Dict[str, Any]:
        """Collective sharded save into the run directory
        (``<storage_dir>/checkpoint_<step>``): every rank calls this with
        the same ``step`` and writes only its shards (DTensor leaves
        their local shards on ``mesh``, host leaves the slices of this
        rank's coordinates per ``specs``/``mesh_axes``); rank 0 writes
        the manifest last and commits.  With ``report``, the committing
        rank reports the step and becomes the session's checkpoint, the
        one ``load_sharded_checkpoint`` restores."""
        if not self.storage_dir:
            raise RuntimeError(
                "sharded checkpointing needs the run storage dir; "
                "this session was initialized without one")
        from .sharded_checkpoint import save_sharded

        path = os.path.join(self.storage_dir,
                            f"checkpoint_{int(step):06d}")
        m = dict(meta or {})
        m.setdefault("step", int(step))
        m.setdefault("world_size", self.world_size)
        result = save_sharded(
            path, tree, specs=specs, mesh_axes=mesh_axes,
            process_index=self.world_rank,
            process_count=self.world_size, meta=m,
            wait_timeout_s=wait_timeout_s,
            # Per-attempt commit nonce: every rank of this attempt
            # derives the same value; a restarted attempt gets another.
            save_id=(f"{int(step)}:{self.attempt_id}"
                     if self.attempt_id else None),
            mesh=mesh)
        if result["committed"] and report:
            self.checkpoint = Checkpoint(path)
            self.report({"step": int(step), **(metrics or {})},
                        checkpoint=self.checkpoint)
        return result

    def load_sharded_checkpoint(self, *, mesh=None, specs: Any = None,
                                target: Any = None,
                                validate: bool = True
                                ) -> Optional[Any]:
        """Restore the session's checkpoint (if it is in the sharded
        format), resharded onto ``mesh``.  Returns None when there is no
        checkpoint; raises if the checkpoint is a blob."""
        ckpt = self.get_checkpoint()
        if ckpt is None:
            return None
        if not ckpt.is_sharded:
            raise ValueError(
                f"{ckpt.path} is not a sharded checkpoint; load it "
                f"with Checkpoint.load_pytree/load_json")
        return ckpt.load_sharded(mesh=mesh, specs=specs,
                                 target=target, validate=validate)

    def get_dataset_shard(self, name: str = "train"):
        raise NotImplementedError(
            f"dataset shards come from the data slice, which {_NO_RUNTIME}")


def init_session(**kwargs) -> TrainSession:
    global _session
    _session = TrainSession(**kwargs)
    return _session


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError("Not inside a training worker session")
    return _session


def shutdown_session() -> None:
    global _session
    _session = None


# -- public functional API (ray.train.report style) -----------------------

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


def save_sharded_checkpoint(tree, *, step: int, specs=None,
                            mesh_axes=None, meta=None, metrics=None,
                            report: bool = True,
                            wait_timeout_s: float = 120.0, mesh=None):
    """Collective per-rank sharded save (see
    ``TrainSession.save_sharded_checkpoint``)."""
    return get_session().save_sharded_checkpoint(
        tree, step=step, specs=specs, mesh_axes=mesh_axes, meta=meta,
        metrics=metrics, report=report, wait_timeout_s=wait_timeout_s,
        mesh=mesh)


def load_sharded_checkpoint(*, mesh=None, specs=None, target=None,
                            validate: bool = True):
    """Reshard-on-restore of the session's checkpoint (see
    ``TrainSession.load_sharded_checkpoint``)."""
    return get_session().load_sharded_checkpoint(
        mesh=mesh, specs=specs, target=target, validate=validate)


def get_world_rank() -> int:
    return get_session().world_rank


def get_world_size() -> int:
    return get_session().world_size


def get_local_rank() -> int:
    return get_session().local_rank


def interrupted() -> bool:
    """True once a drain/preemption notice covers this gang."""
    return get_session().interrupted()


def interruption() -> Optional[Dict[str, Any]]:
    """The gang's drain notice ({reason, node_id, deadline}) or None."""
    return get_session().interruption()


@contextmanager
def checkpoint_dir():
    """Scratch dir for building a checkpoint before report()."""
    d = tempfile.mkdtemp(prefix="rt_ckpt_build_")
    yield d


@contextmanager
def checkpoint_on_notice():
    """Wrap the urgent save a train loop performs after
    ``interrupted()`` turns true: attributes the elapsed time to the
    ``checkpoint_on_notice`` goodput sub-phase (distinct from periodic
    ``checkpoint`` saves) and observes its duration histogram."""
    from ..util import goodput

    with goodput.timed_phase(
            "checkpoint_on_notice",
            "rt_train_ckpt_on_notice_seconds",
            "Rank-0 checkpoint save raced against a drain deadline."):
        yield


@contextmanager
def data_wait():
    """Wrap the blocking part of fetching the next batch: attributes
    the elapsed time to the ``data_stall`` goodput phase and observes
    the per-step data-wait histogram."""
    from ..util import goodput

    with goodput.timed_phase(
            "data_stall", "rt_train_data_wait_seconds",
            "Time the step loop spent waiting on input data."):
        yield


def _copy_to(device, stream):
    """A transfer onto CUDA ``device`` that copies each tensor leaf (a
    numpy array becomes a tensor) from pinned host memory with a
    ``non_blocking`` copy on ``stream``, a side stream, and returns the
    placed batch with an event recorded after its copies."""
    import torch

    from ..parallel.partition_rules import named_tree_map

    def one(_name, x):
        x = torch.as_tensor(x)
        if not x.is_pinned():
            x = x.pin_memory()
        return x.to(device, non_blocking=True)

    def transfer(batch):
        with torch.cuda.stream(stream):
            placed = named_tree_map(one, batch)
            done = torch.cuda.Event()
            done.record(stream)
        return placed, done

    return transfer


def _on_consumer_stream(item):
    """The consumer's side of ``_copy_to``: its stream waits for the
    batch's copies, and each tensor is marked as used on it (so the
    allocator does not hand the side stream its memory while the step
    still reads it)."""
    import torch

    from ..parallel.partition_rules import named_tree_map

    batch, done = item
    consumer = torch.cuda.current_stream()
    consumer.wait_event(done)

    def mark(_name, x):
        x.record_stream(consumer)
        return x

    return named_tree_map(mark, batch)


def iter_device_batches(batches, *, depth: int = 2, transfer=None,
                        sharding=None, global_batch_size=None,
                        device=None):
    """Overlap the host-to-device copy with compute: a feeder thread
    places batch N+1 (N+2, ... up to ``depth``) while the step loop
    computes on batch N, so the loop dequeues batches already on (or
    on their way to) the device.

    The default placement, on the CUDA ``device`` (default: the card,
    or a raise without one; ``device="cpu"`` places on the host), pins
    each tensor leaf and copies it ``non_blocking`` on a side stream;
    the consumer's stream waits for those copies, and each tensor
    records its use on the consumer's stream.  ``sharding`` (a batch
    placement of ``train.distributed``) places each batch through
    ``train.distributed.batch_transfer`` (this rank's rows -> DTensors,
    ``global_batch_size`` when the global row count cannot be
    inferred); ``transfer`` overrides placement entirely.

    Any residual dequeue wait, the pipeline genuinely starving, is
    charged to the ``data_stall`` goodput phase and the
    ``rt_train_data_wait_seconds`` histogram.  Abandoning the iterator
    mid-stream stops and joins the feeder (``util/prefetch``).  Batches
    are dicts (nested) of tensors or numpy arrays."""
    from ..util.prefetch import iter_prefetched

    if transfer is None and sharding is not None:
        from .distributed import batch_transfer

        transfer = batch_transfer(sharding,
                                  global_batch_size=global_batch_size)
    if transfer is not None:
        return iter_prefetched(batches, depth=depth, transform=transfer,
                               wait_cm=data_wait,
                               thread_name="rt-device-prefetch")
    import torch

    from ..device import resolve_device
    from ..parallel.partition_rules import named_tree_map

    device = resolve_device(device)
    if device.type != "cuda":
        return iter_prefetched(
            batches, depth=depth,
            transform=lambda b: named_tree_map(
                lambda _n, x: torch.as_tensor(x).to(device), b),
            wait_cm=data_wait, thread_name="rt-device-prefetch")
    stream = torch.cuda.Stream(device)
    return _consumed(iter_prefetched(
        batches, depth=depth, transform=_copy_to(device, stream),
        wait_cm=data_wait, thread_name="rt-device-prefetch"))


def _consumed(items):
    try:
        for item in items:
            yield _on_consumer_stream(item)
    finally:
        items.close()      # an abandoned loop stops the feeder now
