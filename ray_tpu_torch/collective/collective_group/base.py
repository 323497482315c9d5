"""What the NCCL and the gloo group share: the eager collectives over one
``torch.distributed`` process group.

The ops are functional, as in the JAX package: each returns its result
and leaves the input alone.  They call the process group's own methods
with the group's ranks (0..world-1), so they run the same on a group of
the process's default ``torch.distributed`` world and on a gloo group
made apart from it (``standalone_gloo_group``), which the functional
``torch.distributed`` API refuses.  Subclasses say where a tensor must
lie for the backend (``_stage``) and where the result goes back to
(``_unstage``).

Every collective op runs inside ``_gang_op``: the gang-op telemetry of
``collective/telemetry.py`` (latency histogram, bus bandwidth, flight
record, span, the entry watchdog's stamp with a per-group sequence
number).  Point-to-point ``send``/``recv`` are untimed, as in the JAX
groups.
"""

from __future__ import annotations

import contextlib
from datetime import timedelta
from typing import List

import torch
import torch.distributed as dist

from .. import telemetry
from ..types import ReduceOp

_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.MEAN: dist.ReduceOp.SUM,     # divided afterwards
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
              ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN}

# send/recv carry a header before the payload, so ``recv`` needs no
# shape from its caller (the JAX groups pickle whole arrays).
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_MAX_NDIM = 8


class TorchGroup:
    """One rank's membership in a named group over ``process_group``."""

    backend = ""     # the Backend value: the telemetry's backend tag

    def __init__(self, group_name: str, world_size: int, rank: int,
                 process_group):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.process_group = process_group
        self._gang_seq = 0

    # ------------------------------------------------------- placement
    def _stage(self, tensor: torch.Tensor) -> torch.Tensor:
        """A private copy of ``tensor`` where the backend can use it."""
        raise NotImplementedError

    def _unstage(self, result: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
        return result

    def _device(self) -> torch.device:
        """Where the backend receives."""
        raise NotImplementedError

    def _completed(self) -> None:
        """Return once the op just issued has completed (``wait()`` on
        a gloo op already has)."""

    @contextlib.contextmanager
    def _gang_op(self, op: str, nbytes: int = 0):
        """Time one collective (``telemetry.timed_op``, with this
        group's next gang sequence number), up to its completion."""
        self._gang_seq += 1
        with telemetry.timed_op(op, self.backend, self.world_size, nbytes,
                                group_name=self.group_name, rank=self.rank,
                                seq=self._gang_seq):
            yield
            self._completed()

    # -------------------------------------------------------------- ops
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        op = ReduceOp(op)
        with self._gang_op("allreduce", tensor.nbytes):
            x = self._stage(tensor)
            opts = dist.AllreduceOptions()
            opts.reduceOp = _TORCH_OPS[op]
            self.process_group.allreduce([x], opts).wait()
            if op == ReduceOp.MEAN:
                x = x / self.world_size
            return self._unstage(x, tensor)

    def allgather(self, tensor) -> List[torch.Tensor]:
        with self._gang_op("allgather", tensor.nbytes):
            x = self._stage(tensor)
            parts = [torch.empty_like(x) for _ in range(self.world_size)]
            self.process_group.allgather([parts], [x]).wait()
            return [self._unstage(p, tensor) for p in parts]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """Reduce, then return this rank's piece of axis 0 (pieces as
        ``torch.tensor_split`` cuts them, numpy's ``array_split``)."""
        op = ReduceOp(op)
        with self._gang_op("reducescatter", tensor.nbytes):
            x = self._stage(tensor)
            n = self.world_size
            if x.dim() and x.shape[0] % n == 0:
                out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
                opts = dist.ReduceScatterOptions()
                opts.reduceOp = _TORCH_OPS[op]
                self.process_group._reduce_scatter_base(out, x, opts).wait()
            else:   # uneven pieces: reduce whole, keep this rank's
                opts = dist.AllreduceOptions()
                opts.reduceOp = _TORCH_OPS[op]
                self.process_group.allreduce([x], opts).wait()
                out = torch.tensor_split(x, n, dim=0)[self.rank]
            if op == ReduceOp.MEAN:
                out = out / n
            return self._unstage(out, tensor)

    def broadcast(self, tensor, src_rank: int = 0):
        with self._gang_op("broadcast", tensor.nbytes):
            x = self._stage(tensor)
            opts = dist.BroadcastOptions()
            opts.rootRank = src_rank
            self.process_group.broadcast([x], opts).wait()
            return self._unstage(x, tensor)

    def barrier(self) -> None:
        with self._gang_op("barrier"):
            self.process_group.barrier(dist.BarrierOptions()).wait()

    def send(self, tensor, dst_rank: int) -> None:
        """Blocking send of a tensor of any shape and supported dtype;
        the receiver learns both from a header."""
        if tensor.dim() > _MAX_NDIM or tensor.dtype not in _DTYPES:
            raise ValueError(f"send takes up to {_MAX_NDIM} dims of "
                             f"{_DTYPES}, got {tensor.dtype} "
                             f"{tuple(tensor.shape)}")
        x = self._stage(tensor).contiguous()
        head = [_DTYPES.index(x.dtype), x.dim(), *x.shape]
        header = torch.zeros(2 + _MAX_NDIM, dtype=torch.int64,
                             device=x.device)
        header[:len(head)] = torch.tensor(head, dtype=torch.int64)
        self.process_group.send([header], dst_rank, 0).wait()
        self.process_group.send([x], dst_rank, 0).wait()

    def recv(self, src_rank: int, timeout: float = 120.0) -> torch.Tensor:
        """Blocking receive from ``src_rank``, on the device the backend
        receives on; raises if nothing arrives within ``timeout``
        seconds."""
        wait = timedelta(seconds=timeout)
        header = torch.zeros(2 + _MAX_NDIM, dtype=torch.int64,
                             device=self._device())
        self.process_group.recv([header], src_rank, 0).wait(wait)
        code, ndim, *shape = header.tolist()
        x = torch.empty(shape[:ndim], dtype=_DTYPES[code],
                        device=header.device)
        self.process_group.recv([x], src_rank, 0).wait(wait)
        return x

    def destroy(self) -> None:
        """Leave the group.  A group made with ``new_group`` is torn
        down here; the default group is left to the group manager, and
        a standalone gloo group goes with its last reference."""
        pg = self.process_group
        if pg is not dist.group.WORLD and not is_standalone(pg):
            dist.destroy_process_group(pg)
        self.process_group = None


def standalone_gloo_group(init_method: str, world_size: int, rank: int,
                          timeout: timedelta):
    """A gloo process group of its own, apart from the process's default
    ``torch.distributed`` world: its members meet at ``init_method``
    (``tcp://host:port`` or ``file:///path``), so a process can belong
    to groups of other sizes than its gang (a pipeline group beside a
    data group)."""
    store, _rank, _world = next(dist.rendezvous(
        init_method, rank, world_size, timeout=timeout))
    return dist.ProcessGroupGloo(store, rank, world_size, timeout)


def is_standalone(pg) -> bool:
    """A group made by ``standalone_gloo_group`` (not registered with
    the default world)."""
    return isinstance(pg, dist.ProcessGroupGloo)


def backend_name(pg) -> str:
    return "gloo" if is_standalone(pg) else dist.get_backend(pg)
