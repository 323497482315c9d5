"""Public collective API: counterpart of ``ray_tpu.collective``.

Named groups of processes with eager, functional collectives (each op
returns its result and leaves its input alone, as in the JAX package):

- ``backend="nccl"`` (the counterpart of ``xla``): CUDA tensors over a
  ``torch.distributed`` NCCL process group;
- ``backend="cpu"`` / ``"gloo"``: a gloo process group; CUDA tensors are
  staged through host memory (``collective_group/cpu_group.py``).

The rendezvous is explicit.  The JAX package finds its peers through the
controller's KV store; the port has no runtime yet, so the caller names
the rendezvous (``init_method``: ``tcp://host:port`` or
``file:///path``, a ``torch.distributed`` TCPStore or FileStore), the
world size and its rank.  The first group a process joins creates the
process's default ``torch.distributed`` group, the gang that
``parallel.mesh`` builds device meshes over; later groups with the same
world size and rank are ``new_group``s of it, as every XLA group of a
process shares one ``jax.distributed`` world.  A later gloo group of
another size or rank meets at its own ``init_method`` and gets a process
group of its own (``standalone_gloo_group``), as each CPU group of the
JAX package has its own rendezvous; NCCL groups must span the gang.
The default group is torn down when the last group that the manager
made is destroyed, so a name can be reused with a new rendezvous.

``create_collective_group(actors, ...)`` and the lazy join of a
declared group need the runtime's actors and KV store, which arrive
with the port's runtime slice.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .types import Backend, GroupInfo, ReduceOp

__all__ = [
    "Backend", "ReduceOp", "GroupInfo", "GroupManager",
    "init_collective_group", "create_collective_group",
    "is_group_initialized", "destroy_collective_group", "get_group",
    "get_rank", "get_collective_group_size", "allreduce", "allgather",
    "reducescatter", "broadcast", "barrier", "send", "recv",
]

TIMEOUT = timedelta(seconds=300)


def _check_backend(backend: Backend) -> None:
    if backend is Backend.NCCL and not (torch.cuda.is_available()
                                        and dist.is_nccl_available()):
        raise RuntimeError("backend 'nccl' needs CUDA and a torch build "
                           "with NCCL; use backend='cpu' (gloo) for host "
                           "collectives")


class GroupManager:
    """Per-process registry of group memberships (one instance per
    process; a process may belong to many groups)."""

    def __init__(self):
        self._groups: Dict[str, object] = {}
        self._infos: Dict[str, GroupInfo] = {}
        self._owns_world = False

    def create_collective_group(self, backend, world_size: int, rank: int,
                                group_name: str,
                                init_method: Optional[str] = None):
        backend = Backend.parse(backend)
        _check_backend(backend)
        if backend is Backend.NCCL:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if not dist.is_initialized():
            if init_method is None:
                raise ValueError(
                    "the first group of a process needs its rendezvous: "
                    "init_method='tcp://host:port' or 'file:///path'")
            dist.init_process_group(backend.torch_name,
                                    init_method=init_method,
                                    world_size=world_size, rank=rank,
                                    timeout=TIMEOUT)
            self._owns_world = True
            pg = dist.group.WORLD
        elif (dist.get_world_size(), dist.get_rank()) == (world_size, rank):
            pg = dist.new_group(list(range(world_size)),
                                backend=backend.torch_name, timeout=TIMEOUT)
        elif backend is Backend.CPU:
            from .collective_group.base import standalone_gloo_group

            if init_method is None:
                raise ValueError(
                    f"group {group_name!r} (world {world_size}, rank "
                    f"{rank}) differs from this process's gang, so it "
                    "meets at a rendezvous of its own: pass init_method")
            pg = standalone_gloo_group(init_method, world_size, rank,
                                       TIMEOUT)
        else:
            raise RuntimeError(
                f"this process's gang is (world, rank) "
                f"{(dist.get_world_size(), dist.get_rank())}; NCCL group "
                f"{group_name!r} wants {(world_size, rank)}.  An NCCL "
                "group must span the gang; groups of other sizes are gloo "
                "(backend='cpu')")
        if backend is Backend.CPU:
            from .collective_group.cpu_group import CPUGroup

            g = CPUGroup(group_name, world_size, rank, pg)
        else:
            from .collective_group.nccl_group import NCCLGroup

            g = NCCLGroup(group_name, world_size, rank, pg)
        self._groups[group_name] = g
        self._infos[group_name] = GroupInfo(group_name, world_size, rank,
                                            backend)
        return g

    def is_group_exist(self, group_name: str) -> bool:
        return group_name in self._groups

    def get_group_by_name(self, group_name: str):
        return self._groups.get(group_name)

    def destroy_collective_group(self, group_name: str) -> None:
        g = self._groups.pop(group_name, None)
        self._infos.pop(group_name, None)
        if g is not None:
            g.destroy()
        if not self._groups and self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_world = False


_group_mgr = GroupManager()


def is_group_initialized(group_name: str = "default") -> bool:
    """True if THIS process already joined ``group_name``."""
    return _group_mgr.is_group_exist(group_name)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "cpu",
                          group_name: str = "default",
                          init_method: Optional[str] = None):
    """Join a collective group; blocks until all ``world_size`` members
    have met at ``init_method``.  Returns the group handle."""
    if not group_name:
        raise ValueError("group_name must be a non-empty string")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    if _group_mgr.is_group_exist(group_name):
        raise RuntimeError(
            f"group {group_name!r} already initialized in this process")
    return _group_mgr.create_collective_group(backend, world_size, rank,
                                              group_name, init_method)


def create_collective_group(actors, world_size: int, ranks,
                            backend: str = "cpu",
                            group_name: str = "default") -> None:
    """Declaring actors as a group from the driver needs the runtime's
    actors and KV store."""
    raise NotImplementedError(
        "create_collective_group declares actors through the runtime's KV "
        "store, which arrives with the runtime slice of the port; join "
        "explicitly with init_collective_group(world_size, rank, backend, "
        "group_name, init_method)")


def _get(group_name: str):
    g = _group_mgr.get_group_by_name(group_name)
    if g is None:
        # The JAX package joins a driver-declared group lazily here.
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process (joining a declared group lazily needs the runtime "
            "slice of the port)")
    return g


def get_group(group_name: str = "default"):
    """The group handle (its ``process_group`` feeds ``parallel``)."""
    return _get(group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave ``group_name``; the name may then be joined again."""
    _group_mgr.destroy_collective_group(group_name)


def get_rank(group_name: str = "default") -> int:
    """This process's rank in the group; -1 if not a member."""
    g = _group_mgr.get_group_by_name(group_name)
    return g.rank if g is not None else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _group_mgr.get_group_by_name(group_name)
    return g.world_size if g is not None else -1


# ------------------------------------------------------------------ ops
def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    """All-reduce across the group; returns the reduced tensor."""
    return _get(group_name).allreduce(tensor, op)


def allgather(tensor, group_name: str = "default") -> List[torch.Tensor]:
    """Every rank's tensor, in rank order."""
    return _get(group_name).allgather(tensor)


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    """Reduce, then return this rank's piece of axis 0."""
    return _get(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """``src_rank``'s tensor, on every rank."""
    return _get(group_name).broadcast(tensor, src_rank)


def barrier(group_name: str = "default") -> None:
    _get(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send (blocks until the receiver takes it)."""
    _get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default",
         timeout: float = 120.0):
    """Blocking point-to-point receive from ``src_rank``."""
    return _get(group_name).recv(src_rank, timeout=timeout)
