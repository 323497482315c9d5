"""Multi-process training plane: gang meshes, sharded state, global
batches.  Counterpart of ``ray_tpu/train/distributed.py``.

**Gang bootstrap.**  ``setup_distributed_mesh`` joins (or creates) the
gang's collective group, NCCL on CUDA and gloo on the CPU, and lays the
gang out as one ``fsdp`` x ``tensor`` DeviceMesh.  The JAX function reads
rank and world from the train session; the port has no session yet, so
the caller gives rank, world and the rendezvous.

**Process-contiguous layout invariant.**  A process drives one device,
and the mesh is a C-order reshape of the ranks, so rank r owns a
contiguous block of flattened mesh coordinates: ``mesh_coords_for_rank``
and ``global_batch_slice`` (the rows of the global batch a rank feeds)
agree with the mesh, as in the JAX package.

**Sharded state.**  ``shard_train_state`` drives the GPT-2/Llama
partition-rule sets (``models.*_partition_rules``) through
``match_partition_rules`` over the whole TrainState (moments match their
parameters' paths) and places it as DTensors, each rank keeping only its
slices of the full host values.  ``train_state_tree`` is what
``train.sharded_checkpoint.save_sharded`` writes, and
``restore_train_state`` puts what ``load_sharded`` reads back into a
TrainState.

The topology math at the top is pure Python.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# ===================================================================
# pure topology math
# ===================================================================


def derive_mesh_shape(num_hosts: int, devices_per_host: int, *,
                      fsdp: Optional[int] = None,
                      tensor: Optional[int] = None
                      ) -> Dict[str, int]:
    """fsdp/tensor axis sizes from the gang topology.

    Default policy: the ``tensor`` axis stays inside a host, so
    multi-host gangs get ``tensor=devices_per_host`` and shard everything
    else over ``fsdp``; a single host defaults to pure FSDP over its
    devices.  Either axis can be pinned; the other is derived; both
    pinned is validated."""
    if num_hosts < 1 or devices_per_host < 1:
        raise ValueError(
            f"invalid gang topology: {num_hosts} hosts x "
            f"{devices_per_host} devices")
    total = num_hosts * devices_per_host
    if fsdp is None and tensor is None:
        tensor = devices_per_host if num_hosts > 1 else 1
        fsdp = total // tensor
    elif fsdp is None:
        if tensor < 1 or total % tensor:
            raise ValueError(
                f"tensor={tensor} does not divide {total} devices")
        fsdp = total // tensor
    elif tensor is None:
        if fsdp < 1 or total % fsdp:
            raise ValueError(
                f"fsdp={fsdp} does not divide {total} devices")
        tensor = total // fsdp
    if fsdp * tensor != total:
        raise ValueError(
            f"mesh fsdp={fsdp} x tensor={tensor} needs "
            f"{fsdp * tensor} devices, gang has {total}")
    return {"fsdp": fsdp, "tensor": tensor}


def mesh_coords_for_rank(axis_sizes: Dict[str, int], rank: int,
                         world: int) -> List[Dict[str, int]]:
    """Mesh coordinates owned by rank ``rank`` of ``world`` under the
    process-contiguous layout: the C-order flattened mesh split into
    ``world`` contiguous blocks (first axis slowest)."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world {world}")
    names = list(axis_sizes)
    sizes = [int(axis_sizes[a]) for a in names]
    n = 1
    for s in sizes:
        if s < 1:
            raise ValueError(f"axis sizes must be >= 1, got "
                             f"{axis_sizes}")
        n *= s
    lo = rank * n // world
    hi = (rank + 1) * n // world
    out: List[Dict[str, int]] = []
    for lin in range(lo, hi):
        coord: Dict[str, int] = {}
        rem = lin
        for name, size in zip(reversed(names), reversed(sizes)):
            coord[name] = rem % size
            rem //= size
        out.append({a: coord[a] for a in names})
    return out


def global_batch_slice(global_batch_size: int,
                       mesh_shape: Dict[str, int], rank: int,
                       world: int) -> Tuple[int, int]:
    """[start, stop) rows of the global batch rank ``rank`` feeds when
    the batch dim is sharded along ``fsdp``.  Ranks sharing an fsdp row
    (``tensor`` spanning processes) get identical slices."""
    F = int(mesh_shape.get("fsdp", 1))
    T = int(mesh_shape.get("tensor", 1))
    D = F * T
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for world {world}")
    if D % world:
        raise ValueError(
            f"{D} mesh devices not divisible by world {world}")
    if global_batch_size % F:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"fsdp={F}")
    per_rank_devs = D // world
    lo_dev = rank * per_rank_devs
    hi_dev = lo_dev + per_rank_devs
    f_lo = lo_dev // T
    f_hi = (hi_dev - 1) // T + 1
    per_row = global_batch_size // F
    return f_lo * per_row, f_hi * per_row


# ===================================================================
# model rule-set hookup
# ===================================================================

def rules_for_model(name: str):
    """The partition-rule set for a model family by name."""
    from ..models import PARTITION_RULE_SETS

    key = name.lower().replace("-", "").replace("_", "")
    fn = PARTITION_RULE_SETS.get(key)
    if fn is None:
        raise KeyError(
            f"no partition-rule set for model {name!r}; known: "
            f"{sorted(PARTITION_RULE_SETS)}")
    return fn()


# ===================================================================
# torch.distributed layer: gang bootstrap, sharded placement, batches
# ===================================================================

def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """The ordered {axis: size} mapping of a mesh, slowest axis first."""
    from ..parallel.mesh import mesh_axis_sizes as sizes

    return sizes(mesh)


def _batch_sharding(mesh, spec):
    from ..parallel.partition_rules import prune_spec
    from ..parallel.sharding import PartitionSpec, spec_placements

    spec = PartitionSpec("fsdp") if spec is None else spec
    return spec_placements(mesh, prune_spec(spec, mesh_axis_sizes(mesh)))


@dataclass
class DistributedMesh:
    """The gang's mesh plus the topology facts train loops need."""

    mesh: Any
    axis_sizes: Dict[str, int] = field(default_factory=dict)
    rank: int = 0
    world: int = 1
    group_name: str = ""

    def batch_sharding(self, spec: Any = None):
        """Sharding for batches: batch dim over ``fsdp`` unless a spec
        says otherwise (pruned to the mesh's real axes)."""
        return _batch_sharding(self.mesh, spec)

    def batch_slice(self, global_batch_size: int) -> Tuple[int, int]:
        """The rows of the global batch THIS rank feeds."""
        return global_batch_slice(global_batch_size, self.axis_sizes,
                                  self.rank, self.world)

    def coords(self) -> List[Dict[str, int]]:
        return mesh_coords_for_rank(self.axis_sizes, self.rank,
                                    self.world)


def setup_distributed_mesh(*, rank: int, world: int,
                           init_method: Optional[str] = None,
                           fsdp: Optional[int] = None,
                           tensor: Optional[int] = None,
                           group_name: Optional[str] = None,
                           device=None) -> DistributedMesh:
    """Gang bootstrap, called in each rank's process: joins (or creates)
    the gang's collective group (``group_name``, default
    ``train/default``) at ``init_method`` (NCCL when ``device`` is CUDA,
    the default; gloo on the CPU), then lays the gang out as a
    process-contiguous fsdp x tensor mesh.  World 1 meshes over the
    local device only."""
    from .. import collective as col
    from ..device import resolve_device

    device = resolve_device(device)
    gname = group_name or "train/default"
    if not col.is_group_initialized(gname):
        col.init_collective_group(
            world, rank, backend="nccl" if device.type == "cuda" else "cpu",
            group_name=gname, init_method=init_method)
    shape = derive_mesh_shape(world, 1, fsdp=fsdp, tensor=tensor)
    ranks = [rank] if world == 1 else None
    mesh = gang_mesh(shape, ranks, device=device)
    return DistributedMesh(mesh=mesh, axis_sizes=shape, rank=rank,
                           world=world, group_name=gname)


def gang_mesh(axis_sizes: Dict[str, int], ranks=None, device=None):
    """Process-contiguous mesh over the gang (see
    ``parallel.mesh.gang_mesh`` for the layout invariant)."""
    from ..parallel.mesh import gang_mesh as _gang_mesh

    return _gang_mesh(axis_sizes, ranks, device=device)


def train_state_tree(state) -> Dict[str, Any]:
    """The TrainState as a named tree: ``step``, ``params/<path>`` and
    ``opt_state/{count,mu,nu}/...``; the moments repeat their
    parameters' paths, so one rule set matches both."""
    names = [n for n, _p in state.model.named_parameters()]
    opt = state.opt_state
    return {"step": state.step,
            "params": dict(state.model.named_parameters()),
            "opt_state": {"count": opt["count"],
                          "mu": dict(zip(names, opt["mu"])),
                          "nu": dict(zip(names, opt["nu"]))}}


def restore_train_state(state, tree) -> Any:
    """Put a restored ``train_state_tree`` (``train.sharded_checkpoint.
    load_sharded``'s result: DTensors on a mesh, or numpy on the host)
    into ``state`` in place, so that it steps on: DTensor parameters
    and moments through ``train_step.place_state``, host values copied
    into the model's parameters and onto their devices."""
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from ..parallel.partition_rules import _leaves, path_name
    from .train_step import place_state

    def dotted(node):
        return {path_name(p, "."): leaf for p, leaf in _leaves(node)}

    params = dotted(tree["params"])
    opt = tree["opt_state"]
    moments = {key: dotted(opt[key]) for key in ("mu", "nu")}
    if any(isinstance(v, DTensor) for v in params.values()):
        place_state(state, params, moments)
    else:
        named = dict(state.model.named_parameters())
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(torch.from_numpy(np.asarray(params[name])))
        for key in ("mu", "nu"):
            state.opt_state[key] = [
                torch.from_numpy(np.array(moments[key][n])).to(p.device)
                for n, p in named.items()]
    state.opt_state["count"] = int(opt["count"])
    state.step = int(tree["step"])
    return state


def state_specs(state: Any, rules, *, default: Any = None) -> Any:
    """PartitionSpec tree over the whole TrainState from a model's rule
    set: scalars replicate, optimizer moments match their parameters."""
    from ..parallel.partition_rules import match_partition_rules

    return match_partition_rules(rules, train_state_tree(state),
                                 default=default)


def shard_host_tree(tree: Any, mesh, specs: Any) -> Any:
    """Host tree -> DTensors under the specs' shardings; every rank holds
    the full host value and keeps only its slice (nothing is sent).
    Leaves that are not tensors stay as they are."""
    import torch

    from ..parallel.partition_rules import _leaves, named_tree_map, \
        path_name, tree_shardings
    from ..parallel.sharding import distribute

    shardings = {path_name(p): s
                 for p, s in _leaves(tree_shardings(mesh, specs))}
    return named_tree_map(
        lambda name, leaf: distribute(leaf.detach(), shardings[name])
        if isinstance(leaf, torch.Tensor) else leaf, tree)


def shard_train_state(state: Any, mesh, rules, *,
                      default: Any = None) -> Tuple[Any, Any]:
    """Rule-driven placement of a TrainState onto the gang mesh; returns
    ``(state, specs)`` with the state placed in place."""
    from .train_step import place_state

    specs = state_specs(state, rules, default=default)
    placed = shard_host_tree({"params": dict(
        state.model.named_parameters())}, mesh,
        {"params": specs["params"]})["params"]
    return place_state(state, placed), specs


def _from_local(x, sharding, global_batch_size: Optional[int]):
    """This rank's rows as a DTensor over its replica group's rows."""
    import math

    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import REPLICA_AXES

    sizes = mesh_axis_sizes(sharding.full_mesh)
    entry = sharding.spec[0] if len(sharding.spec) else None
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    inner = math.prod(sizes[a] for a in axes if a not in REPLICA_AXES)
    if global_batch_size is not None and global_batch_size != \
            x.shape[0] * math.prod(sizes[a] for a in axes):
        raise ValueError(f"{x.shape[0]} local rows do not make a global "
                         f"batch of {global_batch_size} over {axes}")
    shape = (x.shape[0] * inner,) + tuple(x.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(x, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=shape, stride=stride)


def put_global_batch(local_batch: Any, mesh, *, spec: Any = None,
                     global_batch_size: Optional[int] = None) -> Any:
    """This rank's rows of the batch (``global_batch_slice``) -> one
    DTensor per leaf, sharded along the batch axes of ``spec`` (default
    ``fsdp``); nothing is gathered on any host."""
    return batch_transfer(_batch_sharding(mesh, spec),
                          global_batch_size=global_batch_size)(local_batch)


def batch_transfer(sharding, *,
                   global_batch_size: Optional[int] = None
                   ) -> Callable[[Any], Any]:
    """A callable that places each batch (a dict of this rank's rows)
    under ``sharding``."""
    from ..parallel.partition_rules import named_tree_map

    def transfer(batch):
        return named_tree_map(
            lambda _n, x: _from_local(x, sharding, global_batch_size), batch)

    return transfer


def metrics_to_host(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Step metrics (the same on every rank) -> python floats."""
    return {k: float(v) for k, v in metrics.items()}
