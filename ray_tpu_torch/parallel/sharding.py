"""Logical-axis sharding rules as DTensor placements: counterpart of
``ray_tpu/parallel/sharding.py``.

Model code names each dimension ("batch", "seq", "embed", "mlp",
"heads", "kv", "vocab", ...); a ``ShardingRules`` table maps the names
to mesh axes, and a spec (one entry per tensor dim: None, an axis, or a
tuple of axes) becomes DTensor placements on the mesh.

Three points where DTensor differs from JAX's ``NamedSharding``:

- DTensors live on the *placement mesh*: the sub-mesh of the axes whose
  size is above 1, less the replica axes below (the last axis when none
  is left).  DTensor's sharding propagation enumerates strategies over
  every combination of mesh dims, so its cost grows as a power of their
  number: with three dims, the first GPT-2 step of an 8-rank CPU gang
  ran for minutes.  A size-1 axis only replicates, so dropping it
  changes no placement.
- The replica axes ``dcn`` and ``data`` (pure data parallelism: the
  default rules use them for the batch only) stay outside DTensor.  A
  tensor whose spec splits a dim over them is cut there by the rank's
  replica coordinate first (``distribute``), so each replica group has
  DTensors of its own slice over the other axes, and the sharded train
  step all-reduces the gradients over the replica axes.  A parameter may
  not use them.
- A tensor dim split over several axes (``"batch"`` -> ``("dcn",
  "data", "fsdp")``) is split major to minor in the tuple's order, as
  ``PartitionSpec`` does.  DTensor splits a dim in mesh-dim order, so a
  tuple must list its axes in ``AXIS_ORDER``; another order raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import torch

LogicalAxes = Tuple[Optional[str], ...]

# Default table: batch over data(+fsdp), params sharded over fsdp,
# hidden/head dims over tensor, sequence over seq (context parallel),
# experts over expert.
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("dcn", "data", "fsdp"),
    "seq": "seq",
    "embed": None,
    "embed_fsdp": "fsdp",       # param embed dim when FSDP-sharding params
    "mlp": "tensor",
    "heads": "tensor",
    "kv": None,
    "head_dim": None,
    "vocab": "tensor",
    "expert": "expert",
    "stage": "pipeline",
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim, each
    None, a mesh axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclass
class ShardingRules:
    rules: Dict[str, Union[str, Tuple[str, ...], None]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def mesh_axes(self, logical: LogicalAxes) -> Tuple:
        out = []
        for name in logical:
            if name is None:
                out.append(None)
            else:
                if name not in self.rules:
                    raise KeyError(f"no sharding rule for logical axis "
                                   f"{name!r}")
                out.append(self.rules[name])
        return tuple(out)

    def spec(self, logical: LogicalAxes) -> PartitionSpec:
        return PartitionSpec(*self.mesh_axes(logical))

    def prune(self, mesh) -> "ShardingRules":
        """Drop references to axes of size 1 (or absent from the mesh)."""
        sizes = _sizes(mesh)
        out = {}
        for k, v in self.rules.items():
            if v is None:
                out[k] = None
            elif isinstance(v, tuple):
                kept = tuple(a for a in v if sizes.get(a, 1) > 1)
                out[k] = kept if kept else None
            else:
                out[k] = v if sizes.get(v, 1) > 1 else None
        return ShardingRules(out)


# Data-parallel axes run outside DTensor (see the module docstring).
REPLICA_AXES = ("dcn", "data")


@functools.lru_cache(maxsize=32)
def placement_mesh(mesh):
    """The sub-mesh DTensors of ``mesh`` live on: its axes of size > 1
    that are not replica axes, in mesh order, or its last non-replica
    axis when none is left.  Cached, so every DTensor of one mesh shares
    one sub-mesh object."""
    sizes = _sizes(mesh)
    inner = tuple(a for a in mesh.mesh_dim_names if a not in REPLICA_AXES)
    names = tuple(a for a in inner if sizes[a] > 1) or inner[-1:]
    if names == tuple(mesh.mesh_dim_names):
        return mesh
    return mesh[names]


def replica_axes(mesh) -> Tuple[str, ...]:
    """The replica axes of ``mesh`` with size > 1, in mesh order."""
    sizes = _sizes(mesh)
    return tuple(a for a in mesh.mesh_dim_names
                 if a in REPLICA_AXES and sizes[a] > 1)


@dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lies: the placement mesh, the pruned spec, the
    DTensor placements (one per placement-mesh dim), and ``replica``:
    (dim, axes) pairs of the dims cut by replica axes first, on
    ``full_mesh``."""

    mesh: object
    spec: PartitionSpec
    placements: Tuple
    replica: Tuple = ()
    full_mesh: object = None


def spec_placements(mesh, spec) -> NamedSharding:
    """The placements of ``spec`` (entries naming mesh axes) on the
    placement mesh of ``mesh``; axes of size 1 or absent are dropped."""
    from torch.distributed.tensor import Replicate, Shard

    sub = placement_mesh(mesh)
    names = list(sub.mesh_dim_names)
    order = list(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    placements: List = [Replicate()] * len(names)
    pruned, replica, used = [], [], set()
    for dim, entry in enumerate(tuple(spec)):
        axes = () if entry is None else (
            tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        kept = tuple(a for a in axes if sizes.get(a, 1) > 1)
        idx = [order.index(a) for a in kept]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} splits dim {dim} over axes out of "
                f"mesh order {tuple(mesh.mesh_dim_names)}; list them major "
                "to minor in mesh order")
        if used & set(kept):
            raise ValueError(f"mesh axes {sorted(used & set(kept))} shard "
                             f"two dims in spec {spec!r}")
        used.update(kept)
        outer = tuple(a for a in kept if a in REPLICA_AXES)
        if outer:
            replica.append((dim, outer))
        for a in kept:
            if a not in REPLICA_AXES:
                placements[names.index(a)] = Shard(dim)
        if not kept:
            pruned.append(None)
        else:
            pruned.append(kept if isinstance(entry, (tuple, list))
                          else kept[0])
    return NamedSharding(sub, PartitionSpec(*pruned), tuple(placements),
                         tuple(replica), mesh)


def logical_sharding(mesh, logical: LogicalAxes,
                     rules: Optional[ShardingRules] = None) -> NamedSharding:
    """The sharding of a tensor whose dims carry these logical names."""
    rules = (rules or ShardingRules()).prune(mesh)
    return spec_placements(mesh, rules.spec(logical))


def with_logical_constraint(x, logical: LogicalAxes, mesh=None,
                            rules: Optional[ShardingRules] = None):
    """Redistribute the DTensor ``x`` to the placements its logical names
    map to (the collectives happen here, in forward and backward).
    ``mesh`` defaults to the one ``x`` lives on."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError("with_logical_constraint takes a DTensor; place "
                        "the parameters first (train_step.shard_state)")
    sharding = logical_sharding(mesh if mesh is not None else x.device_mesh,
                                logical, rules)
    return x.redistribute(sharding.mesh, sharding.placements)


def replica_slice(tensor: torch.Tensor, sharding: NamedSharding):
    """This rank's replica group's slice of the full ``tensor``: each dim
    cut by replica axes split by the rank's coordinates on them (the
    first axis major)."""
    if not sharding.replica:
        return tensor
    mesh = sharding.full_mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = _sizes(mesh)
    for dim, axes in sharding.replica:
        index, count = 0, 1
        for a in axes:
            index, count = index * sizes[a] + coord[a], count * sizes[a]
        if tensor.shape[dim] % count:
            raise ValueError(f"dim {dim} of size {tensor.shape[dim]} does "
                             f"not split over replica axes {axes}")
        tensor = tensor.chunk(count, dim)[index]
    return tensor


def distribute(tensor: torch.Tensor, sharding: NamedSharding):
    """A DTensor with ``sharding`` from the full value, which every rank
    holds: each keeps its own slice (its replica group's, then its
    placements'), nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(replica_slice(tensor, sharding), sharding.mesh,
                             list(sharding.placements), src_data_rank=None)


def shard_pytree(tree, mesh, logical_fn, rules=None):
    """Every leaf as a DTensor with the sharding of
    ``logical_fn(path, leaf)`` (a tuple of logical names, or None for
    replicated).  ``path`` is the leaf's name with ``/`` separators."""
    from .partition_rules import named_tree_map

    rules = rules or ShardingRules()

    def place(path, leaf):
        logical = logical_fn(path, leaf)
        if logical is None:
            logical = (None,) * leaf.dim()
        return distribute(leaf, logical_sharding(mesh, logical, rules))

    return named_tree_map(place, tree)


def replicate_like(x, t: torch.Tensor):
    """``t`` (a full value every rank holds, such as a mask or a RoPE
    table) as a replicated DTensor on ``x``'s mesh when ``x`` is a
    DTensor, so the two can meet in one op; ``t`` itself otherwise."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
