"""Device meshes with the standard parallelism axes: counterpart of
``ray_tpu/parallel/mesh.py``.

A ``MeshSpec`` names the degrees of the axes in ``AXIS_ORDER``
(``dcn`` outermost, ``tensor`` fastest varying); ``create_mesh`` turns
it into a ``torch.distributed.device_mesh.DeviceMesh`` over the
process's gang (the default ``torch.distributed`` group that
``collective.init_collective_group`` or ``train.distributed.
setup_distributed_mesh`` made), with ``mesh_dim_names`` in
``AXIS_ORDER``.  A process drives one device, so mesh coordinates are
ranks.  Every mesh here is the C-order reshape of the ranks: the JAX
package lets ``mesh_utils`` permute TPU devices for ICI adjacency in
``create_mesh``, which has no counterpart on one host's NVLink, and
keeps the plain reshape in ``gang_mesh`` for the process-contiguous
invariant (rank r owns a contiguous block of flattened coordinates).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

AXIS_ORDER = ("dcn", "data", "fsdp", "expert", "pipeline", "seq",
              "tensor")


@dataclass
class MeshSpec:
    """Named parallelism degrees; -1 on one axis means "all remaining"."""

    dcn: int = 1
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    pipeline: int = 1
    seq: int = 1
    tensor: int = 1

    def axes(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.axes()
        wildcard = [k for k, v in sizes.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError("only one axis may be -1")
        known = 1
        for k, v in sizes.items():
            if v != -1:
                if v <= 0:
                    raise ValueError(f"axis {k} has invalid size {v}")
                known *= v
        if wildcard:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            sizes[wildcard[0]] = n_devices // known
        else:
            if known != n_devices:
                raise ValueError(
                    f"mesh {sizes} needs {known} devices, have {n_devices}")
        return MeshSpec(**sizes)

    def nontrivial_axes(self) -> Tuple[str, ...]:
        return tuple(k for k, v in self.axes().items() if v > 1)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """The ordered {axis: size} mapping of a mesh, slowest axis first."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _gang_world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh is built over the process's gang: join one first "
            "(collective.init_collective_group or "
            "train.distributed.setup_distributed_mesh)")
    return dist.get_world_size()


def _device_mesh(device, ranks: torch.Tensor, names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=names)


def create_mesh(spec: MeshSpec, ranks: Optional[Sequence[int]] = None,
                device=None):
    """A DeviceMesh for the spec over ``ranks`` (default: the whole
    gang), axes in ``AXIS_ORDER``.  ``device`` names the device type
    the mesh's tensors live on (default: CUDA, or a raise)."""
    if ranks is None:
        ranks = range(_gang_world())
    ranks = list(ranks)
    spec = spec.resolve(len(ranks))
    shape = tuple(spec.axes()[a] for a in AXIS_ORDER)
    return _device_mesh(device, torch.tensor(ranks).reshape(shape),
                        AXIS_ORDER)


def local_mesh(spec: Optional[MeshSpec] = None, device=None):
    """Mesh over this host's processes only (default spec: ``data``
    over all of them).  A gang that spans hosts raises: a DeviceMesh is
    built by every rank of the gang together."""
    world = _gang_world()
    hosts: List[Optional[str]] = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    local = [r for r, h in enumerate(hosts) if h == socket.gethostname()]
    if len(local) != world:
        raise NotImplementedError(
            f"the gang spans {len(set(hosts))} hosts; local_mesh builds "
            "one-host meshes only (use create_mesh or gang_mesh)")
    return create_mesh(spec or MeshSpec(data=world), local, device)


def process_contiguous_devices() -> List[int]:
    """The gang's ranks in process order (one device per process)."""
    return list(range(_gang_world()))


def gang_mesh(axis_sizes: Dict[str, int],
              ranks: Optional[Sequence[int]] = None, device=None):
    """Process-contiguous mesh over the gang: a plain C-order reshape of
    the ranks into the named ``axis_sizes`` (insertion order = slowest
    .. fastest varying), so rank r's coordinates are a contiguous block
    of the flattened mesh (``train.distributed.mesh_coords_for_rank``)."""
    ranks = process_contiguous_devices() if ranks is None else list(ranks)
    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[a]) for a in names)
    n = 1
    for s in shape:
        n *= s
    if n != len(ranks):
        raise ValueError(
            f"mesh {dict(axis_sizes)} needs {n} devices, gang has "
            f"{len(ranks)}")
    return _device_mesh(device, torch.tensor(ranks).reshape(shape), names)
