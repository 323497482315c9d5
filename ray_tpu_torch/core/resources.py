"""Resource accounting and NVIDIA GPU detection.

Counterpart of ``ray_tpu/core/resources.py`` with ``GPU`` in place of
``TPU`` (ref: src/ray/common/scheduling/,
python/ray/_private/accelerators/nvidia_gpu.py).  Resources are
float-valued named capacities; "CPU", "GPU", and "memory" are
predefined.  GPU detection counts the NVIDIA driver's entries without
importing torch and honours a preset ``CUDA_VISIBLE_DEVICES``; there
are no pod or topology labels.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

_EPS = 1e-9

VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"


@dataclass
class ResourceSet:
    """A bag of named float capacities with vector arithmetic."""

    amounts: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        self.amounts = {k: float(v) for k, v in self.amounts.items() if v}

    def get(self, name: str) -> float:
        return self.amounts.get(name, 0.0)

    def is_empty(self) -> bool:
        return not self.amounts

    def covers(self, demand: "ResourceSet") -> bool:
        return all(self.get(k) + _EPS >= v for k, v in demand.amounts.items())

    def add(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self.amounts)
        for k, v in other.amounts.items():
            out[k] = out.get(k, 0.0) + v
        return ResourceSet(out)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self.amounts)
        for k, v in other.amounts.items():
            nv = out.get(k, 0.0) - v
            if nv < -_EPS:
                raise ValueError(f"Resource {k} would go negative: {nv}")
            if abs(nv) < _EPS:
                out.pop(k, None)
            else:
                out[k] = nv
        return ResourceSet(out)

    def utilization(self, total: "ResourceSet") -> float:
        """Max fractional usage across resources present in `total`."""
        best = 0.0
        for k, cap in total.amounts.items():
            if cap > 0:
                used = cap - self.get(k)
                best = max(best, used / cap)
        return best

    def copy(self) -> "ResourceSet":
        return ResourceSet(dict(self.amounts))

    def __repr__(self):
        return f"ResourceSet({self.amounts})"


def _visible_ids(env: Dict[str, str]) -> Optional[List[int]]:
    """The ids a preset ``CUDA_VISIBLE_DEVICES`` lists, or None when it
    is unset.  Only integer ids are understood (a UUID list is taken as
    that many devices, numbered from 0)."""
    raw = env.get(VISIBLE_DEVICES_ENV)
    if raw is None:
        return None
    items = [x.strip() for x in raw.split(",") if x.strip()]
    if all(x.isdigit() for x in items):
        return [int(x) for x in items]
    return list(range(len(items)))


def _nvml_count(lib: str) -> Optional[int]:
    """The GPUs NVML (the driver's management library, which
    ``nvidia-smi`` reads) lets this process see, through ctypes; None
    when the library is missing or fails."""
    import ctypes

    try:
        nvml = ctypes.CDLL(lib)
    except OSError:
        return None
    count = ctypes.c_uint(0)
    try:
        if nvml.nvmlInit_v2() != 0:
            return None
        try:
            if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
                return None
        finally:
            nvml.nvmlShutdown()
    except AttributeError:
        return None
    return int(count.value)


def nvml_device_name(index: Optional[int] = None,
                     lib: str = "libnvidia-ml.so.1",
                     env: Optional[Dict[str, str]] = None) -> str:
    """The name NVML gives GPU ``index`` of this host (as
    ``nvidia-smi`` and ``torch.cuda.get_device_name`` print it), read
    through ctypes with no CUDA context and no torch.  ``index=None``
    names this process's first visible GPU: the first id of
    ``CUDA_VISIBLE_DEVICES`` where it is set, else GPU 0.  "" when no
    GPU is visible or the library is missing or fails."""
    import ctypes

    if index is None:
        ids = _visible_ids(os.environ if env is None else env)
        if ids == []:
            return ""
        index = ids[0] if ids else 0
    try:
        nvml = ctypes.CDLL(lib)
    except OSError:
        return ""
    handle = ctypes.c_void_p()
    name = ctypes.create_string_buffer(96)
    try:
        if nvml.nvmlInit_v2() != 0:
            return ""
        try:
            if nvml.nvmlDeviceGetHandleByIndex_v2(
                    ctypes.c_uint(index), ctypes.byref(handle)) != 0 \
                    or nvml.nvmlDeviceGetName(handle, name,
                                              ctypes.c_uint(96)) != 0:
                return ""
        finally:
            nvml.nvmlShutdown()
    except AttributeError:
        return ""
    return name.value.decode(errors="replace")


def detect_gpus(proc_root: str = "/proc/driver/nvidia/gpus",
                dev_glob: str = "/dev/nvidia[0-9]*",
                env: Optional[Dict[str, str]] = None,
                nvml_lib: str = "libnvidia-ml.so.1") -> List[int]:
    """The ids of this host's NVIDIA GPUs, without importing torch
    (control-plane processes never do, as the JAX runtime's never
    import jax).  A preset ``CUDA_VISIBLE_DEVICES`` gives the ids
    outright (ref: python/ray/_private/accelerators/nvidia_gpu.py, which
    reads the same variable); otherwise the count, numbered from 0,
    comes from NVML when the driver's library loads, else from the
    driver's ``/proc/driver/nvidia/gpus/*`` entries, else from the
    ``/dev/nvidia<N>`` nodes.  NVML comes first because a container
    may carry device nodes of cards it cannot use."""
    preset = _visible_ids(os.environ if env is None else env)
    if preset is not None:
        return preset
    n = _nvml_count(nvml_lib)
    if n is None:
        n = (len(glob.glob(os.path.join(proc_root, "*")))
             or len(glob.glob(dev_glob)))
    return list(range(n))


def gpu_ids(count: float) -> List[int]:
    """The ids of a node ledger's ``count`` GPUs: the first ``count``
    of a preset ``CUDA_VISIBLE_DEVICES`` that lists enough of them,
    else 0..count-1."""
    n = int(count)
    preset = _visible_ids(os.environ)
    if preset is not None and len(preset) >= n:
        return preset[:n]
    return list(range(n))


def node_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[float] = None,
    object_store_memory: Optional[float] = None,
    extra: Optional[Dict[str, float]] = None,
    gpu_override: int = 0,
) -> ResourceSet:
    """Build the resource set a node advertises, with autodetection.
    An explicit ``num_gpus`` overrides detection, as ``num_tpus`` does
    in the JAX package."""
    amounts: Dict[str, float] = {}
    amounts[CPU] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    if num_gpus is not None:
        if num_gpus:
            amounts[GPU] = float(num_gpus)
    else:
        amounts[GPU] = float(gpu_override or len(detect_gpus()))
    if memory is not None:
        amounts[MEMORY] = float(memory)
    if object_store_memory is not None:
        amounts[OBJECT_STORE_MEMORY] = float(object_store_memory)
    if extra:
        amounts.update({k: float(v) for k, v in extra.items()})
    return ResourceSet({k: v for k, v in amounts.items() if v})


class GpuLedger:
    """A node's GPU ids, handed to leases (the JAX agent's chip ledger,
    ``free_chips``, for GPUs).  Whole GPUs come off the front of
    ``free`` and go back on its end, as chips do; a share below one GPU
    takes an id that already holds shares with room left, else the
    first free id, so two ``GPU: 0.5`` leases share one id."""

    def __init__(self, ids: List[int]):
        self.free: List[int] = list(ids)
        self.shared: Dict[int, float] = {}   # id -> GPU fraction held

    def take(self, amount: float) -> Optional[List[int]]:
        if amount >= 1:
            n = int(amount)
            if len(self.free) < n:
                return None
            ids, self.free = self.free[:n], self.free[n:]
            return ids
        for gid, held in self.shared.items():
            if held + amount <= 1 + _EPS:
                self.shared[gid] = held + amount
                return [gid]
        if not self.free:
            return None
        gid = self.free.pop(0)
        self.shared[gid] = amount
        return [gid]

    def release(self, ids: List[int], amount: float) -> None:
        if not ids:
            return
        if amount >= 1:
            self.free.extend(ids)
            return
        gid = ids[0]
        held = self.shared.get(gid, 0.0) - amount
        if held > _EPS:
            self.shared[gid] = held
        else:
            self.shared.pop(gid, None)
            self.free.append(gid)


def task_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    default_cpus: float = 1.0,
) -> ResourceSet:
    amounts: Dict[str, float] = {}
    amounts[CPU] = float(default_cpus if num_cpus is None else num_cpus)
    if num_gpus:
        if num_gpus > 1 and num_gpus != int(num_gpus):
            raise ValueError(
                f"num_gpus={num_gpus}: a share of one GPU is below 1, "
                "more than one GPU is a whole number")
        amounts[GPU] = float(num_gpus)
    if memory:
        amounts[MEMORY] = float(memory)
    if resources:
        amounts.update({k: float(v) for k, v in resources.items()})
    return ResourceSet({k: v for k, v in amounts.items() if v})
