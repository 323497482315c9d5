"""Program performance introspection of the port: the data behind the
JAX package's ``rt perf`` report, for torch steps.

The JAX package AOT-compiles a step and reads the executable's
``cost_analysis()`` flops and bytes, ``memory_analysis()`` sizes and the
collectives of its optimized HLO.  A torch step has no executable to
read, so the torch layer here *counts* one real call instead
(``harvest_step``):

- ``flops``: every aten op's count from the formulas of
  ``torch.utils.flop_counter`` (matrix products, convolutions, SDPA),
  plus, once per launch, the cost of each hand-written kernel from one
  formula (``ops.flash_attention.flash_cost``, entered through
  ``kernel``): the kernels are opaque to the dispatcher, and their plain
  versions' own aten ops are not counted beside them;
- ``bytes``: each aten op's input and output bytes, views and bare
  allocations excluded, plus the kernels' bytes from the same formula:
  the counterpart of XLA's "bytes accessed";
- ``memory``: ``argument`` (the tensors the call was given: parameters,
  moments, batch) and ``output`` (new tensors it returned), and on the
  card ``temp`` (the allocator's peak during the call less the memory
  allocated at entry) and ``peak`` (that peak);
- ``collectives``: the collective ops of ``c10d`` and the functional
  collectives (the ops ``CommDebugMode`` counts), with their result
  bytes and their process group's ranks, attributed to mesh axes by
  ``attribute_axes``/``summarize_collectives``.

The counting is one ``TorchDispatchMode`` that counts plain tensors
only: a DTensor op desugars first, and its local ops and collectives
are counted, so the figures are per device, as XLA's are.
``FlopCounterMode`` itself would count a DTensor op at its global shape
and then its local ops again, plus the fake tensors of DTensor's
sharding propagation; ``CommDebugMode``'s module tracker hooks every
module's backward, which reorders gradient accumulation (float32
gradients then differ in their last bits).  The harvest changes no
result: its ops run as they would without it.

Names, tags and help strings of the published ``rt_xla_*`` series are
the JAX package's, so the same readers read them; on the port they
describe the torch step.  The pure layer (peak tables, ``roofline``,
``attribute_axes``, ``collective_wire_bytes``, ``summarize_collectives``,
``build_report``, ``render_report``) is a copy of the JAX module's.  The
HLO parsers are not: the port has no HLO.  ``cluster_report`` needs a
controller and raises until the runtime slice.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# ------------------------------------------------------------------
# Peak-rate tables: a mirror of train/config.py's (pinned by
# tests/test_torch_xprof.py), keyed by a fragment of the CUDA device
# name.  NVIDIA H100 SXM data sheet: dense bf16, HBM3, and NVLink 4's
# 900 GB/s total as 450 GB/s per direction.
PEAK_FLOPS_BY_DEVICE: Dict[str, float] = {
    "H100 80GB HBM3": 989e12,
}

PEAK_HBM_BYTES_PER_SEC_BY_DEVICE: Dict[str, float] = {
    "H100 80GB HBM3": 3.35e12,
}

INTERCONNECT_BYTES_PER_SEC_BY_DEVICE: Dict[str, float] = {
    "H100 80GB HBM3": 450e9,
}


def _device_name() -> str:
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.cuda.current_device())


def _resolve(env: str, table: Dict[str, float]) -> float:
    """The ``env`` override, else the table entry whose key the current
    device's name contains, else 0 (an unknown device or the CPU)."""
    value = os.environ.get(env, "")
    if value:
        try:
            return float(value)
        except ValueError:
            pass
    name = _device_name()
    return next((v for k, v in table.items() if k in name), 0.0)


def resolve_peak_flops() -> float:
    return _resolve("RT_PEAK_FLOPS_PER_DEVICE", PEAK_FLOPS_BY_DEVICE)


def resolve_peak_hbm() -> float:
    return _resolve("RT_PEAK_HBM_BYTES_PER_SEC",
                    PEAK_HBM_BYTES_PER_SEC_BY_DEVICE)


def resolve_interconnect() -> float:
    return _resolve("RT_INTERCONNECT_BYTES_PER_SEC",
                    INTERCONNECT_BYTES_PER_SEC_BY_DEVICE)


# ------------------------------------------------------------------
# Roofline math.

def roofline(flops: float, bytes_accessed: float, peak_flops: float,
             peak_bytes_per_sec: float) -> Dict[str, float]:
    """Classic roofline position of one program: arithmetic intensity
    (flops per HBM byte), the attainable FLOP/s ceiling at that
    intensity (min of the compute roof and the bandwidth roof), and
    the ridge point where the two roofs meet."""
    intensity = flops / bytes_accessed if bytes_accessed > 0 else 0.0
    ridge = peak_flops / peak_bytes_per_sec \
        if peak_bytes_per_sec > 0 else 0.0
    attainable = min(peak_flops, intensity * peak_bytes_per_sec) \
        if intensity > 0 else 0.0
    min_time_s = flops / attainable if attainable > 0 else 0.0
    return {
        "flops": flops,
        "bytes": bytes_accessed,
        "intensity": intensity,
        "ridge_intensity": ridge,
        "attainable_flops_per_sec": attainable,
        "bound": "compute" if intensity >= ridge and ridge > 0
        else "memory",
        "min_time_s": min_time_s,
    }



# ------------------------------------------------------------------
# Collective -> mesh-axis attribution.

def _prod(vals) -> int:
    out = 1
    for v in vals:
        out *= int(v)
    return out


def _coords(device: int, sizes: List[int]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(device % s)
        device //= s
    return tuple(reversed(out))


def attribute_axes(groups: List[List[int]],
                   axis_sizes: Optional[Dict[str, int]]) -> str:
    """Which mesh axes a collective's groups span.

    Group members are gang ranks, which index the mesh's flattened
    (C-order) device array (``parallel.mesh`` builds every mesh as the
    C-order reshape of the ranks), so a rank unravels to mesh
    coordinates over the ordered ``axis_sizes``.  An axis whose coordinate varies within a group is
    an axis the collective communicates over; a group that spans
    several axes at once (e.g. a global all-reduce on a 2D mesh)
    reports the combined ``a+b`` key."""
    if not axis_sizes:
        return "all"
    names = list(axis_sizes)
    sizes = [int(axis_sizes[n]) for n in names]
    total = _prod(sizes)
    varying: set = set()
    for g in groups:
        if any(d < 0 or d >= total for d in g):
            return "unknown"
        cs = [_coords(d, sizes) for d in g]
        for ax in range(len(names)):
            if len({c[ax] for c in cs}) > 1:
                varying.add(ax)
    if not varying:
        return "none"
    return "+".join(names[i] for i in sorted(varying))


def collective_wire_bytes(op: str, result_bytes: float,
                          group_size: int) -> float:
    """Per-device wire bytes under the standard ring conventions,
    computed from the RESULT shape: an all-gather's result is the
    gathered (full) array, a reduce-scatter's is the scattered
    shard."""
    g = max(int(group_size), 1)
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes * (g - 1) / g   # all-gather / all-to-all


def summarize_collectives(collectives: List[Dict[str, Any]],
                          axis_sizes: Optional[Dict[str, int]]
                          ) -> Dict[str, Dict[str, Any]]:
    """Aggregate recorded collectives ({"op", "bytes", "groups"}) into
    per-mesh-axis wire bytes: {axis: {"bytes", "ops", "by_op": {op:
    bytes}}}.  Empty groups mean one group of every device."""
    out: Dict[str, Dict[str, Any]] = {}
    world = _prod(axis_sizes.values()) if axis_sizes else 0
    for c in collectives:
        groups = c.get("groups") or []
        if not groups and world:
            groups = [list(range(world))]
        axis = attribute_axes(groups, axis_sizes)
        if axis == "none":
            continue
        gsize = max((len(g) for g in groups), default=world or 1)
        wire = collective_wire_bytes(c["op"], c.get("bytes", 0.0),
                                     gsize)
        if wire <= 0:
            continue
        a = out.setdefault(axis, {"bytes": 0.0, "ops": 0, "by_op": {}})
        a["bytes"] += wire
        a["ops"] += 1
        a["by_op"][c["op"]] = a["by_op"].get(c["op"], 0.0) + wire
    return out


# ------------------------------------------------------------------
# Report assembly (pure: programs + measured times in, report out).

def build_report(programs: Dict[str, Dict[str, Any]],
                 measured: Optional[Dict[str, Dict[str, float]]] = None,
                 *, peak_flops: Optional[float] = None,
                 peak_hbm: Optional[float] = None,
                 interconnect: Optional[float] = None
                 ) -> Dict[str, Any]:
    """Combine harvested program facts with measured step times.

    ``programs``: {name: {"flops", "bytes", "memory": {kind: bytes},
    "collectives": {axis: {"bytes", ...}}, "compiles",
    "compile_seconds"}} — flops/bytes are PER DEVICE (``harvest_step``
    counts the local ops of a sharded step).  ``measured``: {name: {"step_time_s": ...,
    "achieved_flops_per_sec": ...}} (either key optional).

    Per program the report carries the roofline position, achieved vs
    attainable FLOP/s, and a step decomposition: roofline-minimum
    compute time, per-axis collective minimum time at the interconnect
    bandwidth, and the unattributed remainder of the measured step.
    """
    peak_flops = peak_flops or resolve_peak_flops()
    peak_hbm = peak_hbm or resolve_peak_hbm()
    interconnect = interconnect or resolve_interconnect()
    measured = measured or {}
    rows: Dict[str, Any] = {}
    for name, prog in sorted((programs or {}).items()):
        flops = float(prog.get("flops") or 0.0)
        bytes_ = float(prog.get("bytes") or 0.0)
        rl = roofline(flops, bytes_, peak_flops, peak_hbm)
        colls = prog.get("collectives") or {}
        total_coll = sum(float(a.get("bytes") or 0.0)
                         for a in colls.values())
        axes = {}
        for axis, a in sorted(colls.items()):
            b = float(a.get("bytes") or 0.0)
            axes[axis] = {
                "bytes": b,
                "byte_share": b / total_coll if total_coll > 0 else 0.0,
                "min_time_s": b / interconnect
                if interconnect > 0 else 0.0,
                "by_op": dict(a.get("by_op") or {}),
            }
        row: Dict[str, Any] = {
            "roofline": rl,
            "memory": dict(prog.get("memory") or {}),
            "collectives": axes,
            "collective_bytes": total_coll,
            "compiles": float(prog.get("compiles") or 0.0),
            "compile_seconds": float(prog.get("compile_seconds")
                                     or 0.0),
        }
        m = measured.get(name) or {}
        step_s = float(m.get("step_time_s") or 0.0)
        achieved = float(m.get("achieved_flops_per_sec") or 0.0)
        if not achieved and step_s > 0 and flops > 0:
            achieved = flops / step_s
        if achieved > 0:
            row["achieved_flops_per_sec"] = achieved
            row["mfu"] = achieved / peak_flops if peak_flops else 0.0
            if rl["attainable_flops_per_sec"] > 0:
                row["of_attainable"] = \
                    achieved / rl["attainable_flops_per_sec"]
        if step_s > 0:
            comm_s = sum(a["min_time_s"] for a in axes.values())
            compute_s = min(rl["min_time_s"], step_s)
            decomp = {"compute_min_s": compute_s,
                      "collective_min_s": comm_s,
                      "other_s": max(step_s - compute_s - comm_s,
                                     0.0),
                      "step_time_s": step_s}
            decomp["shares"] = {
                "compute": compute_s / step_s,
                "collective": min(comm_s / step_s, 1.0),
                "other": decomp["other_s"] / step_s,
            }
            decomp["axis_time_shares"] = {
                axis: min(a["min_time_s"] / step_s, 1.0)
                for axis, a in axes.items()}
            row["decomposition"] = decomp
        rows[name] = row
    return {
        "ts": time.time(),
        "peaks": {"device": _device_name(),
                  "flops_per_sec": peak_flops,
                  "hbm_bytes_per_sec": peak_hbm,
                  "interconnect_bytes_per_sec": interconnect},
        "programs": rows,
    }


def _fmt(v: float) -> str:
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6),
                      ("k", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.1f}"


def render_report(report: Dict[str, Any]) -> str:
    """Human-readable `rt perf` report."""
    lines: List[str] = []
    pk = report.get("peaks") or {}
    lines.append(
        f"Peaks ({pk.get('device') or '?'}): "
        f"{_fmt(pk.get('flops_per_sec', 0.0))}FLOP/s  HBM "
        f"{_fmt(pk.get('hbm_bytes_per_sec', 0.0))}B/s  interconnect "
        f"{_fmt(pk.get('interconnect_bytes_per_sec', 0.0))}B/s")
    programs = report.get("programs") or {}
    if not programs:
        lines.append("(no programs registered yet — run a train step "
                     "or LLM engine with telemetry on)")
    for name, row in programs.items():
        rl = row.get("roofline") or {}
        lines.append(f"\n{name}:")
        lines.append(
            f"  roofline        {_fmt(rl.get('flops', 0.0))}FLOP  "
            f"{_fmt(rl.get('bytes', 0.0))}B  intensity "
            f"{rl.get('intensity', 0.0):.1f} FLOP/B "
            f"({rl.get('bound', '?')}-bound; ridge "
            f"{rl.get('ridge_intensity', 0.0):.1f})")
        lines.append(
            f"  attainable      "
            f"{_fmt(rl.get('attainable_flops_per_sec', 0.0))}FLOP/s"
            + (f"  achieved {_fmt(row['achieved_flops_per_sec'])}"
               f"FLOP/s" if row.get("achieved_flops_per_sec") else "")
            + (f"  ({100 * row['of_attainable']:.1f}% of attainable, "
               f"MFU {100 * row.get('mfu', 0.0):.1f}%)"
               if row.get("of_attainable") else ""))
        mem = row.get("memory") or {}
        if mem:
            parts = "  ".join(f"{k}={_fmt(v)}B" for k, v in
                              sorted(mem.items()) if v)
            lines.append(f"  memory          {parts}")
        for axis, a in (row.get("collectives") or {}).items():
            ops = "  ".join(f"{op}={_fmt(b)}B" for op, b in
                            sorted(a.get("by_op", {}).items()))
            lines.append(
                f"  axis {axis:<10} {_fmt(a['bytes'])}B wire "
                f"({100 * a['byte_share']:.1f}% of collective bytes, "
                f"min {a['min_time_s'] * 1e3:.2f}ms)  {ops}")
        d = row.get("decomposition")
        if d:
            sh = d.get("shares") or {}
            lines.append(
                f"  decomposition   step {d['step_time_s'] * 1e3:.1f}"
                f"ms = compute {d['compute_min_s'] * 1e3:.1f}ms "
                f"({100 * sh.get('compute', 0.0):.0f}%) + collective "
                f"{d['collective_min_s'] * 1e3:.1f}ms "
                f"({100 * sh.get('collective', 0.0):.0f}%) + other "
                f"{d['other_s'] * 1e3:.1f}ms")
            ax = d.get("axis_time_shares") or {}
            if ax:
                lines.append("                  " + "  ".join(
                    f"{axis}={100 * s:.1f}%"
                    for axis, s in sorted(ax.items())))
        if row.get("compiles"):
            lines.append(
                f"  compiles        {row['compiles']:.0f} "
                f"({row['compile_seconds']:.2f}s total)")
    dm = report.get("device_memory") or {}
    if dm:
        lines.append("\nDevice memory:")
        for src in sorted(dm):
            for dev in sorted(dm[src]):
                row = dm[src][dev]
                limit = row.get("limit", 0.0)
                used = row.get("used", 0.0)
                peak = row.get("peak", 0.0)
                pct = f" ({100 * used / limit:.1f}% used, peak " \
                      f"{100 * peak / limit:.1f}%)" if limit else ""
                lines.append(
                    f"  {src} dev{dev}: used {_fmt(used)}B  peak "
                    f"{_fmt(peak)}B  limit {_fmt(limit)}B{pct}")
    return "\n".join(lines) + "\n"




# ==================================================================
# torch layer: the program registry and the counting harvest.

_PROGRAMS: Dict[str, Dict[str, Any]] = {}
_PLOCK = threading.Lock()


def local_programs() -> Dict[str, Dict[str, Any]]:
    """This process's registered programs (deep-ish copy)."""
    with _PLOCK:
        return {k: dict(v) for k, v in _PROGRAMS.items()}


def _reset_local() -> None:
    with _PLOCK:
        _PROGRAMS.clear()


class _Counts:
    """What one ``harvest_step`` counted."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: List[Dict[str, Any]] = []
        self.lock = threading.Lock()


# The harvest in progress, if any.  Process-wide rather than
# thread-local: the autograd engine runs a CUDA backward (and the
# kernels' backward launches) on its own thread.  One harvest at a time.
_ACTIVE: List[_Counts] = []
_HARVEST_LOCK = threading.RLock()


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """Wrap one launch of a hand-written kernel, or of its plain
    version: during a harvest, add ``flops`` and ``nbytes`` (the
    kernel's one cost formula) and suspend the counting modes inside,
    so the plain version's aten ops are not counted beside them.  Free
    outside a harvest."""
    if not _ACTIVE:
        yield
        return
    counts = _ACTIVE[-1]
    with counts.lock:
        row = counts.kernels.setdefault(
            name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["flops"] += float(flops)
        row["bytes"] += float(nbytes)
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


# Collectives by torch op name -> the JAX package's (HLO) op names.
# ``c10d`` ops take their output (or in-out) tensors first; the
# functional ones return their result.
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensor_list(obj) -> list:
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensor_list(x)]
    return []


def _group_ranks(func, args, kwargs) -> List[int]:
    """The global ranks of a collective's process group ([] when it
    cannot be resolved: counted as one group of the whole mesh)."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import ProcessGroup

    names = [a.name for a in func._schema.arguments]
    values = dict(zip(names, args), **kwargs)
    try:
        if "group_name" in values:
            pg = dist.distributed_c10d._resolve_process_group(
                values["group_name"])
        else:
            pg = ProcessGroup.unbox(values["process_group"])
        return list(dist.get_process_group_ranks(pg))
    except (KeyError, ValueError, RuntimeError):
        return []


def _cost_mode(counts: _Counts):
    """The counting ``TorchDispatchMode`` of ``harvest_step``.  A
    DTensor op is handed back (``NotImplemented``) to desugar into
    local ops and collectives, which come back here."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    plain = (torch.Tensor, torch.nn.Parameter)

    class _CostMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func._overloadpacket not in flop_registry:
                # Under inference mode composite ops (linear, matmul)
                # arrive whole: count what they decompose into, as
                # FlopCounterMode does (the same kernels run).
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            ins = _tensor_list(list(args) + list(kwargs.values()))
            outs = _tensor_list(out)
            # Plain tensors only: DTensor's sharding propagation runs
            # ops on fake tensors.
            if any(type(t) not in plain for t in ins + outs):
                return out
            packet = func._overloadpacket
            name = packet.__name__
            if func.namespace in _COLLECTIVE_NAMESPACES:
                op = _COLLECTIVE_OPS.get(name)
                if op is not None:
                    result = outs if func.namespace != "c10d" \
                        else _tensor_list(args[0])
                    with counts.lock:
                        counts.collectives.append({
                            "op": op,
                            "bytes": float(sum(t.nbytes for t in result)),
                            "groups": [_group_ranks(func, args, kwargs)]})
                return out
            flops = 0.0
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
            nbytes = 0.0
            if not func.is_view and not name.startswith(
                    ("empty", "new_empty")):
                nbytes = float(sum(t.nbytes for t in ins + outs))
            with counts.lock:
                counts.flops += flops
                counts.bytes += nbytes
            return out

    return _CostMode()


def _tensors(obj, seen=None) -> list:
    """Every tensor reachable from ``obj`` (tensors, modules' parameters
    and buffers, mappings, sequences, dataclasses), DTensors as their
    local shards, each storage view once."""
    import dataclasses

    import torch

    if seen is None:
        seen = set()
    out = []
    if isinstance(obj, torch.Tensor):
        if hasattr(obj, "to_local"):
            obj = obj.to_local()
        key = (obj.data_ptr(), obj.nbytes, obj.device)
        if key not in seen:
            seen.add(key)
            out.append(obj)
    elif isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            out += _tensors(t, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            out += _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            out += _tensors(v, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            out += _tensors(getattr(obj, f.name), seen)
    return out


def harvest_step(fn, *args, mesh_axes: Optional[Dict[str, int]] = None
                 ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` once, a real call whose result is returned,
    counting what it does (see the module docstring).  Returns
    ``(result, info)``, ``info`` in the JAX package's shape: {"flops",
    "bytes", "memory": {kind: bytes}, "collectives": {axis: {...}}},
    plus "kernels": {name: {"launches", "flops", "bytes"}}, the
    hand-written kernels' part.  ``mesh_axes`` is the ordered {axis:
    size} of the mesh the step runs on.  On the card the allocator's
    peak statistic is reset at entry."""
    import torch

    arg_tensors = _tensors(args)
    seen = {(t.data_ptr(), t.nbytes, t.device) for t in arg_tensors}
    dev = next((t.device for t in arg_tensors if t.is_cuda), None)
    counts = _Counts()
    if dev is not None:
        torch.cuda.synchronize(dev)
        at_entry = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with _HARVEST_LOCK:
        _ACTIVE.append(counts)
        try:
            with _cost_mode(counts):
                out = fn(*args)
        finally:
            _ACTIVE.pop()
    new = _tensors(out, set(seen))
    memory = {"argument": float(sum(t.nbytes for t in arg_tensors)),
              "output": float(sum(t.nbytes for t in new))}
    if dev is not None:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        memory["temp"] = float(max(peak - at_entry, 0))
        memory["peak"] = float(peak)
    kernels = {k: dict(v) for k, v in counts.kernels.items()}
    info = {
        "flops": counts.flops + sum(k["flops"] for k in kernels.values()),
        "bytes": counts.bytes + sum(k["bytes"] for k in kernels.values()),
        "memory": memory,
        "collectives": summarize_collectives(counts.collectives,
                                             mesh_axes),
        "kernels": kernels,
    }
    return out, info


def register_program(name: str, info: Dict[str, Any],
                     compile_seconds: Optional[float] = None
                     ) -> Dict[str, Any]:
    """Register one harvested program (``harvest_step``'s ``info``) and
    publish its ``rt_xla_*`` series: the JAX package's
    ``register_compiled`` over an ``info`` dict.  ``compile_seconds``
    is the first call's duration; compiles and their seconds add up
    over registrations of the same name."""
    info = dict(info)
    info["compiles"] = 1
    info["compile_seconds"] = float(compile_seconds or 0.0)
    with _PLOCK:
        prev = _PROGRAMS.get(name)
        if prev:
            info["compiles"] += prev.get("compiles", 0)
            info["compile_seconds"] += prev.get("compile_seconds", 0.0)
        _PROGRAMS[name] = info
    _publish_program(name, info)
    return info


def count_compile(name: str, seconds: float = 0.0) -> None:
    """Count a first call of a program that was not harvested (the JAX
    package counts its jit-fallback compiles so): ``rt_xla_compiles_total``
    and its seconds, without the cost series."""
    try:
        from .metrics import Counter

        Counter("rt_xla_compiles_total",
                "XLA compile events per registered function.",
                tag_keys=("fn",)).inc(tags={"fn": name})
        if seconds > 0:
            Counter("rt_xla_compile_seconds_total",
                    "Cumulative XLA compile seconds per function.",
                    tag_keys=("fn",)).inc(seconds, tags={"fn": name})
    except Exception:
        pass


def _publish_program(name: str, info: Dict[str, Any]) -> None:
    from .metrics import Counter, Gauge

    tags = {"fn": name}
    Gauge("rt_xla_cost_flops",
          "cost_analysis() flops of the registered program "
          "(per device).", tag_keys=("fn",)).set(info["flops"],
                                                 tags=tags)
    Gauge("rt_xla_cost_bytes",
          "cost_analysis() bytes accessed of the registered program "
          "(per device).", tag_keys=("fn",)).set(info["bytes"],
                                                 tags=tags)
    mem_g = Gauge("rt_xla_memory_bytes",
                  "memory_analysis() sizes of the registered program.",
                  tag_keys=("fn", "kind"))
    for kind, v in (info.get("memory") or {}).items():
        mem_g.set(v, tags={"fn": name, "kind": kind})
    coll_g = Gauge("rt_xla_collective_bytes",
                   "Per-device collective wire bytes per step, "
                   "attributed to mesh axes from HLO replica groups.",
                   tag_keys=("fn", "axis", "op"))
    for axis, a in (info.get("collectives") or {}).items():
        for op, b in (a.get("by_op") or {}).items():
            coll_g.set(b, tags={"fn": name, "axis": axis, "op": op})
    Counter("rt_xla_compiles_total",
            "XLA compile events per registered function.",
            tag_keys=("fn",)).inc(tags=tags)
    Counter("rt_xla_compile_seconds_total",
            "Cumulative XLA compile seconds per function.",
            tag_keys=("fn",)).inc(info.get("compile_seconds", 0.0),
                                  tags=tags)




def publish_device_memory() -> int:
    """Poll ``torch.cuda.memory_stats()`` of every local CUDA device
    into the ``rt_xla_device_memory_bytes`` gauge: ``used`` (allocated
    now), ``peak`` (allocated peak) and ``limit`` (the device's total
    memory from ``torch.cuda.mem_get_info``), for each device this
    process has allocated on.  Returns the number of series written: 0
    without a card."""
    import torch

    from .metrics import Gauge

    if not torch.cuda.is_available():
        return 0
    g = Gauge("rt_xla_device_memory_bytes",
              "Device memory used/peak/limit from "
              "device.memory_stats(), polled per flush tick.",
              tag_keys=("device", "kind"))
    n = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:        # no allocation on this device yet
            continue
        _free, total = torch.cuda.mem_get_info(i)
        for kind, value in (("used", stats["allocated_bytes.all.current"]),
                            ("peak", stats["allocated_bytes.all.peak"]),
                            ("limit", total)):
            g.set(float(value), tags={"device": str(i), "kind": kind})
            n += 1
    return n


def measure_step_decomposition(loss_fn, optimizer, state, batch, *,
                               steps: int = 8, reps: int = 2,
                               flops_per_step: Optional[float] = None,
                               peak_flops: Optional[float] = None
                               ) -> Dict[str, Any]:
    """Forward / backward / optimizer seconds of one training step, by
    differences: ``steps`` forward calls (no grad), ``steps``
    forward+backward calls (``torch.autograd.grad`` of every parameter)
    and ``steps`` full steps (``train_step.make_train_step``), each loop
    timed ``reps`` times after one warm call, best rep kept: between
    CUDA events on the card, by the host clock after a synchronise on
    the CPU.  The reps alternate (forward, forward+backward, full step,
    forward, ...), so a drift of the host or the card reaches the three
    loops alike.  ``state`` (a ``TrainState``) is left as it was: its
    parameters, moments and counters are restored after the full-step
    loops.  Returns the JAX package's keys: ``forward_s``,
    ``backward_s``, ``optimizer_s``, ``full_step_s`` (per step),
    ``shares`` and, with ``flops_per_step`` and a known peak,
    ``of_peak`` (FLOPs split 1:2 between forward and backward)."""
    import torch

    from ..train.train_step import make_train_step

    model = state.model
    params = list(model.parameters())
    dev = params[0].device

    def _time(fn):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _i in range(steps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _i in range(steps):
            fn()
        return time.perf_counter() - t0

    def forward():
        with torch.no_grad():
            loss_fn(model, batch)

    def forward_backward():
        torch.autograd.grad(loss_fn(model, batch), params)

    step_fn = make_train_step(loss_fn, optimizer)
    loops = (forward, forward_backward, lambda: step_fn(state, batch))
    opt = state.opt_state
    with torch.no_grad():
        saved = [t.clone() for t in params + opt["mu"] + opt["nu"]]
    count, step = opt["count"], state.step
    best = [float("inf")] * len(loops)
    try:
        for fn in loops:
            fn()                         # warm
        for _ in range(max(reps, 1)):
            for i, fn in enumerate(loops):
                best[i] = min(best[i], _time(fn))
    finally:
        with torch.no_grad():
            for t, v in zip(params + opt["mu"] + opt["nu"], saved):
                t.copy_(v)
        opt["count"], state.step = count, step
    t_fwd, t_grad, t_full = (b / steps for b in best)
    fwd = t_fwd
    bwd = max(t_grad - t_fwd, 0.0)
    opt_s = max(t_full - t_grad, 0.0)
    out: Dict[str, Any] = {
        "steps": steps,
        "forward_s": fwd,
        "backward_s": bwd,
        "optimizer_s": opt_s,
        "full_step_s": t_full,
        "shares": {
            "forward": fwd / t_full if t_full > 0 else 0.0,
            "backward": bwd / t_full if t_full > 0 else 0.0,
            "optimizer": opt_s / t_full if t_full > 0 else 0.0,
        },
    }
    if flops_per_step:
        out["flops_per_step"] = float(flops_per_step)
        peak = peak_flops or resolve_peak_flops()
        if peak > 0:
            # fwd:bwd flops split by the standard 1:2 convention.
            of_peak = {}
            if fwd > 0:
                of_peak["forward"] = flops_per_step / 3.0 / fwd / peak
            if bwd > 0:
                of_peak["backward"] = \
                    flops_per_step * 2.0 / 3.0 / bwd / peak
            if t_full > 0:
                of_peak["full_step"] = flops_per_step / t_full / peak
            out["of_peak"] = of_peak
    return out


def cluster_report(*, address: Optional[str] = None,
                   summary: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """The cluster-wide report merges every process's registered
    programs from the controller's telemetry summary; the port has no
    controller yet.  In one process: ``build_report(local_programs(),
    measured)``."""
    raise NotImplementedError(
        "cluster_report reads the cluster telemetry summary; it arrives "
        "with the runtime slice of the port (ROADMAP Queue 1 item 5)")
