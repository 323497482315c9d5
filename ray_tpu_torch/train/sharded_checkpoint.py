"""Sharded crash-atomic checkpoints with reshard-on-restore: counterpart
of ``ray_tpu/train/sharded_checkpoint.py``, with its on-disk layout and
manifest schema, so a checkpoint either package writes is read by the
other bit for bit (``util/checkpoint_fs.py`` holds the shared format).

**Sharded.**  Every rank writes only the shards it holds
(``shard_<rank>/`` files): a DTensor contributes its ``to_local()``
shard where the rank's mesh coordinate is replica 0 of it; a host
(numpy or CPU tensor) leaf is the global value, and the rank writes the
slices of the mesh coordinates it owns (``coords_for_rank``).  There is
no gather onto rank 0.

**Crash-atomic.**  Writes land in ``<dir>.tmp/`` and are fsynced; rank
0 waits for every rank's shard index of this attempt (``save_id``),
writes ``manifest.json`` last and commits with one ``os.replace``.

**Reshardable.**  The manifest records where each saved slice lives,
so a restore at any world size or mesh reads only the intersections its
shards need: onto a ``DeviceMesh`` each leaf becomes a DTensor under the
saved spec pruned to the mesh's axes (or the caller's spec); without a
mesh it is a numpy array.

Trees are nested mappings and sequences; a mapping key with dots (a
``state_dict`` name) is split into levels, so ``train.distributed.
train_state_tree`` saves under flax-style names
(``params/h_0/c_attn/kernel``).  Leaves are named by their slash-joined
paths with keys sorted at each level, as in the JAX package.

bfloat16 leaves raise: numpy has no bfloat16, and ``np.save`` of JAX's
``ml_dtypes`` bfloat16 writes a raw ``|V2`` array that neither
package's restore can turn back into numbers.  Train states are
float32.

Telemetry, as in the JAX package: a save runs in the goodput
``checkpoint`` phase (inside a ``checkpoint_on_notice`` block that outer
phase keeps the time) and ``_observe_save`` records
``rt_train_checkpoint_save_seconds{sharded="1"}``, ``rt_checkpoint_bytes``
and ``rt_checkpoint_shards`` of this rank's write; a restore runs in
``checkpoint`` and observes ``rt_train_checkpoint_restore_seconds``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import mesh_axis_sizes
from ..util.checkpoint_fs import (FORMAT_VERSION,  # noqa: F401
                                  MANIFEST, OLD_SUFFIX, TMP_SUFFIX,
                                  CheckpointCorruptError,
                                  CheckpointNotCommittedError,
                                  atomic_write, covered_elements, crc32_hex,
                                  is_sharded_checkpoint, read_manifest,
                                  verify_checkpoint)


# ===================================================================
# pure slice math
# ===================================================================

def _norm_entry(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def _spec_entries(spec, ndim: int) -> List[Tuple[str, ...]]:
    entries = [_norm_entry(e) for e in tuple(spec)]
    while len(entries) < ndim:
        entries.append(())
    return entries[:ndim]


def dim_shard_range(dim: int, nshards: int, idx: int
                    ) -> Tuple[int, int]:
    """[start, stop) of shard ``idx`` of a dimension split ``nshards``
    ways — jax's ceil-chunk convention (trailing shards may be short
    or empty when ``nshards`` does not divide ``dim``)."""
    chunk = -(-dim // nshards) if nshards else dim
    start = min(idx * chunk, dim)
    return start, min(start + chunk, dim)


def shard_index(global_shape: Sequence[int], spec,
                axis_sizes: Dict[str, int],
                coord: Dict[str, int]) -> Tuple[Tuple[int, int], ...]:
    """The [start, stop) ranges (one per dim) of the shard a mesh
    coordinate holds under ``spec``.  Multiple axes on one dim compose
    with the FIRST-listed axis slowest-varying (jax convention);
    mesh axes absent from the spec replicate."""
    out = []
    for dim, axes in zip(global_shape,
                         _spec_entries(spec, len(global_shape))):
        nshards = 1
        for a in axes:
            nshards *= axis_sizes.get(a, 1)
        idx = 0
        for a in axes:
            idx = idx * axis_sizes.get(a, 1) + coord.get(a, 0)
        out.append(dim_shard_range(dim, nshards, idx))
    return tuple(out)


def replica_id(spec, global_ndim: int, axis_sizes: Dict[str, int],
               coord: Dict[str, int]) -> int:
    """Linear index of this coordinate among the replicas of its shard
    (over the mesh axes the spec does NOT consume).  The writer
    convention everywhere in this module: only replica 0 writes."""
    used = set()
    for axes in _spec_entries(spec, global_ndim):
        used.update(axes)
    rid = 0
    for a, size in axis_sizes.items():
        if a in used:
            continue
        rid = rid * size + coord.get(a, 0)
    return rid


def enumerate_coords(axis_sizes: Dict[str, int]
                     ) -> List[Dict[str, int]]:
    """All mesh coordinates in C order (first axis slowest)."""
    axes = list(axis_sizes)
    coords: List[Dict[str, int]] = [{}]
    for a in axes:
        coords = [{**c, a: i} for c in coords
                  for i in range(axis_sizes[a])]
    return coords


def coords_for_rank(axis_sizes: Dict[str, int], rank: int,
                    world: int) -> List[Dict[str, int]]:
    """The contiguous block of mesh coordinates rank ``rank`` of
    ``world`` owns (host-mode save: ranks split the flattened mesh)."""
    coords = enumerate_coords(axis_sizes)
    n = len(coords)
    lo = rank * n // world
    hi = (rank + 1) * n // world
    return coords[lo:hi]


def intersect(a: Sequence[Tuple[int, int]],
              b: Sequence[Tuple[int, int]]
              ) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Per-dim intersection of two index ranges, or None if empty —
    the core of reshard-on-restore: a target shard reads exactly the
    overlaps it has with each saved file."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


# ===================================================================
# tree naming helpers
# ===================================================================

def _nest(node: Any) -> Any:
    """Mappings with dotted keys split into nested levels (sequences and
    other leaves stay as they are)."""
    if not isinstance(node, Mapping):
        return node
    out: Dict[str, Any] = {}
    for key, val in node.items():
        *parents, leaf = str(key).split(".")
        cur = out
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = _nest(val)
    return out


def _flatten_named(tree) -> List[Tuple[str, Any]]:
    """(slash-joined name, leaf) pairs, mapping keys sorted at each
    level (dotted keys split first).  Leaves are tensors, arrays and
    numbers."""
    out: List[Tuple[str, Any]] = []

    def rec(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k in sorted(node, key=str):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}" if prefix else str(i), v)
        elif hasattr(node, "shape") or \
                isinstance(node, (int, float, complex, bool, np.number)):
            out.append((prefix, node))
        else:
            raise TypeError(f"cannot checkpoint {type(node).__name__} at "
                            f"{prefix!r}: trees are mappings, sequences "
                            "and tensor/array/number leaves "
                            "(train.distributed.train_state_tree)")

    rec("", _nest(tree))
    return out


def _spec_map(specs: Any, names: Sequence[str]) -> Dict[str, Any]:
    """name → spec lookup in a dict spec tree (dotted keys split), whose
    leaves may be PartitionSpecs or plain lists/tuples
    (``["fsdp", None]``)."""
    if specs is None:
        return {}
    if not isinstance(specs, dict):
        raise TypeError(f"specs is a dict tree of PartitionSpecs, not a "
                        f"{type(specs).__name__}")
    specs = _nest(specs)
    out = {}
    for name in names:
        node: Any = specs
        found = True
        for part in name.split("/"):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                found = False
                break
        if found:
            # An explicit falsy value (None/[]/P()) still counts
            # as PRESENT — it is the deliberate "replicate" spec,
            # distinct from a leaf the dict never mentions.
            out[name] = node
    return out


def _unflatten_named(pairs: Dict[str, Any]) -> Dict[str, Any]:
    """Rebuild the nested-dict tree from slash-joined leaf names (the
    inverse of ``_flatten_named`` for the dict trees flax produces)."""
    root: Dict[str, Any] = {}
    for name, value in pairs.items():
        parts = name.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return root


# ===================================================================
# low-level file I/O
# ===================================================================

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _CrcFile:
    """File-like that CRCs every chunk as ``np.save`` streams it
    through: handed a non-file object, numpy's writer emits bounded
    (~16 MB) chunks, so the checksum comes from the same single pass
    as the write with O(chunk) extra memory — neither re-reading the
    file (doubling save I/O on the preemption-grace-critical path)
    nor buffering the whole serialization (which tripled peak host
    memory per shard)."""

    def __init__(self, f):
        self._f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, data) -> int:
        self._f.write(data)
        self.crc = zlib.crc32(data, self.crc)
        self.nbytes += len(data)
        return len(data)


def _write_array(path: str, arr: np.ndarray) -> Tuple[str, int]:
    """np.save + fsync; returns (crc32 hex, byte size)."""
    with open(path, "wb") as f:
        w = _CrcFile(f)
        np.save(w, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    return format(w.crc & 0xFFFFFFFF, "08x"), w.nbytes


def _read_array(path: str, expect_crc: Optional[str] = None
                ) -> np.ndarray:
    """Validated shard read.  The CRC pass streams in bounded chunks
    and np.load decodes straight from the file (page-cache-warm after
    the CRC pass) — never the whole serialization AND the decoded
    array in memory at once (the read-side twin of _CrcFile)."""
    if expect_crc is not None:
        crc = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        got = format(crc & 0xFFFFFFFF, "08x")
        if got != expect_crc:
            raise CheckpointCorruptError(
                f"checksum mismatch for {path}: "
                f"manifest says {expect_crc}, file is {got}")
    with open(path, "rb") as f:
        return np.load(f, allow_pickle=False)


# ===================================================================
# save
# ===================================================================

def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host_array(leaf, name: str) -> np.ndarray:
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(_BF16.format(name=name))
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16" or arr.dtype.kind == "V":
        raise TypeError(_BF16.format(name=name))
    return arr


_BF16 = ("leaf {name!r} is bfloat16, which numpy cannot hold, so the "
         "sharded format cannot write or read it: save it as float32")


def _dtensor_spec(leaf) -> Tuple:
    """The PartitionSpec of a DTensor's placements (axes splitting one
    dim major to minor in mesh order, no trailing None)."""
    from torch.distributed.tensor import Replicate, Shard

    names = leaf.device_mesh.mesh_dim_names
    entries: List[List[str]] = [[] for _ in range(leaf.ndim)]
    for name, p in zip(names, leaf.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"cannot checkpoint a DTensor placed {p!r}; "
                             "redistribute partial values first")
    spec = [None if not e else e[0] if len(e) == 1 else tuple(e)
            for e in entries]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def save_sharded(path: str, tree: Any, *,
                 specs: Any = None,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 meta: Optional[Dict] = None,
                 wait_timeout_s: float = 120.0,
                 save_id: Optional[str] = None,
                 mesh=None) -> Dict[str, Any]:
    """Write this rank's shards of ``tree`` into ``path + ".tmp"``;
    rank 0 waits for every rank's shard index, writes the manifest
    LAST, and commits with ``os.replace(tmp, path)``.

    Two leaf modes, chosen per leaf:

    - **DTensors** (device mode): the rank writes its ``to_local()``
      shard where its coordinate on ``mesh`` is replica 0 of it.
      ``mesh`` is the full DeviceMesh (replica axes ``dcn``/``data``
      included); it defaults to the first DTensor's mesh, which must
      then span every rank.  ``mesh_axes``, ``process_index`` and
      ``process_count`` default to the mesh's axis sizes and the
      default ``torch.distributed`` group's rank and size.
    - **host values** (numpy arrays, CPU tensors, numbers): the leaf is
      the GLOBAL value and ``specs``/``mesh_axes``/``process_index``/
      ``process_count`` describe the layout; the rank writes only the
      slices of the mesh coordinates it owns (replica 0 per leaf).
      ``specs=None`` replicates every leaf (rank 0 writes all of it).

    ``save_id`` is the per-attempt nonce of the two-phase commit: every
    rank of one save passes the same value, and it differs between
    attempts at the same ``path``; rank 0 commits only shard indexes
    stamped with it.  Single-writer saves need none.

    Returns ``{"path", "bytes", "files", "committed"}`` for the calling
    rank (``committed`` is True only on the committing rank)."""
    from contextlib import nullcontext

    from ..util import goodput

    # Inside a checkpoint-on-notice block the OUTER phase owns the
    # wall-clock; only a periodic save enters the checkpoint phase.
    phase_cm = (nullcontext()
                if goodput.current_phase() == "checkpoint_on_notice"
                else goodput.ledger().phase("checkpoint"))
    t0 = time.monotonic()
    with phase_cm:
        result = _save_sharded_inner(
            path, tree, specs=specs, mesh_axes=mesh_axes,
            process_index=process_index, process_count=process_count,
            meta=meta, wait_timeout_s=wait_timeout_s, save_id=save_id,
            mesh=mesh)
    _observe_save(result, time.monotonic() - t0)
    return result


def _observe_save(result: Dict[str, Any], dt: float) -> None:
    try:
        from ..util.metrics import Gauge, Histogram

        Histogram("rt_train_checkpoint_save_seconds",
                  "Checkpoint payload save/restore duration.",
                  tag_keys=("sharded",)).observe(
            dt, tags={"sharded": "1"})
        Gauge("rt_checkpoint_bytes",
              "Bytes this process wrote into its most recent "
              "checkpoint save.").set(float(result["bytes"]))
        Gauge("rt_checkpoint_shards",
              "Shard files this process wrote into its most recent "
              "checkpoint save.").set(float(result["files"]))
    except Exception:
        pass  # telemetry must never fail a save


def _save_sharded_inner(path: str, tree: Any, *, specs, mesh_axes,
                        process_index, process_count, meta,
                        wait_timeout_s, save_id, mesh) -> Dict[str, Any]:
    final = os.path.abspath(path)
    tmp = final + TMP_SUFFIX
    named = _flatten_named(tree)
    spec_by_name = _spec_map(specs, [n for n, _l in named])

    device_mode = any(_is_dtensor(leaf) for _n, leaf in named)
    coord: Dict[str, int] = {}
    if device_mode:
        import torch.distributed as dist

        if mesh is None:
            mesh = next(leaf.device_mesh for _n, leaf in named
                        if _is_dtensor(leaf))
        if process_index is None:
            process_index, process_count = dist.get_rank(), \
                dist.get_world_size()
        if mesh.size() != process_count:
            raise ValueError(
                f"the mesh {mesh_axis_sizes(mesh)} spans {mesh.size()} of "
                f"{process_count} ranks: pass the full mesh as mesh=")
        mesh_axes = mesh_axes or mesh_axis_sizes(mesh)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    elif process_index is None:
        process_index, process_count = 0, 1
    process_count = process_count or 1
    mesh_axes = dict(mesh_axes or {"data": process_count})
    my_coords = coords_for_rank(mesh_axes, process_index, process_count)

    shard_dir = os.path.join(tmp, f"shard_{process_index}")
    if process_count == 1 and process_index == 0:
        # Single writer: wipe the WHOLE stale staging dir (a crashed
        # attempt at any world size may have left shard dirs there).
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        # Replace only our own stale shard dir; stale peer dirs are
        # rejected at commit by their save_id/world stamp.
        shutil.rmtree(shard_dir, ignore_errors=True)
    os.makedirs(shard_dir, exist_ok=True)

    entries: List[Dict[str, Any]] = []
    leaf_meta: Dict[str, Dict[str, Any]] = {}
    counter = 0
    total_bytes = 0

    from ..parallel.partition_rules import spec_to_json

    for name, leaf in named:
        if _is_dtensor(leaf):
            spec = _dtensor_spec(leaf)
            shape = tuple(int(d) for d in leaf.shape)
            local = leaf.to_local()
            data = _host_array(local, name)
            dtype = data.dtype.name
            ranges = shard_index(shape, spec, mesh_axes, coord)
            if tuple(hi - lo for lo, hi in ranges) != tuple(data.shape):
                raise ValueError(
                    f"leaf {name!r}: local shard {tuple(data.shape)} is "
                    f"not the slice {ranges} of {shape} under {spec}")
            shards = []
            if not replica_id(spec, len(shape), mesh_axes, coord) and \
                    (not shape or all(lo < hi for lo, hi in ranges)):
                shards.append((ranges, data))
        else:
            arr = _host_array(leaf, name)
            if name in spec_by_name:
                spec = spec_by_name[name] or ()
            elif isinstance(specs, dict) and arr.ndim:
                # A leaf missing from an explicit specs dict would fall
                # back to a rank-0 full write: require [] to replicate.
                raise ValueError(
                    f"leaf {name!r} has no entry in the given specs "
                    f"dict — pass an explicit [] (replicate) or a "
                    f"partition spec for every non-scalar host leaf")
            else:
                spec = ()
            for axes in _spec_entries(spec, arr.ndim):
                for a in axes:
                    if a not in mesh_axes:
                        raise ValueError(
                            f"leaf {name!r}: spec names mesh axis "
                            f"{a!r} absent from mesh_axes "
                            f"{sorted(mesh_axes)} — pass mesh_axes "
                            f"covering every spec axis")
            shape = arr.shape
            dtype = arr.dtype.name
            seen = set()
            shards = []
            for c in my_coords:
                if replica_id(spec, arr.ndim, mesh_axes, c):
                    continue
                ranges = shard_index(shape, spec, mesh_axes, c)
                if ranges in seen:
                    continue
                if any(lo >= hi for lo, hi in ranges) and arr.ndim:
                    continue  # empty trailing shard (non-divisor dim)
                seen.add(ranges)
                view = arr[tuple(slice(lo, hi) for lo, hi in ranges)]
                shards.append((ranges, view))
        leaf_meta[name] = {"shape": list(shape), "dtype": dtype,
                           "spec": spec_to_json(spec)}
        for ranges, data in shards:
            fname = f"arr_{counter:05d}.npy"
            counter += 1
            crc, size = _write_array(os.path.join(shard_dir, fname),
                                     np.asarray(data))
            total_bytes += size
            entries.append({
                "leaf": name,
                "file": f"shard_{process_index}/{fname}",
                "index": [list(r) for r in ranges],
                "crc32": crc, "bytes": size,
                "rank": process_index})

    atomic_write(os.path.join(shard_dir, "index.json"),
                 json.dumps({"rank": process_index,
                             "world": process_count,
                             "save_id": save_id,
                             "entries": entries,
                             "leaves": leaf_meta}))
    _fsync_dir(shard_dir)

    committed = False
    if process_index == 0:
        _commit(tmp, final, mesh_axes, process_count, meta,
                wait_timeout_s, save_id)
        committed = True
    return {"path": final, "bytes": total_bytes, "files": counter,
            "committed": committed}


def _read_index(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # mid-replace / vanished: treat as not yet there


def _index_stale(idx: Optional[Dict], world: int,
                 save_id: Optional[str]) -> Optional[str]:
    """Why this shard index cannot belong to the CURRENT save attempt
    (None if it can).  The guard against committing a manifest that
    mixes a SIGKILLed previous attempt's complete-looking indexes with
    the current attempt's shards — their CRCs self-validate, so
    nothing downstream would catch it."""
    if idx is None:
        return "missing"
    if idx.get("world") != world:
        return (f"stale (written at world {idx.get('world')}, "
                f"this save is world {world})")
    if save_id is not None and idx.get("save_id") != save_id:
        return (f"stale (save_id {idx.get('save_id')!r}, this save "
                f"is {save_id!r})")
    return None


def _commit(tmp: str, final: str, mesh_axes: Dict[str, int],
            world: int, meta: Optional[Dict],
            wait_timeout_s: float,
            save_id: Optional[str] = None) -> None:
    """Rank 0's half of the two-phase commit: wait for every rank's
    shard index TO CARRY THE CURRENT ATTEMPT'S STAMP (save_id +
    world — mere existence is not enough: a previous SIGKILLed
    attempt of the same step leaves complete stale indexes in the
    shared staging dir until each rank's re-save replaces its own),
    merge them into the manifest, fsync, rename."""
    deadline = time.monotonic() + wait_timeout_s
    index_paths = [os.path.join(tmp, f"shard_{r}", "index.json")
                   for r in range(world)]
    # An index that validated once cannot turn stale (its rank will
    # not rewrite it within the attempt) — cache acceptances so each
    # poll tick re-reads only the still-pending ranks, not all of
    # them (matters at large world on shared storage).
    accepted: Dict[str, Dict] = {}
    while True:
        pending = {}
        for p in index_paths:
            if p in accepted:
                continue
            idx = _read_index(p)
            why = _index_stale(idx, world, save_id)
            if why is not None:
                pending[p] = why
            else:
                accepted[p] = idx
        if not pending:
            break
        if time.monotonic() > deadline:
            detail = "; ".join(
                f"{os.path.basename(os.path.dirname(p))}: {why}"
                for p, why in pending.items())
            raise TimeoutError(
                f"sharded save: shard index(es) not written by their "
                f"rank for this attempt within {wait_timeout_s}s "
                f"({detail}); NOT committing {final}")
        time.sleep(0.05)

    files: List[Dict] = []
    leaves: Dict[str, Dict] = {}
    for p in index_paths:
        idx = accepted[p]
        files.extend(idx.get("entries", []))
        for name, m in (idx.get("leaves") or {}).items():
            leaves.setdefault(name, m)
    # Leftover shard dirs beyond this save's world (an elastic shrink
    # re-saving over a bigger dead attempt) are not in the manifest —
    # drop them so they don't ride into the committed dir as garbage.
    try:
        for name in os.listdir(tmp):
            if not name.startswith("shard_"):
                continue
            try:
                rank = int(name[len("shard_"):])
            except ValueError:
                continue
            if rank >= world:
                shutil.rmtree(os.path.join(tmp, name),
                              ignore_errors=True)
    except OSError:
        pass
    manifest = {
        "version": FORMAT_VERSION,
        "world_size": world,
        "mesh": {"axes": list(mesh_axes), "shape": dict(mesh_axes)},
        "leaves": leaves,
        "files": files,
        "meta": meta or {},
        "ts": time.time(),
    }
    atomic_write(os.path.join(tmp, MANIFEST), json.dumps(manifest))
    _fsync_dir(tmp)
    if os.path.isdir(final):
        # A committed checkpoint already holds this name (a re-save of
        # the same step after a restart): swap by renaming it aside,
        # then renaming the new copy in.  The aside name keeps the
        # .tmp suffix so a crash mid-swap leaves a directory every
        # reader (is_committed/find_latest_in/scan_run_dir) already
        # ignores, not a stale twin that outsorts the real one.
        # Known window: a crash BETWEEN the two os.replace calls
        # leaves no committed copy under this name — resume falls back
        # to an older committed checkpoint (never corruption), and the
        # good copy survives at the aside name, which scan_run_dir
        # marks ``recoverable`` and ``rt doctor`` tells the operator
        # to rename back.
        old = final + OLD_SUFFIX
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)  # THE commit point
    _fsync_dir(os.path.dirname(final))


# ===================================================================
# restore
# ===================================================================

def _assemble(shape, dtype, ranges, file_entries, base_dir,
              validate: bool, cache: Dict[str, np.ndarray]
              ) -> np.ndarray:
    """Fill a [ranges]-shaped array from the intersections the saved
    files contribute — the reshard read path."""
    out = np.empty([hi - lo for lo, hi in ranges], dtype=dtype)
    inters = []
    for ent in file_entries:
        src_ranges = tuple(tuple(r) for r in ent["index"])
        inter = intersect(ranges, src_ranges)
        if inter is None:
            continue
        fpath = os.path.join(base_dir, ent["file"])
        arr = cache.get(ent["file"])
        if arr is None:
            if not os.path.exists(fpath):
                raise CheckpointCorruptError(
                    f"manifest names missing shard file {fpath}")
            arr = _read_array(
                fpath, ent.get("crc32") if validate else None)
            cache[ent["file"]] = arr
        dst = tuple(slice(lo - r[0], hi - r[0])
                    for (lo, hi), r in zip(inter, ranges))
        src = tuple(slice(lo - r[0], hi - r[0])
                    for (lo, hi), r in zip(inter, src_ranges))
        out[dst] = arr[src]
        inters.append(inter)
    want = int(np.prod([hi - lo for lo, hi in ranges])) if ranges \
        else 1
    # UNION coverage (interval arithmetic), never summed volumes:
    # overlapping saved slices occur exactly in the malformed-manifest
    # cases this backstop exists for, and a sum would let them mask an
    # np.empty-garbage hole.
    filled = covered_elements(ranges, inters)
    if filled < want:
        raise CheckpointCorruptError(
            f"saved shards cover only {filled}/{want} elements of "
            f"requested slice {ranges} — incomplete checkpoint")
    return out


def _np_dtype(name: str, leaf: str) -> np.dtype:
    if name == "bfloat16":
        raise TypeError(_BF16.format(name=leaf))
    try:
        return np.dtype(name)
    except TypeError:
        raise TypeError(f"leaf {leaf!r} has dtype {name!r}, which numpy "
                        "does not know") from None


def load_sharded(path: str, *, mesh=None, specs: Any = None,
                 target: Any = None, validate: bool = True) -> Any:
    """Restore a sharded checkpoint, resharding onto ``mesh``.

    - ``mesh=None``: full host (numpy) arrays.
    - ``mesh`` (a DeviceMesh; every rank of it calls): each leaf becomes
      a DTensor placed by ``specs`` (a tree of PartitionSpecs matching
      the checkpoint's names) or, by default, by the SAVED spec pruned to
      the mesh's axes (``parallel.sharding.spec_placements``).  Each rank
      reads only the slice intersections its shard needs; a spec that
      splits a dim over the replica axes gives each replica group the
      DTensor of its slice, as ``parallel.sharding.distribute`` does.
    - ``target``: return the restored leaves in this tree's structure
      (names must match).

    ``validate`` checks the CRC of every shard file actually read; a
    mismatch raises :class:`CheckpointCorruptError`."""
    from ..util import goodput

    with goodput.timed_phase(
            "checkpoint", "rt_train_checkpoint_restore_seconds",
            "Checkpoint payload save/restore duration.",
            tags={"sharded": "1"}, tag_keys=("sharded",)):
        return _load_sharded_inner(path, mesh=mesh, specs=specs,
                                   target=target, validate=validate)


def _load_sharded_inner(path, *, mesh, specs, target, validate):
    manifest = read_manifest(path)
    by_leaf: Dict[str, List[Dict]] = {}
    for ent in manifest.get("files", []):
        by_leaf.setdefault(ent["leaf"], []).append(ent)
    spec_by_name = _spec_map(specs, list(manifest.get("leaves") or {}))

    restored: Dict[str, Any] = {}
    for name, info in manifest.get("leaves", {}).items():
        shape = tuple(info["shape"])
        dtype = _np_dtype(info["dtype"], name)
        entries = by_leaf.get(name, [])
        cache: Dict[str, np.ndarray] = {}
        if mesh is None:
            restored[name] = _assemble(shape, dtype,
                                       tuple((0, d) for d in shape),
                                       entries, path, validate, cache)
            continue
        spec = spec_by_name.get(name)
        if spec is None:
            from ..parallel.partition_rules import spec_from_json

            spec = spec_from_json(info.get("spec"))
        restored[name] = _place(name, shape, dtype, spec, mesh, entries,
                                path, validate, cache)

    if target is None:
        return _unflatten_named(restored)

    from ..parallel.partition_rules import named_tree_map

    def _pick(name: str, leaf):
        if name not in restored:
            raise CheckpointCorruptError(
                f"checkpoint {path} has no leaf {name!r} the target "
                f"tree expects")
        return restored[name]

    return named_tree_map(_pick, target)


def _place(name, shape, dtype, spec, mesh, entries, path, validate, cache):
    """This rank's DTensor of a leaf under ``spec`` on ``mesh``."""
    import math

    import torch
    from torch.distributed.tensor import DTensor

    from ..parallel.partition_rules import prune_spec
    from ..parallel.sharding import REPLICA_AXES, spec_placements

    sizes = mesh_axis_sizes(mesh)
    spec = prune_spec(spec, sizes)
    sharding = spec_placements(mesh, spec)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    ranges = shard_index(shape, spec, sizes, coord)
    # The replica group's slice: the dims cut by the replica axes only.
    outer = tuple(tuple(a for a in e if a in REPLICA_AXES)
                  for e in _spec_entries(spec, len(shape)))
    group = shard_index(shape, outer, sizes, coord)
    piece = _assemble(shape, dtype, ranges, entries, path, validate, cache)
    local = torch.from_numpy(piece).to(mesh.device_type)
    gshape = tuple(hi - lo for lo, hi in group)
    stride = tuple(math.prod(gshape[i + 1:]) for i in range(len(gshape)))
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=gshape, stride=stride)
