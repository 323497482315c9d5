"""Checkpoint on-disk format primitives: the port's copy of
``ray_tpu/util/checkpoint_fs.py`` (the port imports nothing of the JAX
package, not even its jax-free modules).  The constants, the manifest
schema and the commit protocol are the JAX package's, so a checkpoint
either package writes is read by the other.

The commit protocol and manifest format shared by the blob
(``train/checkpoint.py``) and sharded (``train/sharded_checkpoint.py``)
checkpoint planes.

Commit protocol: a directory is a checkpoint iff it carries the
commit marker or a sharded ``manifest.json`` — both are written LAST,
after every payload byte is fsynced, and the whole directory arrives
under its final name via one ``os.replace``.  Anything else
(``*.tmp`` staging dirs, marker-less dirs) is a torn save restore
must skip.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from typing import Any, Dict, List, Optional

MANIFEST = "manifest.json"
COMMIT_MARKER = ".rt_committed"
TMP_SUFFIX = ".tmp"
# A re-save of an already-committed name renames the old copy aside
# under this suffix for the instant of the swap (see _commit in
# train/sharded_checkpoint.py).  It still ends in TMP_SUFFIX so every
# reader ignores it, but the scan/doctor distinguish it: if a crash
# hit the swap window, the aside copy is the only good one and an
# operator can rename it back.
OLD_SUFFIX = ".old" + TMP_SUFFIX
FORMAT_VERSION = 1


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint failed validation (bad checksum, missing
    shard file, malformed manifest) — the caller should fall back to an
    earlier committed checkpoint rather than trust this one."""


class CheckpointNotCommittedError(RuntimeError):
    """The directory has no manifest — an uncommitted/torn save."""


def crc32_hex(data: bytes) -> str:
    return format(zlib.crc32(data) & 0xFFFFFFFF, "08x")


def covered_elements(target, boxes) -> int:
    """Exact number of elements of the per-dim ``[lo, hi)`` box
    ``target`` covered by the UNION of ``boxes`` — interval arithmetic
    via coordinate compression, so overlapping boxes never double
    count.  This is the restore-time completeness backstop: a summed
    per-box volume can mask an uncovered hole exactly in the
    malformed-manifest cases (mixed save attempts, duplicated slices)
    where overlaps occur."""
    import bisect
    import itertools

    ndim = len(target)
    clipped = []
    for box in boxes:
        if len(box) != ndim:
            continue
        c = []
        for (lo, hi), (tlo, thi) in zip(box, target):
            lo, hi = max(int(lo), int(tlo)), min(int(hi), int(thi))
            if lo >= hi:
                break
            c.append((lo, hi))
        else:
            clipped.append(tuple(c))
    if ndim == 0:
        return 1 if clipped else 0
    if not clipped:
        return 0
    edges = []
    for d in range(ndim):
        es = {int(target[d][0]), int(target[d][1])}
        for c in clipped:
            es.update(c[d])
        edges.append(sorted(es))
    cells = set()
    for c in clipped:
        cells.update(itertools.product(*(
            range(bisect.bisect_left(edges[d], c[d][0]),
                  bisect.bisect_left(edges[d], c[d][1]))
            for d in range(ndim))))
    total = 0
    for cell in cells:
        vol = 1
        for d, i in enumerate(cell):
            vol *= edges[d][i + 1] - edges[d][i]
        total += vol
    return total


def atomic_write(path: str, data) -> None:
    """THE durable-write primitive of the checkpoint planes: stage
    into ``path + ".tmp"``, flush + fsync, then one ``os.replace``.
    Every commit-critical file (payloads, shard indexes, manifests,
    markers) goes through here so the discipline lives — and gets
    fixed — in exactly one place.  ``data``: bytes or str."""
    mode = "wb" if isinstance(data, (bytes, bytearray)) else "w"
    with open(path + TMP_SUFFIX, mode) as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + TMP_SUFFIX, path)


def mark_committed(path: str) -> None:
    """Write the commit marker into a fully-staged checkpoint dir."""
    atomic_write(os.path.join(path, COMMIT_MARKER), "1")


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST))


def is_committed(path: str) -> bool:
    """A directory restore may trust: carries the commit marker or a
    sharded manifest, and is not a staging (*.tmp) dir."""
    if not os.path.isdir(path) or \
            path.rstrip(os.sep).endswith(TMP_SUFFIX):
        return False
    return os.path.isfile(os.path.join(path, COMMIT_MARKER)) or \
        is_sharded_checkpoint(path)


def read_manifest(path: str) -> Dict[str, Any]:
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise CheckpointNotCommittedError(
            f"{path} has no {MANIFEST} — an uncommitted or torn "
            f"checkpoint directory")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {path}: {e}") from e


def scan_run_dir(run_dir: str) -> List[Dict[str, Any]]:
    """Inventory every checkpoint_* entry in a run directory —
    committed, torn (dir present but never committed), staging
    (*.tmp), or an aside copy from a re-save swap (*.old.tmp) — for
    ``rt doctor``'s checkpoint-risk finding and the torn-write chaos
    tooling.

    ``*.old.tmp`` entries additionally carry ``recoverable`` (the
    aside copy's CONTENT is a committed checkpoint: manifest or commit
    marker present) and ``final`` (the name it was renamed aside
    from).  When ``recoverable`` is set and ``final`` is absent, a
    crash hit the re-save swap window and the aside copy is the only
    good copy of that step — rename it back to recover."""
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(run_dir):
        return out
    for name in sorted(os.listdir(run_dir)):
        if not name.startswith("checkpoint_"):
            continue
        path = os.path.join(run_dir, name)
        if not os.path.isdir(path):
            continue
        tmp = name.endswith(TMP_SUFFIX)
        committed = not tmp and is_committed(path)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            mtime = 0.0
        # A live multi-rank save touches only shard_*/ subdirs after
        # creating them — the parent staging dir's mtime freezes at
        # creation.  Take the freshest so an in-flight save longer
        # than the stale-staging window is not misreported as
        # abandoned (whose probe suggests deleting it mid-save).
        # Staging entries only: committed dirs feed no age check, and
        # statting every shard of every committed checkpoint would
        # tax shared filesystems on each doctor poll.
        if tmp:
            try:
                for sub in os.listdir(path):
                    sp = os.path.join(path, sub)
                    if os.path.isdir(sp):
                        mtime = max(mtime, os.path.getmtime(sp))
            except OSError:
                pass
        entry = {"name": name, "path": path, "tmp": tmp,
                 "committed": committed,
                 "torn": not tmp and not committed,
                 "old": name.endswith(OLD_SUFFIX),
                 "mtime": mtime}
        if entry["old"]:
            entry["final"] = name[:-len(OLD_SUFFIX)]
            entry["recoverable"] = (
                os.path.isfile(os.path.join(path, MANIFEST))
                or os.path.isfile(os.path.join(path, COMMIT_MARKER)))
        out.append(entry)
    return out


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Full integrity report for one checkpoint directory: commit
    status, manifest sanity, every shard file present with a matching
    CRC, and every leaf fully covered by its saved slices.  Powers
    ``rt checkpoint verify`` and the restore-time fallback decision."""
    path = os.path.abspath(path)
    report: Dict[str, Any] = {
        "path": path, "ok": False, "committed": False,
        "sharded": False, "errors": [], "leaves": 0, "files": 0,
        "bytes": 0,
    }
    if not os.path.isdir(path):
        report["errors"].append("not a directory")
        return report
    if path.endswith(OLD_SUFFIX):
        # Aside copy from a re-save swap: readers ignore it, but the
        # doctor's recoverable-checkpoint probe sends the operator
        # HERE to decide whether to rename it back — verify its
        # CONTENT instead of short-circuiting on the .tmp suffix.
        report["aside"] = True
    elif path.endswith(TMP_SUFFIX):
        report["errors"].append(
            "uncommitted staging directory (*.tmp) — a save was "
            "interrupted before its commit rename")
        return report
    if not is_sharded_checkpoint(path):
        if os.path.isfile(os.path.join(path, COMMIT_MARKER)):
            report.update(ok=True, committed=True)
            report["files"] = sum(len(fs) for _, _, fs
                                  in os.walk(path))
            return report
        report["errors"].append(
            f"no {MANIFEST} or commit marker — torn/uncommitted "
            f"checkpoint directory")
        return report
    report["sharded"] = True
    try:
        manifest = read_manifest(path)
    except (CheckpointCorruptError,
            CheckpointNotCommittedError) as e:
        report["errors"].append(str(e))
        return report
    report["committed"] = True
    report["world_size"] = manifest.get("world_size")
    report["mesh"] = (manifest.get("mesh") or {}).get("shape")
    report["leaves"] = len(manifest.get("leaves") or {})
    boxes: Dict[str, List] = {}
    for ent in manifest.get("files", []):
        report["files"] += 1
        fpath = os.path.join(path, ent["file"])
        if not os.path.exists(fpath):
            report["errors"].append(f"missing shard file "
                                    f"{ent['file']}")
            continue
        try:
            # Chunked CRC: shard files can be multi-GB; never hold a
            # full serialization in memory just to checksum it.
            crc_acc, nbytes = 0, 0
            with open(fpath, "rb") as f:
                while True:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        break
                    crc_acc = zlib.crc32(chunk, crc_acc)
                    nbytes += len(chunk)
        except OSError as e:
            report["errors"].append(f"unreadable {ent['file']}: {e}")
            continue
        report["bytes"] += nbytes
        crc = format(crc_acc & 0xFFFFFFFF, "08x")
        if crc != ent.get("crc32"):
            report["errors"].append(
                f"checksum mismatch in {ent['file']} "
                f"(manifest {ent.get('crc32')}, file {crc})")
        boxes.setdefault(ent["leaf"], []).append(
            tuple(tuple(r) for r in ent.get("index", [])))
    for name, info in (manifest.get("leaves") or {}).items():
        shape = info.get("shape") or []
        want = max(math.prod(shape), 1)
        # Union coverage, not summed volumes: replicated/overlapping
        # slices must not mask an uncovered hole (the exact
        # malformed-manifest case this backstop exists for).
        got = covered_elements(tuple((0, d) for d in shape),
                               boxes.get(name, []))
        if got < want:
            report["errors"].append(
                f"leaf {name!r}: saved slices cover "
                f"{got}/{want} elements")
    report["ok"] = not report["errors"]
    return report
