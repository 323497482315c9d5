"""Checkpoint — a directory handle on local storage: counterpart of
``ray_tpu/train/checkpoint.py``.

``Checkpoint`` wraps a directory (copy it out, expose it, read a
sharded checkpoint in it through ``sharded_checkpoint``, keep JSON and
pytree payloads); ``CheckpointManager`` keeps the latest or top-k
checkpoints of a run directory and finds the newest committed one on
resume.  Pytree payloads use flax's msgpack layout
(``util/flax_msgpack.py``), so ``.msgpack`` files move between the two
packages.  Each payload write and read, and the manager's copy of a
checkpoint into the run directory, runs in the goodput ``checkpoint``
phase and observes ``rt_train_checkpoint_{save,restore}_seconds``
(tag ``sharded="0"``), as in the JAX package.

Durability contract (shared with the sharded plane): every write path
stages into a temp name and commits with one ``os.replace``; a
directory counts as a checkpoint only once it carries the commit
marker (or a sharded ``manifest.json``), so ``find_latest_in`` can
never resume from the torn half of a save a SIGKILL interrupted.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np

from ..util.checkpoint_fs import (COMMIT_MARKER,  # noqa: F401
                                  TMP_SUFFIX, atomic_write,
                                  is_committed, mark_committed,
                                  scan_run_dir)


@contextmanager
def _timed_ckpt(metric: str, sharded: bool = False):
    """Attribute checkpoint I/O to the goodput ledger and observe its
    duration histogram (save vs restore, sharded vs blob)."""
    from ..util import goodput

    with goodput.timed_phase(
            "checkpoint", metric,
            "Checkpoint payload save/restore duration.",
            tags={"sharded": "1" if sharded else "0"},
            tag_keys=("sharded",)):
        yield


def _restore_into(target: Any, state: Any) -> Any:
    """flax ``from_state_dict`` for nested dicts, lists and tuples."""
    import torch

    if isinstance(target, dict):
        return {k: _restore_into(v, state[str(k)])
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_restore_into(v, state[str(i)])
                            for i, v in enumerate(target))
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(np.array(state)).to(target.device,
                                                   target.dtype)
    return state


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="rt_ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self):
        yield self.path

    # -- sharded-format bridge -------------------------------------------
    @property
    def is_sharded(self) -> bool:
        from .sharded_checkpoint import is_sharded_checkpoint

        return is_sharded_checkpoint(self.path)

    def load_sharded(self, *, mesh=None, specs=None, target=None,
                     validate: bool = True) -> Any:
        """Restore this (sharded-format) checkpoint, resharding onto
        ``mesh`` — see ``sharded_checkpoint.load_sharded``."""
        from .sharded_checkpoint import load_sharded

        return load_sharded(self.path, mesh=mesh, specs=specs,
                            target=target, validate=validate)

    def manifest_meta(self) -> Dict[str, Any]:
        """User metadata stored in a sharded checkpoint's manifest
        (e.g. the training step), or {} for blob checkpoints."""
        from .sharded_checkpoint import read_manifest

        try:
            return dict(read_manifest(self.path).get("meta") or {})
        except Exception:
            return {}

    # -- pytree payloads in flax's msgpack layout -------------------------
    def save_pytree(self, name: str, tree: Any) -> None:
        """``tree`` (nested dicts/lists/tuples of tensors, arrays and
        scalars) as ``<name>.msgpack`` in flax's layout."""
        from ..util.flax_msgpack import to_bytes

        with _timed_ckpt("rt_train_checkpoint_save_seconds"):
            os.makedirs(self.path, exist_ok=True)
            # Stage + atomic rename: a SIGKILL mid-write must never
            # leave a truncated msgpack under the committed name.
            atomic_write(os.path.join(self.path, name + ".msgpack"),
                         to_bytes(tree))

    def load_pytree(self, name: str, target: Any = None) -> Any:
        """The state dict of ``<name>.msgpack`` (arrays as numpy,
        bfloat16 as a torch tensor), or, with ``target``, its values in
        the target's structure (a tensor leaf of the target gets a
        tensor of its dtype on its device)."""
        from ..util.flax_msgpack import msgpack_restore

        with _timed_ckpt("rt_train_checkpoint_restore_seconds"):
            with open(os.path.join(self.path, name + ".msgpack"),
                      "rb") as f:
                state = msgpack_restore(f.read())
        return state if target is None else _restore_into(target, state)

    def save_json(self, name: str, obj: Dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        atomic_write(os.path.join(self.path, name + ".json"),
                     json.dumps(obj))

    def load_json(self, name: str) -> Dict:
        with open(os.path.join(self.path, name + ".json")) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Keeps the latest/top-k checkpoints in a run directory (ref:
    train/_internal/checkpoint_manager.py)."""

    def __init__(self, run_dir: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        # abspath: entry paths mix copy-path joins and adopted
        # (already-absolute) dirs — the dedup in register() compares
        # them as strings, and a relative run_dir would let one
        # directory get two entries (and _prune rmtree the live one).
        self.run_dir = os.path.abspath(run_dir)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: list = []  # (score, index, path)
        self._index = 0
        os.makedirs(run_dir, exist_ok=True)

    def register(self, source_dir: str,
                 metrics: Optional[Dict] = None) -> Checkpoint:
        source = os.path.abspath(source_dir)
        adopted = self._try_adopt(source)
        if adopted is not None:
            dest, idx = adopted
        else:
            self._index += 1
            idx = self._index
            dest = os.path.join(self.run_dir,
                                f"checkpoint_{idx:06d}")
            with _timed_ckpt("rt_train_checkpoint_save_seconds"):
                # Two-phase: copy into a staging dir, mark it committed,
                # then one atomic rename — a crash mid-copytree leaves
                # only an ignorable *.tmp.
                stage = dest + ".tmp"
                shutil.rmtree(stage, ignore_errors=True)
                shutil.copytree(source, stage)
                mark_committed(stage)
                if os.path.isdir(dest):
                    shutil.rmtree(dest, ignore_errors=True)
                os.replace(stage, dest)
        score = None
        if self.score_attribute and metrics:
            score = metrics.get(self.score_attribute)
        # Re-registering the same adopted dir (a re-save of the same
        # step after an elastic restart) must not leave two entries
        # for one path — _prune would "delete the duplicate" and take
        # the live directory with it.
        self._entries = [e for e in self._entries if e[2] != dest]
        self._entries.append((score, idx, dest))
        self._prune()
        return Checkpoint(dest)

    def _try_adopt(self, source: str):
        """A committed checkpoint already living inside the run dir
        under a ``checkpoint_*`` name (the sharded save writes in
        place — every rank contributed, rank 0 committed) is adopted
        as-is instead of being copied onto itself."""
        if os.path.dirname(source) != os.path.abspath(self.run_dir):
            return None
        name = os.path.basename(source)
        if not name.startswith("checkpoint_") or \
                not is_committed(source):
            return None
        try:
            idx = int(name.split("_", 1)[1])
        except ValueError:
            idx = self._index + 1
        self._index = max(self._index, idx)
        return source, idx

    def _prune(self) -> None:
        if self.num_to_keep is None or \
                len(self._entries) <= self.num_to_keep:
            return
        if self.score_attribute:
            reverse = self.score_order == "max"
            ranked = sorted(
                self._entries,
                key=lambda e: (e[0] is None,
                               -e[0] if (reverse and e[0] is not None)
                               else (e[0] if e[0] is not None else 0)))
        else:
            ranked = sorted(self._entries, key=lambda e: -e[1])
        for _score, _idx, path in ranked[self.num_to_keep:]:
            shutil.rmtree(path, ignore_errors=True)
        self._entries = ranked[: self.num_to_keep]

    def latest(self) -> Optional[Checkpoint]:
        """Newest checkpoint whose directory is still committed on
        disk — an entry that turned torn/missing after registration
        (disk fault, manual surgery) silently falls back to the one
        before it rather than wedging the restart loop."""
        for _score, _idx, path in sorted(self._entries,
                                         key=lambda e: -e[1]):
            if is_committed(path):
                return Checkpoint(path)
        return None

    @staticmethod
    def find_latest_in(run_dir: str) -> Optional[Checkpoint]:
        """Resume support: locate the newest COMMITTED checkpoint_*
        dir on disk — staging (*.tmp) and torn (never-committed) dirs
        are skipped, falling back to the previous committed one, so a
        save killed mid-write can never become the resume point."""
        if not os.path.isdir(run_dir):
            return None
        cands = sorted((d for d in os.listdir(run_dir)
                        if d.startswith("checkpoint_")
                        and not d.endswith(".tmp")), reverse=True)
        for name in cands:
            path = os.path.join(run_dir, name)
            if is_committed(path):
                return Checkpoint(path)
        # Legacy fallback: run dirs written BEFORE the commit-marker
        # discipline carry no marker/manifest anywhere — treating
        # them all as torn would silently resume a pre-upgrade run
        # from step 0.  Only when NOTHING in the dir is committed,
        # accept the newest legacy entry that looks complete (has
        # payload and no half-written *.tmp files inside).  A dir
        # with any committed sibling keeps the strict rule: an
        # uncommitted entry there really is a torn save.  Caveat: a
        # NEW-format first save killed between its per-file atomic
        # writes is indistinguishable from a legacy dir here (no
        # marker, no *.tmp) — so the fallback is logged loudly with
        # the dir name and restore-time validation stays the
        # backstop (`rt checkpoint verify` confirms by hand).
        for name in cands:
            path = os.path.join(run_dir, name)
            try:
                files = os.listdir(path)
            except OSError:
                continue
            if files and not any(f.endswith(TMP_SUFFIX)
                                 for f in files):
                import logging

                logging.getLogger("ray_tpu_torch.train").warning(
                    "no committed checkpoint in %s; resuming from "
                    "uncommitted legacy dir %s (pre-commit-marker "
                    "format assumed — run `rt checkpoint verify %s` "
                    "to confirm it is complete)", run_dir, name, path)
                return Checkpoint(path)
        return None
