"""Sharded crash-atomic checkpoints and the blob checkpoint: the port
(``ray_tpu_torch.train.sharded_checkpoint``/``checkpoint``) against
the JAX package.

The cases of ``tests/test_sharded_checkpoint.py`` that need no runtime,
doctor, telemetry or CLI, run against the port: the rule engine, the
slice math, reshard N -> M for six world pairs, the two-phase commit
and its stale-index rejection, CRC rejection, union coverage, the blob
payloads and the manager.  Across the packages:

- JAX saves ``:239``'s tree on its virtual fsdp4 x tensor2 mesh; the
  port restores it on the host and at world 2 (fsdp2, gloo) as
  DTensors, bit for bit.  The port saves the same tree at world 2 and
  JAX's ``load_sharded`` restores it onto its mesh bit for bit, and
  JAX's ``verify_checkpoint`` accepts it.  A host save writes the same
  files and manifest in both packages.
- The dry-run GPT-2's sharded train state is saved after one step at
  world 2; restored at world 2 it takes the second step bit for bit as
  the uninterrupted run did, and restored at world 1 it holds the same
  bits and takes that step within 1e-4 relative and 1e-5 absolute (a
  world-1 step sums in another order).
- ``save_pytree`` files of either package load in the other, byte for
  byte the same, for float32, int32 and bfloat16 leaves.
- A bfloat16 leaf in a sharded checkpoint raises clearly in the port.
"""

import dataclasses
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.parallel.sharding import PartitionSpec as P
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train import sharded_checkpoint as tsc
from ray_tpu_torch.util import checkpoint_fs as tfs


# ====================================================================
# rule engine
# ====================================================================

def test_match_rules_precedence_scalar_and_default():
    from ray_tpu_torch.parallel.partition_rules import match_partition_rules

    tree = {"a": {"w": np.zeros((4, 4))}, "b": {"w": np.zeros((4, 4))},
            "s": np.float32(1.0)}
    specs = match_partition_rules([("a/w", P("fsdp")), ("w", P("tensor"))],
                                  tree)
    assert specs["a"]["w"] == P("fsdp")
    assert specs["b"]["w"] == P("tensor")
    assert specs["s"] == P()
    with pytest.raises(ValueError, match="b/x"):
        match_partition_rules([("a/w", P("fsdp"))],
                              {"a": {"w": np.zeros((2, 2))},
                               "b": {"x": np.zeros((2, 2))}})
    specs = match_partition_rules(
        [("a/w", P("fsdp"))],
        {"a": {"w": np.zeros((2, 2))}, "b": {"x": np.zeros((2, 2))}},
        default=P())
    assert specs["b"]["x"] == P()


@pytest.mark.parametrize("experts", [0, 4])
def test_gpt2_rules_cover_every_param(experts):
    """Every weight matrix of the port's GPT-2 (MoE blocks included) is
    sharded over fsdp, tensor or expert, and the rule set is the JAX
    package's."""
    from ray_tpu.models.gpt2 import gpt2_partition_rules as jrules
    from ray_tpu_torch.models.gpt2 import (GPT2, GPT2Config,
                                           gpt2_partition_rules)
    from ray_tpu_torch.parallel.partition_rules import match_partition_rules

    assert [(r, tuple(s)) for r, s in gpt2_partition_rules()] == \
        [(r, tuple(s)) for r, s in jrules()]
    cfg = dataclasses.replace(GPT2Config.tiny(), moe_num_experts=experts)
    params = dict(GPT2(cfg, device="cpu").named_parameters())
    assert any("moe_mlp" in n for n in params) == bool(experts)
    specs = match_partition_rules(gpt2_partition_rules(), params)
    for name, leaf in params.items():
        spec = specs[name]
        if leaf.ndim >= 2 and "wpe" not in name:
            flat = [a for e in tuple(spec) if e is not None
                    for a in ((e,) if isinstance(e, str) else e)]
            assert flat, f"{name} is unsharded: {spec}"
            assert set(flat) <= {"fsdp", "tensor", "expert"}, name


def test_llama_rules_cover_every_param():
    from ray_tpu_torch.models.llama import (Llama, LlamaConfig,
                                            llama_partition_rules)
    from ray_tpu_torch.parallel.partition_rules import (_leaves,
                                                        match_partition_rules)

    params = dict(Llama(LlamaConfig.tiny(), device="cpu").named_parameters())
    specs = match_partition_rules(llama_partition_rules(), params)
    assert any(tuple(s) for _p, s in _leaves(specs))


def test_prune_spec_drops_missing_axes():
    from ray_tpu_torch.parallel.partition_rules import prune_spec

    assert prune_spec(P("fsdp", "tensor"), {"fsdp": 2}) == P("fsdp")
    assert prune_spec(P(("fsdp", "tensor"), None),
                      {"fsdp": 2, "tensor": 1}) == P("fsdp")
    assert prune_spec(P("tensor"), {"fsdp": 2}) == P()


# ====================================================================
# pure slice math
# ====================================================================

def test_dim_shard_range_divisor_and_not():
    assert [tsc.dim_shard_range(12, 3, i) for i in range(3)] == \
        [(0, 4), (4, 8), (8, 12)]
    assert [tsc.dim_shard_range(7, 3, i) for i in range(3)] == \
        [(0, 3), (3, 6), (6, 7)]
    assert tsc.dim_shard_range(2, 4, 3) == (2, 2)


def test_shard_index_multi_axis_composition():
    sizes = {"fsdp": 2, "tensor": 2}
    spec = (("fsdp", "tensor"), None)
    got = {(f, t): tsc.shard_index((8, 3), spec, sizes,
                                   {"fsdp": f, "tensor": t})
           for f in range(2) for t in range(2)}
    assert got[(0, 0)] == ((0, 2), (0, 3))
    assert got[(0, 1)] == ((2, 4), (0, 3))
    assert got[(1, 0)] == ((4, 6), (0, 3))
    assert got[(1, 1)] == ((6, 8), (0, 3))


def test_replica_id_and_rank_coords():
    sizes = {"fsdp": 2, "tensor": 2}
    assert tsc.replica_id(("fsdp",), 1, sizes, {"fsdp": 1, "tensor": 0}) == 0
    assert tsc.replica_id(("fsdp",), 1, sizes, {"fsdp": 1, "tensor": 1}) == 1
    assert tsc.replica_id((), 1, sizes, {"fsdp": 0, "tensor": 0}) == 0
    assert tsc.replica_id((), 1, sizes, {"fsdp": 1, "tensor": 0}) != 0
    coords = [c for r in range(2) for c in tsc.coords_for_rank(sizes, r, 2)]
    assert len(coords) == 4
    assert coords[0] == {"fsdp": 0, "tensor": 0}


@pytest.mark.parametrize("n,m", [(4, 2), (2, 4), (3, 2), (2, 3),
                                 (4, 3), (1, 3)])
def test_reshard_n_to_m_bit_identical(tmp_path, n, m):
    rng = np.random.RandomState(7)
    tree = {"w": rng.rand(12, 6).astype(np.float32),
            "k": rng.rand(7, 5).astype(np.float32),
            "b": rng.rand(6).astype(np.float32)}
    specs = {"w": ["fsdp"], "k": ["fsdp"], "b": []}
    path = str(tmp_path / "checkpoint_000001")
    for rank in list(range(1, n)) + [0]:
        tsc.save_sharded(path, tree, specs=specs, mesh_axes={"fsdp": n},
                         process_index=rank, process_count=n)
    out = tsc.load_sharded(path)
    for key in tree:
        assert np.array_equal(out[key], tree[key]), key
    by_leaf = {}
    for ent in tsc.read_manifest(path)["files"]:
        by_leaf.setdefault(ent["leaf"], []).append(ent)
    for key in ("w", "k"):
        for j in range(m):
            ranges = tsc.shard_index(tree[key].shape, ("fsdp",),
                                     {"fsdp": m}, {"fsdp": j})
            if any(lo >= hi for lo, hi in ranges):
                continue
            got = tsc._assemble(tree[key].shape, tree[key].dtype, ranges,
                                by_leaf[key], path, True, {})
            want = tree[key][tuple(slice(lo, hi) for lo, hi in ranges)]
            assert np.array_equal(got, want), (key, j)


# ====================================================================
# commit protocol
# ====================================================================

def test_save_writes_no_rank0_gather(tmp_path):
    rng = np.random.RandomState(0)
    tree = {"w1": rng.rand(64, 32).astype(np.float32),
            "w2": rng.rand(32, 64).astype(np.float32)}
    specs = {"w1": ["fsdp"], "w2": ["fsdp"]}
    total = sum(a.nbytes for a in tree.values())
    path = str(tmp_path / "checkpoint_000003")
    r1 = tsc.save_sharded(path, tree, specs=specs, mesh_axes={"fsdp": 2},
                          process_index=1, process_count=2)
    r0 = tsc.save_sharded(path, tree, specs=specs, mesh_axes={"fsdp": 2},
                          process_index=0, process_count=2)
    assert r0["bytes"] < 0.6 * total and r1["bytes"] < 0.6 * total
    assert r0["bytes"] + r1["bytes"] >= total
    assert r0["committed"] and not r1["committed"]


def test_resave_same_step_leaves_single_committed_dir(tmp_path):
    run = str(tmp_path / "run")
    path = os.path.join(run, "checkpoint_000005")
    tsc.save_sharded(path, {"w": np.zeros((4, 4), np.float32)})
    tsc.save_sharded(path, {"w": np.ones((4, 4), np.float32)})
    assert np.array_equal(tsc.load_sharded(path)["w"],
                          np.ones((4, 4), np.float32))
    assert sorted(os.listdir(run)) == ["checkpoint_000005"]
    latest = tckpt.CheckpointManager.find_latest_in(run)
    assert os.path.basename(latest.path) == "checkpoint_000005"
    mgr = tckpt.CheckpointManager(run, num_to_keep=1)
    mgr.register(path)
    mgr.register(path)
    assert len(mgr._entries) == 1
    assert os.path.isdir(path)


def test_commit_rejects_stale_indexes_from_dead_attempt(tmp_path):
    path = str(tmp_path / "checkpoint_000005")
    tree_a = {"w": np.zeros((8, 4), np.float32)}
    tree_b = {"w": np.ones((8, 4), np.float32)}
    kw = dict(specs={"w": ["fsdp"]}, mesh_axes={"fsdp": 2}, process_count=2)
    tsc.save_sharded(path, tree_a, process_index=1, save_id="5:a", **kw)
    assert os.path.isfile(os.path.join(path + ".tmp", "shard_1",
                                       "index.json"))
    with pytest.raises(TimeoutError, match="save_id"):
        tsc.save_sharded(path, tree_b, process_index=0, save_id="5:b",
                         wait_timeout_s=0.4, **kw)
    assert not os.path.isdir(path)
    tsc.save_sharded(path, tree_b, process_index=1, save_id="5:b", **kw)
    tsc.save_sharded(path, tree_b, process_index=0, save_id="5:b", **kw)
    assert np.array_equal(tsc.load_sharded(path)["w"], tree_b["w"])


def test_commit_rejects_stale_world_size_indexes(tmp_path):
    path = str(tmp_path / "checkpoint_000006")
    tree_a = {"w": np.zeros((8, 4), np.float32)}
    tree_b = {"w": np.full((8, 4), 2.0, np.float32)}
    specs = {"w": ["fsdp"]}
    for r in (1, 2, 3):
        tsc.save_sharded(path, tree_a, specs=specs, mesh_axes={"fsdp": 4},
                         process_index=r, process_count=4)
    with pytest.raises(TimeoutError, match="world"):
        tsc.save_sharded(path, tree_b, specs=specs, mesh_axes={"fsdp": 2},
                         process_index=0, process_count=2,
                         wait_timeout_s=0.4)
    assert not os.path.isdir(path)
    for r in (1, 0):
        tsc.save_sharded(path, tree_b, specs=specs, mesh_axes={"fsdp": 2},
                         process_index=r, process_count=2)
    assert np.array_equal(tsc.load_sharded(path)["w"], tree_b["w"])
    assert sorted(d for d in os.listdir(path) if d.startswith("shard_")) \
        == ["shard_0", "shard_1"]


def test_single_writer_resave_wipes_stale_staging(tmp_path):
    path = str(tmp_path / "checkpoint_000007")
    tsc.save_sharded(path, {"w": np.zeros((8, 4), np.float32)},
                     specs={"w": ["fsdp"]}, mesh_axes={"fsdp": 2},
                     process_index=1, process_count=2, save_id="7:dead")
    fresh = {"w": np.full((8, 4), 3.0, np.float32)}
    tsc.save_sharded(path, fresh)
    assert np.array_equal(tsc.load_sharded(path)["w"], fresh["w"])
    assert sorted(d for d in os.listdir(path) if d.startswith("shard_")) \
        == ["shard_0"]


def test_host_save_rejects_unknown_spec_axis(tmp_path):
    with pytest.raises(ValueError, match="fsdp"):
        tsc.save_sharded(str(tmp_path / "checkpoint_000001"),
                         {"w": np.ones((4, 4), np.float32)},
                         specs={"w": ["fsdp"]}, mesh_axes={"data": 2},
                         process_count=2)


def test_explicit_specs_must_cover_every_host_leaf(tmp_path):
    tree = {"w": np.ones((4, 4), np.float32), "b": np.ones((4,), np.float32)}
    path = str(tmp_path / "checkpoint_000001")
    with pytest.raises(ValueError, match="'b'"):
        tsc.save_sharded(path, tree, specs={"w": ["fsdp"], "B": []},
                         mesh_axes={"fsdp": 2}, process_index=0,
                         process_count=2, save_id="x", wait_timeout_s=0.1)
    tsc.save_sharded(path, tree, specs={"w": ["fsdp"], "b": None},
                     mesh_axes={"fsdp": 1})
    tsc.save_sharded(str(tmp_path / "checkpoint_000002"), tree)


def test_scan_live_staging_uses_shard_subdir_mtime(tmp_path):
    """A live multi-rank save touches only shard_*/ subdirs: the scan
    reports their fresh mtime, not the frozen parent's."""
    run = str(tmp_path / "run")
    staging = os.path.join(run, "checkpoint_000001.tmp")
    shard = os.path.join(staging, "shard_0")
    os.makedirs(shard)
    past = time.time() - 600
    os.utime(staging, (past, past))
    (entry,) = tfs.scan_run_dir(run)
    assert entry["tmp"] and not entry["committed"]
    assert entry["mtime"] > time.time() - 60
    os.utime(shard, (past, past))
    os.utime(staging, (past, past))
    (entry,) = tfs.scan_run_dir(run)
    assert entry["mtime"] == pytest.approx(past, abs=1)


def test_find_latest_legacy_dirs_without_markers(tmp_path):
    run = str(tmp_path / "legacy")
    for i in (1, 2):
        d = os.path.join(run, f"checkpoint_{i:06d}")
        os.makedirs(d)
        open(os.path.join(d, "model.msgpack"), "wb").write(b"x")
    latest = tckpt.CheckpointManager.find_latest_in(run)
    assert os.path.basename(latest.path) == "checkpoint_000002"
    torn = os.path.join(run, "checkpoint_000003")
    os.makedirs(torn)
    open(os.path.join(torn, "model.msgpack.tmp"), "wb").write(b"x")
    latest = tckpt.CheckpointManager.find_latest_in(run)
    assert os.path.basename(latest.path) == "checkpoint_000002"


def test_manifest_checksum_rejection(tmp_path):
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    path = str(tmp_path / "checkpoint_000004")
    tsc.save_sharded(path, tree, specs={"w": ["fsdp"]},
                     mesh_axes={"fsdp": 2})
    assert tfs.verify_checkpoint(path)["ok"]
    f = sorted(glob.glob(os.path.join(path, "shard_0", "*.npy")))[0]
    blob = bytearray(open(f, "rb").read())
    blob[-1] ^= 0xFF
    open(f, "wb").write(bytes(blob))
    with pytest.raises(tsc.CheckpointCorruptError, match="checksum"):
        tsc.load_sharded(path)
    report = tfs.verify_checkpoint(path)
    assert not report["ok"]
    assert any("checksum" in e for e in report["errors"])
    tsc.load_sharded(path, validate=False)
    os.remove(f)
    report = tfs.verify_checkpoint(path)
    assert any("missing" in e for e in report["errors"])


# ====================================================================
# blob checkpoints and the manager
# ====================================================================

def test_save_pytree_atomic_and_json_atomic(tmp_path):
    c = tckpt.Checkpoint(str(tmp_path / "c1"))
    c.save_pytree("model", {"w": np.ones((4,), np.float32)})
    c.save_json("meta", {"step": 3})
    assert sorted(os.listdir(c.path)) == ["meta.json", "model.msgpack"]
    assert np.array_equal(c.load_pytree("model")["w"],
                          np.ones((4,), np.float32))
    assert c.load_json("meta") == {"step": 3}
    target = {"w": torch.zeros(4, dtype=torch.float64)}
    out = c.load_pytree("model", target=target)
    assert out["w"].dtype == torch.float64 and out["w"].sum() == 4


def test_manager_register_stages_and_marks_committed(tmp_path):
    run, src = str(tmp_path / "run"), str(tmp_path / "src")
    tckpt.Checkpoint(src).save_json("meta", {"step": 1})
    mgr = tckpt.CheckpointManager(run)
    ckpt = mgr.register(src)
    assert os.path.basename(ckpt.path) == "checkpoint_000001"
    assert tckpt.is_committed(ckpt.path)
    assert not os.path.exists(ckpt.path + ".tmp")
    assert mgr.latest().path == ckpt.path


def test_find_latest_skips_torn_and_staging_dirs(tmp_path):
    import shutil

    run = str(tmp_path / "run")
    os.makedirs(run)
    tsc.save_sharded(os.path.join(run, "checkpoint_000001"),
                     {"w": np.ones((4, 4), np.float32)})
    torn = os.path.join(run, "checkpoint_000002")
    os.makedirs(torn)
    tckpt.Checkpoint(torn).save_pytree("model",
                                       {"w": np.zeros((4, 4), np.float32)})
    os.remove(os.path.join(torn, "model.msgpack"))
    open(os.path.join(torn, "model.msgpack.tmp"), "wb").write(b"x")
    os.makedirs(os.path.join(run, "checkpoint_000003.tmp", "shard_0"))
    latest = tckpt.CheckpointManager.find_latest_in(run)
    assert os.path.basename(latest.path) == "checkpoint_000001"
    assert latest.is_sharded
    mgr = tckpt.CheckpointManager(str(tmp_path / "run2"))
    src = str(tmp_path / "src")
    tckpt.Checkpoint(src).save_json("meta", {"step": 1})
    first = mgr.register(src)
    second = mgr.register(src)
    shutil.rmtree(second.path)
    assert mgr.latest().path == first.path


def test_manager_adopts_committed_in_run_dir(tmp_path):
    run = str(tmp_path / "run")
    mgr = tckpt.CheckpointManager(run)
    path = os.path.join(run, "checkpoint_000007")
    tsc.save_sharded(path, {"w": np.ones((2, 2), np.float32)},
                     meta={"step": 7})
    ckpt = mgr.register(path)
    assert ckpt.path == os.path.abspath(path)
    assert mgr.latest().path == ckpt.path
    assert ckpt.manifest_meta()["step"] == 7
    out = ckpt.load_sharded()
    assert np.array_equal(out["w"], np.ones((2, 2), np.float32))
    src = str(tmp_path / "src")
    tckpt.Checkpoint(src).save_json("meta", {})
    assert os.path.basename(mgr.register(src).path) == "checkpoint_000008"


def test_covered_elements_union_not_sum():
    t = ((0, 4), (0, 4))
    assert tfs.covered_elements(t, [((0, 3), (0, 4)), ((1, 4), (0, 4))]) \
        == 16
    assert tfs.covered_elements(t, [((0, 2), (0, 4)), ((0, 2), (0, 4))]) \
        == 8
    assert tfs.covered_elements(((1, 3),), [((0, 10),)]) == 2
    assert tfs.covered_elements(((0, 4),), []) == 0
    assert tfs.covered_elements((), [()]) == 1
    assert tfs.covered_elements((), []) == 0


def test_overlapping_slices_never_mask_a_gap(tmp_path):
    path = str(tmp_path / "checkpoint_000008")
    tsc.save_sharded(path, {"w": np.arange(8, dtype=np.float32)},
                     specs={"w": ["fsdp"]}, mesh_axes={"fsdp": 2})
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    ents = [e for e in manifest["files"] if e["leaf"] == "w"]
    assert [e["index"] for e in ents] == [[[0, 4]], [[4, 8]]]
    ents[1].update(ents[0])
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(tsc.CheckpointCorruptError, match="cover"):
        tsc.load_sharded(path)
    assert any("cover" in e for e in tfs.verify_checkpoint(path)["errors"])


# ====================================================================
# across the packages
# ====================================================================

def _tree():
    """``tests/test_sharded_checkpoint.py:239``'s tree."""
    rng = np.random.RandomState(3)
    return {"w": rng.rand(8, 6).astype(np.float32),
            "b": rng.rand(6).astype(np.float32)}


def test_host_save_writes_the_jax_packages_files(tmp_path):
    """The same host tree and specs at world 2: the same shard files,
    bytes and CRCs, and the same manifest (less its timestamp)."""
    from ray_tpu.train import sharded_checkpoint as jsc

    tree = {**_tree(), "step": 3}
    specs = {"w": ["fsdp"], "b": []}
    out = {}
    for name, mod in (("port", tsc), ("jax", jsc)):
        path = str(tmp_path / name / "checkpoint_000001")
        for r in (1, 0):
            mod.save_sharded(path, tree, specs=specs, mesh_axes={"fsdp": 2},
                             process_index=r, process_count=2, save_id="s",
                             meta={"step": 3})
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        manifest.pop("ts")
        files = {f: open(os.path.join(path, f), "rb").read() for f in
                 sorted(os.path.relpath(p, path) for p in
                        glob.glob(os.path.join(path, "shard_*", "*.npy")))}
        out[name] = (manifest, files)
    assert out["port"] == out["jax"]


def test_bfloat16_leaves_raise_clearly(tmp_path):
    """The JAX package writes a bfloat16 leaf as a raw |V2 array that
    no restore can read; the port refuses both ways."""
    import ml_dtypes

    from ray_tpu.train import sharded_checkpoint as jsc

    with pytest.raises(TypeError, match="bfloat16"):
        tsc.save_sharded(str(tmp_path / "a"),
                         {"w": torch.ones(2, dtype=torch.bfloat16)})
    path = str(tmp_path / "b")
    jsc.save_sharded(path, {"w": np.ones(2, ml_dtypes.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        tsc.load_sharded(path)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_pytree_files_load_in_the_other_package(tmp_path, writer):
    import jax.numpy as jnp

    from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    i32 = rng.integers(-5, 5, (5,)).astype(np.int32)
    bf = rng.standard_normal((2, 3)).astype(np.float32)
    jtree = {"f": f32, "i": i32, "h": jnp.asarray(bf, jnp.bfloat16),
             "n": {"step": 7}}
    ttree = {"f": torch.from_numpy(f32), "i": torch.from_numpy(i32),
             "h": torch.from_numpy(bf).bfloat16(), "n": {"step": 7}}
    jc = JCheckpoint(str(tmp_path / "jax"))
    tc = tckpt.Checkpoint(str(tmp_path / "port"))
    jc.save_pytree("model", jtree)
    tc.save_pytree("model", ttree)
    jbytes = open(os.path.join(jc.path, "model.msgpack"), "rb").read()
    assert open(os.path.join(tc.path, "model.msgpack"), "rb").read() == \
        jbytes
    src = tc if writer == "port" else jc
    dst = tckpt.Checkpoint(src.path) if writer == "jax" else \
        JCheckpoint(src.path)
    got = dst.load_pytree("model")
    assert np.array_equal(np.asarray(got["f"]), f32)
    assert np.array_equal(np.asarray(got["i"]), i32)
    assert np.asarray(got["i"]).dtype == np.int32
    h = got["h"]
    h = h.float().numpy() if isinstance(h, torch.Tensor) else \
        np.asarray(h, np.float32)
    assert np.array_equal(h, torch.from_numpy(bf).bfloat16().float().numpy())
    assert int(got["n"]["step"]) == 7


DRYRUN_CFG = dict(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                  d_ff=256, max_seq=64, remat=True)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """JAX saves the tree on fsdp4 x tensor2; two spawned gloo ranks
    restore it, save the tree themselves, and checkpoint a train state
    (``ray_tpu_torch.testing.checkpoint_cases``)."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.train import sharded_checkpoint as jsc
    from ray_tpu_torch.dryrun import spawn
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.testing import checkpoint_cases

    work = tmp_path_factory.mktemp("ckpt")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("fsdp", "tensor"))
    tree = _tree()
    jax_dir = str(work / "jax_tree")
    jsc.save_sharded(jax_dir, {
        "w": jax.device_put(tree["w"], NamedSharding(mesh, JP("fsdp",
                                                              "tensor"))),
        "b": jax.device_put(tree["b"], NamedSharding(mesh, JP()))})
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 512, (4, 65)).astype(np.int64)
               for _ in range(2)]
    cfg = GPT2Config(**DRYRUN_CFG, dtype=torch.float32)
    runs = spawn(checkpoint_cases, 2, jax_dir, str(work), tree, cfg, batches,
                 timeout=300, workdir=str(work))
    return work, tree, mesh, cfg, batches, runs


def test_port_restores_a_jax_checkpoint_on_the_host(world2):
    work, tree, *_ = world2
    out = tsc.load_sharded(str(work / "jax_tree"))
    for key in tree:
        assert isinstance(out[key], np.ndarray)
        assert np.array_equal(out[key], tree[key]), key


def test_port_restores_a_jax_checkpoint_on_dtensors(world2):
    """Saved on fsdp4 x tensor2, restored at fsdp2: the saved spec
    (fsdp, tensor) prunes to (fsdp,), each rank holds its rows."""
    _work, tree, _mesh, _cfg, _b, runs = world2
    for rank, run in enumerate(runs):
        restored = run[0]
        full, local, placements = restored["w"]
        assert np.array_equal(full, tree["w"])
        assert np.array_equal(local, tree["w"][rank * 4:(rank + 1) * 4])
        assert placements == "(Shard(dim=0),)"
        full, local, placements = restored["b"]
        assert np.array_equal(full, tree["b"])
        assert np.array_equal(local, tree["b"])
        assert placements == "(Replicate(),)"


def test_jax_restores_and_verifies_a_port_checkpoint(world2):
    import jax
    from jax.sharding import PartitionSpec as JP

    from ray_tpu.train import sharded_checkpoint as jsc
    from ray_tpu.util.checkpoint_fs import verify_checkpoint

    work, tree, mesh, *_ = world2
    path = str(work / "port_tree")
    report = verify_checkpoint(path)
    assert report["ok"], report
    assert report["world_size"] == 2
    out = jsc.load_sharded(path, mesh=mesh)
    assert out["w"].sharding.spec == JP("fsdp")
    for key in tree:
        assert np.array_equal(np.asarray(out[key]), tree[key]), key
    host = jsc.load_sharded(path)
    for key in tree:
        assert np.array_equal(host[key], tree[key]), key
    manifest = tsc.read_manifest(path)
    assert manifest["mesh"]["shape"]["fsdp"] == 2
    assert manifest["leaves"]["w"]["spec"] == ["fsdp"]
    del jax


def test_train_state_restored_at_world_2_steps_on_bit_for_bit(world2):
    from ray_tpu_torch.models.convert import gpt2_params_from_numpy

    *_, runs = world2
    for _restored, _after1, straight, resumed, kept, step in runs:
        assert kept and step == 2
        assert resumed[0] == straight[0]
        want = gpt2_params_from_numpy(straight[1])
        got = gpt2_params_from_numpy(resumed[1])
        assert sorted(got) == sorted(want)
        for name, value in got.items():
            assert torch.equal(value, want[name]), name


def test_train_state_restored_on_the_host_and_at_world_1(world2, tmp_path):
    """The checkpoint on the host gives the state after step 1 bit for
    bit; placed at world 1 it takes step 2 as the world-2 run did."""
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.convert import gpt2_params_from_numpy
    from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from ray_tpu_torch.train import distributed, train_step

    work, _tree_, _mesh, cfg, batches, runs = world2
    path = str(work / "state")
    after1 = runs[0][1]
    host = tsc.load_sharded(path)
    assert int(host["step"]) == 1 and int(host["opt_state"]["count"]) == 1
    state = train_step.TrainState.create(
        gpt2.GPT2(cfg, device="cpu"), train_step.make_optimizer(
            total_steps=10, warmup_steps=2))
    distributed.restore_train_state(state, host)
    for name, p in state.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), after1[name]), name
    assert tckpt.Checkpoint(path).manifest_meta() == {"step": 1}

    col.init_collective_group(1, 0, backend="cpu", group_name="gang",
                              init_method=f"file://{tmp_path}/store")
    try:
        mesh = create_mesh(MeshSpec(), device="cpu")
        wcfg = dataclasses.replace(cfg, mesh=mesh)
        opt = train_step.make_optimizer(total_steps=10, warmup_steps=2)
        state = train_step.shard_state(train_step.TrainState.create(
            gpt2.GPT2(wcfg, device="cpu"), opt), mesh, gpt2.gpt2_param_axes)
        distributed.restore_train_state(state, tsc.load_sharded(path,
                                                                mesh=mesh))
        for name, p in state.model.named_parameters():
            assert np.array_equal(p.full_tensor().detach().numpy(),
                                  after1[name]), name
        step = train_step.make_sharded_train_step(
            lambda m, b: gpt2.gpt2_loss_fn(wcfg, m, b), opt, mesh)
        from ray_tpu_torch.parallel.sharding import distribute, \
            logical_sharding
        tokens = distribute(torch.from_numpy(batches[1]),
                            logical_sharding(mesh, ("batch", None)))
        _, m = step(state, {"tokens": tokens})
        loss, want = runs[0][2]
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-4, abs=1e-5)
        want = gpt2_params_from_numpy(want)
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(p.full_tensor().detach().numpy(),
                                       want[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    finally:
        col.destroy_collective_group("gang")
