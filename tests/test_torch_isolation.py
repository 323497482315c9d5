"""The port stands alone: no JAX and nothing of the JAX package.

``ray_tpu_torch``, ``chip_smoke.py``, ``tools/telemetry_spread.py`` and
the card tests (run where JAX is not installed) import ``torch`` and
numpy, never ``jax``/``flax``/``optax`` nor ``ray_tpu`` (a name that ``ray_tpu_torch`` itself starts with, so the
check matches whole dotted prefixes), nor ``msgpack`` (the card machine
lacks it; the port keeps its own codec for flax's layout).  Entry
points called without a device run on CUDA or raise.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ray_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "msgpack")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_matches_whole_prefixes():
    assert _forbidden("ray_tpu") and _forbidden("ray_tpu.ops.moe")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("ray_tpu_torch") and not _forbidden("jaxtyping")


@pytest.mark.parametrize("target", ["ray_tpu_torch", "chip_smoke.py",
                                    "tools/telemetry_spread.py",
                                    "tests/test_torch_cuda.py"])
def test_sources_import_nothing_of_jax_or_ray_tpu(target):
    files = sorted(PKG.rglob("*.py")) if target == "ray_tpu_torch" \
        else [ROOT / target]
    assert files
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if _forbidden(m)]
    assert bad == []


def test_import_adds_no_jax_or_ray_tpu_module():
    """Checked as a delta in a fresh interpreter: the image may preload
    jax before any test code runs."""
    code = (
        "import sys\n"
        f"bad = lambda: {{m for m in sys.modules if any(m == f or "
        f"m.startswith(f + '.') for f in {FORBIDDEN!r})}}\n"
        "before = bad()\n"
        "import ray_tpu_torch, ray_tpu_torch.device\n"
        "import ray_tpu_torch.ops, ray_tpu_torch.ops.flash_attention\n"
        "import ray_tpu_torch.models.gpt2, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.models.llama, ray_tpu_torch.train.train_step\n"
        "import ray_tpu_torch.llm, ray_tpu_torch.llm.engine\n"
        "import ray_tpu_torch.llm.kv_cache, ray_tpu_torch.llm.sampling\n"
        "import ray_tpu_torch.llm.serving\n"
        "import ray_tpu_torch.collective, ray_tpu_torch.dryrun\n"
        "import ray_tpu_torch.collective.collective_group.cpu_group\n"
        "import ray_tpu_torch.collective.collective_group.nccl_group\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.mesh\n"
        "import ray_tpu_torch.parallel.sharding\n"
        "import ray_tpu_torch.parallel.partition_rules\n"
        "import ray_tpu_torch.parallel.ring_attention\n"
        "import ray_tpu_torch.parallel.ulysses, ray_tpu_torch.testing\n"
        "import ray_tpu_torch.train.distributed\n"
        "import ray_tpu_torch.ops.moe, ray_tpu_torch.parallel.pipeline\n"
        "import ray_tpu_torch.parallel.grad_collectives\n"
        "import ray_tpu_torch.util.checkpoint_fs\n"
        "import ray_tpu_torch.util.flax_msgpack\n"
        "import ray_tpu_torch.train.sharded_checkpoint\n"
        "import ray_tpu_torch.train.checkpoint\n"
        "import ray_tpu_torch.util.metrics, ray_tpu_torch.util.spans\n"
        "import ray_tpu_torch.util.flight_recorder\n"
        "import ray_tpu_torch.util.tracing, ray_tpu_torch.util.goodput\n"
        "import ray_tpu_torch.util.reqtrace, ray_tpu_torch.util.timeline\n"
        "import ray_tpu_torch.util.telemetry, ray_tpu_torch.util.xprof\n"
        "import ray_tpu_torch.util.prefetch\n"
        "import ray_tpu_torch.collective.telemetry\n"
        "import ray_tpu_torch.train.config, ray_tpu_torch.train.session\n"
        "print(sorted(bad() - before))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_subpackages_are_covered_by_the_source_scan():
    """The scan above walks every module of the port, the slices that
    came later included."""
    files = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    for module in ("collective/__init__.py", "collective/types.py",
                   "collective/collective_group/cpu_group.py",
                   "collective/collective_group/nccl_group.py",
                   "parallel/mesh.py", "parallel/sharding.py",
                   "parallel/partition_rules.py",
                   "parallel/ring_attention.py", "parallel/ulysses.py",
                   "train/distributed.py", "dryrun.py", "testing.py",
                   "ops/moe.py", "parallel/pipeline.py",
                   "parallel/grad_collectives.py", "util/checkpoint_fs.py",
                   "util/flax_msgpack.py", "train/sharded_checkpoint.py",
                   "train/checkpoint.py", "util/metrics.py",
                   "util/flight_recorder.py", "util/spans.py",
                   "util/tracing.py", "util/goodput.py", "util/reqtrace.py",
                   "util/timeline.py", "util/telemetry.py", "util/xprof.py",
                   "util/prefetch.py", "collective/telemetry.py",
                   "train/config.py", "train/session.py"):
        assert module in files


def test_no_device_means_cuda_or_raise(monkeypatch):
    from ray_tpu_torch import collective as col
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.llm.engine import GenerationEngine
    from ray_tpu_torch.llm.kv_cache import init_cache
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_init
    from ray_tpu_torch.models.llama import Llama, LlamaConfig, llama_init
    from ray_tpu_torch.ops.moe import MoEMLP
    from ray_tpu_torch.train.distributed import setup_distributed_mesh
    from ray_tpu_torch.train.session import TrainSession, iter_device_batches

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    cfg, lcfg = GPT2Config.tiny(), LlamaConfig.tiny()
    moe = GPT2Config(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=64,
                     max_seq=16, moe_num_experts=4)
    for entry in (lambda: GPT2(cfg), lambda: gpt2_init(cfg),
                  lambda: GPT2(moe), lambda: MoEMLP(32, 64, 4),
                  lambda: Llama(lcfg), lambda: llama_init(lcfg),
                  lambda: GenerationEngine(model_cfg=cfg),
                  lambda: GenerationEngine(model="llama"),
                  lambda: init_cache(1, 1, 1, 1, 1, torch.float32),
                  lambda: setup_distributed_mesh(rank=0, world=1),
                  lambda: col.init_collective_group(1, 0, backend="nccl"),
                  lambda: iter_device_batches([]),
                  lambda: TrainSession(0, 1, 0, 1, 0, "x")
                  .iter_device_batches([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_kernel_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch,
                                                         tmp_path):
    from ray_tpu_torch.ops import _kernels

    assert _kernels.source_hash() == _kernels.source_hash()
    assert _kernels.build_dir().parent == PKG / "_build"
    assert "ray_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels._nvcc()


def test_kernel_hash_covers_every_source_and_header(monkeypatch, tmp_path):
    """Editing any file under csrc/ (a kernel source or a header shared by
    several kernels) changes the build hash, so no stale library loads."""
    from ray_tpu_torch.ops import _kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(PKG / "csrc", csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers and all((csrc / s).exists() for s in _kernels.SOURCES)
    seen = {_kernels.source_hash()}
    for path in [*headers, csrc / _kernels.SOURCES[0]]:
        path.write_text(path.read_text() + "\n// edited\n")
        seen.add(_kernels.source_hash())
    (csrc / "extra.h").write_text("#pragma once\n")
    seen.add(_kernels.source_hash())
    assert len(seen) == len(headers) + 3
