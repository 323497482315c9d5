"""The harness as a process: what it loads, and how it ends without a
card or outside a full checkout."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.spec import ROOT

PROBE = r"""
import io, json, sys, time
from contextlib import redirect_stdout
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from conftest import tiny_cell
from benchmark.harness import report
for name in ("train-gpt2-124m-b64", "serve-gpt2-xl-longchat"):
    with redirect_stdout(io.StringIO()):
        report.execute(tiny_cell(name), 5, 1.0, True, torch.device("cpu"),
                       time.time())
import benchmark.control, benchmark.run
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_a_run_loads_no_jax_and_no_jax_package():
    code = PROBE.format(root=str(ROOT), tests=str(ROOT / "benchmark/tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ray_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "ray_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import benchmark.reference.gpt2, json; "
            "print(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_env())
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "ray_tpu", "ray_tpu_torch"}


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "train-gpt2-124m-b64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=_env())
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_outside_a_full_checkout_there_is_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "serve-gpt2-xl-longchat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=_env())
    assert out.returncode != 0
    assert "correct" not in out.stdout
