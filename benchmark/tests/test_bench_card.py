"""On the card: every cell through ``run.py`` at its own size with a
short window, and each training cell's control at the cell's own size
(float8 at 124M, int8 at XL: see PERF.md).  Run there with

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import json
import subprocess
import sys

import pytest

from benchmark import control
from benchmark.harness.spec import ROOT, load_cell

from .test_bench_cells import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483701", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("name,precision", [("train-gpt2-124m-b64", "fp8"),
                                            ("train-gpt2-xl-b16", "int8")])
def test_training_control_at_the_cell_size(name, precision, seed, card):
    cell = load_cell(name)
    out = control.train_readings(cell, seed, card, precision, "")
    assert all(v <= cell.limits[k] for k, v in out["program"].items())
    assert any(v > cell.limits[k]
               for k, v in out["control_readings"].items())
