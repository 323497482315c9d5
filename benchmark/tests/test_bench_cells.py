"""Every cell's runner end to end at a CPU size (the kernels' plain
versions), the result line's contract, and planted faults that the
comparison has to catch."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest

from benchmark.harness import report
from benchmark.harness.spec import ROOT

from .conftest import SEED, tiny_cell

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run_line(cell, device, traced=False, seconds=2.0):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = report.execute(cell, SEED, seconds, traced, device, time.time())
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_line(line, cell, traced):
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    wanted = cell.per_layer if traced else cell.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end_on_the_cpu(name, cpu):
    cell = tiny_cell(name)
    line = run_line(cell, cpu)
    check_line(line, cell, traced=False)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(line["metrics"]) == e2e      # all host-clock metrics


@pytest.mark.parametrize("name", ["train-gpt2-124m-b64",
                                  "serve-gpt2-xl-longchat"])
def test_traced_run_on_the_cpu(name, cpu):
    cell = tiny_cell(name)
    line = run_line(cell, cpu, traced=True)
    check_line(line, cell, traced=True)
    assert line["correct"] is True
    # No card: no device-trace metric may be read from a CPU run.
    device_trace = {m["name"] for m in cell.per_layer
                    if m["source"] == "device_trace"}
    assert not device_trace & set(line["metrics"])


TRAIN_FAULTS = ["half_batch", "state_unchanged"]
SERVE_FAULTS = ["kv_unchanged", "token_altered"]


@pytest.mark.parametrize("fault", TRAIN_FAULTS + SERVE_FAULTS)
def test_planted_fault_is_not_correct(fault, cpu, monkeypatch):
    from benchmark import control
    from benchmark.harness import train

    name = ("train-gpt2-124m-b64" if fault in TRAIN_FAULTS
            else "serve-gpt2-xl-longchat")
    cell = tiny_cell(name)
    if fault == "half_batch":
        real = train.Program
        monkeypatch.setattr(train, "Program", lambda cfg, seed, device: real(
            cfg, seed, device, loss_rows=cell.traffic["batch"] // 2))
    with control.planted(fault, cell.config["vocab_size"]):
        line = run_line(cell, cpu, seconds=3.0)
    assert line["correct"] is False


def test_served_sample_is_drawn_from_the_window():
    from benchmark.harness.serve import Record, choose

    def rec(n, done_t, reason="length"):
        r = Record([1, 2, 3], n)
        r.tokens, r.reason, r.done_t = list(range(n)), reason, done_t
        return r

    ramp = [rec(50, 0.5), rec(60, 0.9)]             # finished before t_open
    window = [rec(n, 1.0 + n / 100) for n in range(5, 25)]
    late = [rec(40, 3.5), rec(30, None, None)]      # after t_close; cut
    pick = choose(ramp + window + late, 1.0, 3.0, SEED, 8)
    assert len(pick) == 8 and pick[0] is window[-1]
    assert all(r in window for r in pick)
    assert choose(ramp + late, 1.0, 3.0, SEED, 8) == []
