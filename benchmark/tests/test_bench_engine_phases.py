"""The readers of the engine's phase clock (``engine_host_ms``,
``logits_wait_ms``, ``engine_stall_ms`` and their ``.124m`` twins) on
synthetic ``stats()``, on the stats of a program without the clock, and
in a traced serving run at a CPU size."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest

from benchmark.harness import report
from benchmark.harness.spec import reader
from benchmark.metrics._phases import HOST
from ray_tpu_torch.llm.engine import PHASES

from .conftest import SEED, tiny_cell

NAMES = ("engine_host_ms.serve", "logits_wait_ms.serve",
         "engine_stall_ms.serve")


def stats(steps, wall, cpu):
    return {"steps": steps, "phase_wall_s": dict(zip(PHASES, wall)),
            "phase_cpu_s": dict(zip(PHASES, cpu))}


def synthetic_run():
    """40 steps in a 4 s window, each phase's seconds over it known."""
    open_ = stats(100, [1.0] * 7, [0.5] * 7)
    # over the window: admit 0.4, tables 0.2, issue 0.8, wait 2.0,
    # sample 0.4, other 0.08, idle 0.12 s; CPU 0.3, 0.1, 0.8, 1.0,
    # 0.2, 0.08, 0.0 s
    close = stats(140, [1.4, 1.2, 1.8, 3.0, 1.4, 1.08, 1.12],
                  [0.8, 0.6, 1.3, 1.5, 0.7, 0.58, 0.5])
    return {"kind": "serve", "window_s": 4.0, "stats_open": open_,
            "stats_close": close}


def test_readers_on_synthetic_stats(capsys):
    run = synthetic_run()
    host = reader("engine_host_ms.serve")(run)
    assert host == pytest.approx((0.4 + 0.2 + 0.8 + 0.4 + 0.08) / 40 * 1e3)
    assert reader("logits_wait_ms.serve")(run) == pytest.approx(50.0)
    stall = (0.1 + 0.1 + 0.0 + 0.2 + 0.0) / 40 * 1e3
    assert reader("engine_stall_ms.serve")(run) == pytest.approx(stall)
    err = capsys.readouterr().err
    assert "admit 10.000 / 7.500" in err and "wait 50.000 / 25.000" in err
    # host 47 + wait 50 of a 100 ms step; all seven phases 100 ms a step
    assert "= 97.000 of a 100.000 ms step (97.00%)" in err
    assert "all phases 100.00% of the window" in err


def test_host_phases_are_the_engines_less_wait_and_idle():
    """The readers' one list of host phases names the engine's phases,
    all but ``wait`` and ``idle``."""
    assert set(HOST) | {"wait", "idle"} == set(PHASES)
    assert len(HOST) + 2 == len(PHASES)


@pytest.mark.parametrize("name", NAMES)
def test_the_124m_twin_reads_as_the_xl_reader(name):
    run = synthetic_run()
    assert reader(name + ".124m")(run) == reader(name)(run)


@pytest.mark.parametrize("name", [n + s for n in NAMES
                                  for s in ("", ".124m")])
def test_no_reading_without_the_clock(name):
    """A program without the phase clock (its ``stats()`` has no
    ``phase_wall_s``), a window with no step and a training run give no
    reading and raise nothing."""
    run = synthetic_run()
    for side in ("stats_open", "stats_close"):
        for key in ("phase_wall_s", "phase_cpu_s"):
            del run[side][key]
    assert reader(name)(run) is None
    run = synthetic_run()
    run["stats_close"]["steps"] = run["stats_open"]["steps"]
    assert reader(name)(run) is None
    assert reader(name)({"kind": "train"}) is None


def test_traced_124m_run_reports_the_phases_on_the_cpu(cpu, capsys):
    """The 124M serving cell at a CPU size with ``--trace 1``: the three
    readers report, and the engine's phases account for the window."""
    cell = tiny_cell("serve-gpt2-124m-longchat")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = report.execute(cell, SEED, 2.0, True, cpu, time.time())
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    got = {n: line["metrics"][n + ".124m"]["value"] for n in NAMES}
    assert got["engine_host_ms.serve"] > 0
    assert got["logits_wait_ms.serve"] > 0
    assert got["engine_stall_ms.serve"] >= 0
    cover = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("engine coverage")]
    share = float(cover[-1].rsplit("all phases ", 1)[1].split("%")[0])
    assert share == pytest.approx(100, abs=5)
