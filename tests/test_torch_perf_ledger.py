"""The port's perf ledger and control-plane benchmarks against the JAX
package's (``ray_tpu/util/perf_ledger.py``, ``microbenchmark.py``,
``scale_bench.py``).

``record``/``load``/``check_regressions`` run on the same rows in both
packages, with the same floors injected into both ``FLOORS`` tables:
the loaded rows and the regression messages must be equal (no numeric
tolerance: the functions compare the same floats).  The port writes its
own ledger, never the JAX package's ``PERF.jsonl``, and starts with no
floors.  The quick benchmarks keep JAX's row names, units and keys:
both microbenchmarks and both scale benches' ``run`` in local mode,
both scale benches' ``--quick`` entry points on clusters (the
10-actor fleet included), and the port's ``--record`` entry points
write the ledger they are given.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from ray_tpu.util import perf_ledger as jax_ledger
from ray_tpu_torch.util import perf_ledger as port_ledger

ROOT = Path(__file__).resolve().parent.parent

ROWS = {
    "higher_is_better": [
        {"ts": 1, "source": "m", "benchmark": "tput", "value": 100.0,
         "higher_is_better": True},
        {"ts": 2, "source": "m", "benchmark": "tput", "value": 79.0,
         "higher_is_better": True}],
    "within_threshold": [
        {"ts": 1, "source": "m", "benchmark": "tput", "value": 100.0,
         "higher_is_better": True},
        {"ts": 3, "source": "m", "benchmark": "tput", "value": 85.0,
         "higher_is_better": True}],
    "lower_is_better": [
        {"ts": 1, "source": "m", "benchmark": "lat", "value": 1.0,
         "higher_is_better": False},
        {"ts": 2, "source": "m", "benchmark": "lat", "value": 1.5,
         "higher_is_better": False}],
    "share_rows": [
        {"ts": 1, "source": "scale", "unit": "share",
         "benchmark": "tasks_inflight_phase_exec", "value": 0.40,
         "higher_is_better": True},
        {"ts": 2, "source": "scale", "unit": "share",
         "benchmark": "tasks_inflight_phase_exec", "value": 0.05,
         "higher_is_better": True}],
    "single_record": [
        {"ts": 1, "source": "m", "benchmark": "x", "value": 1.0,
         "higher_is_better": True}],
    "floors": [
        # Below its floor from the floor's round on; an earlier round's
        # record is history; an untagged record is held to it.
        {"ts": 1, "round": "r3", "source": "micro",
         "benchmark": "tasks_batch", "value": 10.0},
        {"ts": 2, "round": "r7", "source": "micro",
         "benchmark": "tasks_batch", "value": 50.0},
        {"ts": 1, "round": "r2", "source": "micro",
         "benchmark": "put_get_small", "value": 5.0},
        {"ts": 1, "round": "", "source": "scale",
         "benchmark": "many_actors_50", "value": 1.0},
        {"ts": 1, "round": "r10", "source": "scale",
         "benchmark": "many_tasks_inflight_10000", "value": 90.0}],
}
FLOORS = {"micro/tasks_batch": (100.0, 6),
          "micro/put_get_small": (300.0, 5),
          "scale/many_actors_50": (10.0, 7),
          "scale/many_tasks_inflight_10000": (100.0, 5)}


@pytest.fixture
def same_floors(monkeypatch):
    monkeypatch.setattr(jax_ledger, "FLOORS", dict(FLOORS))
    monkeypatch.setattr(port_ledger, "FLOORS", dict(FLOORS))


@pytest.mark.parametrize("case", sorted(ROWS))
def test_check_regressions_matches_jax(case, tmp_path, same_floors):
    out = {}
    for name, mod in (("jax", jax_ledger), ("port", port_ledger)):
        path = tmp_path / f"{name}.jsonl"
        with open(path, "w") as f:
            for r in ROWS[case]:
                f.write(json.dumps(r) + "\n")
        out[name] = (mod.load(str(path)),
                     mod.check_regressions(str(path)),
                     mod.check_regressions(str(path), threshold=0.5),
                     mod.check_regressions(str(path), source="m"))
    assert out["port"] == out["jax"]
    expect = {"higher_is_better": 1, "within_threshold": 0,
              "lower_is_better": 1, "share_rows": 0, "single_record": 0,
              "floors": 3}[case]
    assert len(out["port"][1]) == expect


def test_record_matches_jax(tmp_path):
    entries = [{"benchmark": "a", "value": 100.0, "unit": "ops/s",
                "min": 90.0, "max": 120.0},
               {"benchmark": "b", "value": 5.0, "unit": "s",
                "higher_is_better": False}]
    rows = {}
    for name, mod in (("jax", jax_ledger), ("port", port_ledger)):
        path = str(tmp_path / f"{name}.jsonl")
        mod.record(entries, source="test", path=path, round_tag="r1")
        rows[name] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in mod.load(path)]
    assert rows["port"] == rows["jax"]
    assert rows["port"][0]["min"] == 90.0 and "min" not in rows["port"][1]


def test_port_never_writes_the_jax_ledger(tmp_path, monkeypatch):
    """The default ledger is the port's own, git-ignored file, and
    recording to it leaves ``PERF.jsonl`` as it was."""
    jax_file = ROOT / "PERF.jsonl"
    before = jax_file.read_bytes() if jax_file.exists() else None
    assert port_ledger.FLOORS == {}
    assert Path(port_ledger.DEFAULT_LEDGER).name == "PERF_TORCH.jsonl"
    assert Path(port_ledger.DEFAULT_LEDGER) != jax_file
    assert "/PERF_TORCH.jsonl" in (ROOT / ".gitignore").read_text()
    monkeypatch.setattr(port_ledger, "DEFAULT_LEDGER",
                        str(tmp_path / "PERF_TORCH.jsonl"))
    port_ledger.record([{"benchmark": "x", "value": 1.0}], source="t")
    assert [r["benchmark"] for r in port_ledger.load()] == ["x"]
    assert port_ledger.check_regressions() == []
    after = jax_file.read_bytes() if jax_file.exists() else None
    assert after == before


def test_quick_benchmark_rows_match_jax(tmp_path, monkeypatch):
    """Local mode in both packages: the same microbenchmark rows, and
    the scale bench's quick rows under the names and units of JAX's
    ``scale_bench.run(quick=True)`` (its hotpath shares need a cluster
    and are left out here)."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu.util import microbenchmark as jax_micro
    from ray_tpu.util import scale_bench as jax_scale
    from ray_tpu_torch.util import microbenchmark as port_micro
    from ray_tpu_torch.util import scale_bench as port_scale

    monkeypatch.setenv("RT_SESSION_DIR_ROOT", str(tmp_path))
    monkeypatch.delenv("RT_ADDRESS", raising=False)
    names = {}
    for name, pkg, micro in (("jax", ray_tpu, jax_micro),
                             ("port", ray_tpu_torch, port_micro)):
        pkg.init(mode="local")
        try:
            rows = micro.run(quick=True)
        finally:
            pkg.shutdown()
        assert all(r["per_sec"] > 0 and r["total"] > 0 for r in rows)
        names[name] = [r["benchmark"] for r in rows]
    assert names["port"] == names["jax"] == [
        "tasks_sequential", "tasks_batch", "actor_calls_sequential",
        "actor_calls_batch", "put_get_small", "put_get_4mb"]
    scale = {}
    for name, pkg, bench in (("jax", ray_tpu, jax_scale),
                             ("port", ray_tpu_torch, port_scale)):
        pkg.init(mode="local")
        try:
            rows = bench.run(quick=True)
        finally:
            pkg.shutdown()
        assert all(r["value"] > 0 for r in rows)
        scale[name] = [(r["benchmark"], r["unit"], sorted(r))
                       for r in rows]
    assert scale["port"] == scale["jax"]
    assert [n for n, _, _ in scale["jax"]] == [
        "many_tasks_inflight_1000", "queue_submit_10000"]


def _scale_main(pkg: str, tmp_path: Path, *extra: str):
    """``python -m <pkg>.util.scale_bench --quick`` in its own session
    root: the task benches on a 4-CPU cluster, then the 10-actor fleet
    on a second cluster whose prestart pool is filled first."""
    root = tmp_path / pkg
    root.mkdir()
    env = dict(os.environ, RT_SESSION_DIR_ROOT=str(root),
               PYTHONPATH=str(ROOT))
    env.pop("RT_ADDRESS", None)
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.util.scale_bench", "--quick",
         *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=root)


def test_scale_bench_quick_main_matches_jax(tmp_path):
    """Both packages' ``scale_bench --quick`` entry points, side by
    side: the same rows in the same order with the same units and keys,
    ``many_actors_10`` included, each fleet row served by the prestart
    pool (adoptions, not only cold spawns).  The port's ``--record``
    writes the ledger it is given; JAX's runs without ``--record`` so
    its ``PERF.jsonl`` stays untouched."""
    ledger = tmp_path / "ledger.jsonl"
    procs = {"jax": _scale_main("ray_tpu", tmp_path),
             "port": _scale_main("ray_tpu_torch", tmp_path, "--record",
                                 "--ledger", str(ledger))}
    rows = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
        rows[name] = [json.loads(ln) for ln in out.splitlines()
                      if ln.startswith("{\"")]
    shapes = {name: [(r["benchmark"], r["unit"], sorted(r)) for r in rs]
              for name, rs in rows.items()}
    assert shapes["port"] == shapes["jax"]
    for rs in rows.values():
        fleet = [r for r in rs if r["benchmark"] == "many_actors_10"]
        assert len(fleet) == 1
        assert fleet[0]["total"] == 10 and fleet[0]["value"] > 0
        assert fleet[0]["adopted"] > 0
    recorded = port_ledger.load(str(ledger))
    assert [r["benchmark"] for r in recorded] == \
        [r["benchmark"] for r in rows["port"]]
    assert {r["source"] for r in recorded} == {"scale"}


def test_microbenchmark_record_on_a_cluster(tmp_path):
    """``python -m ray_tpu_torch.util.microbenchmark --quick --record``
    on its own port cluster appends its six rows to the ledger named by
    ``--ledger``; no floor, so nothing regresses."""
    ledger = tmp_path / "ledger.jsonl"
    env = dict(os.environ, RT_SESSION_DIR_ROOT=str(tmp_path),
               PYTHONPATH=str(ROOT))
    env.pop("RT_ADDRESS", None)
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.util.microbenchmark",
         "--quick", "--record", "--attempts", "1", "--ledger",
         str(ledger)], capture_output=True, text=True, env=env,
        timeout=240, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    printed = [json.loads(ln) for ln in r.stdout.splitlines()
               if ln.startswith("{")]
    rows = port_ledger.load(str(ledger))
    assert [x["benchmark"] for x in rows] == \
        [x["benchmark"] for x in printed]
    assert {x["source"] for x in rows} == {"micro_quick"}
    assert all(x["value"] > 0 for x in rows)
    assert port_ledger.check_regressions(str(ledger)) == []
