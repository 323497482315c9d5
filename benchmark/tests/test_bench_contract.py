"""``BENCHMARK.json`` against the benchmark's contract, and every file
it names found by name."""

import json
import re

from benchmark.harness.spec import HERE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    n = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        group_names = [x["name"] for x in group]
        assert len(group_names) == len(set(group_names))
        assert all(NAME.match(x) for x in group_names)
    for m in metrics:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_configs_hold_what_is_run():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/configs/")
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        widths = [k for k in cfg["reduced"]
                  if k.endswith(("_dim", "_rank"))
                  or k in ("n_embd", "n_inner", "n_head")]
        assert not widths


def test_every_cell_finds_its_files_and_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert cell.limits and cell.traffic["kind"] in ("train", "serve")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert w["name"] in e2e[m["moves"]].get("workloads",
                                                    [w["name"]])
        for m in cell.end_to_end + cell.per_layer:
            assert (HERE / "metrics" / f"{m['name']}.py").exists()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert len(by_layer) >= 4
