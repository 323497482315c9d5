"""Find everything a cell of ``BENCHMARK.json`` names, by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the one ``configs`` gives it; the mix
is ``traffic/<traffic>.json``; the cell's correctness limits are
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``,
whose ``read(run)`` returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent.parent        # benchmark/
ROOT = HERE.parent                                   # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    bench = _json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_file.name}; "
                         f"known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT / configs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str) -> Callable[[Any], Any]:
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
