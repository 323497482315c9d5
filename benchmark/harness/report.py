"""Run a cell's runner, read its metrics and print the result."""

from __future__ import annotations

import importlib
import json
import math
import sys
from typing import Any, Dict

from . import env
from .spec import Cell, reader


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> int:
    """Run ``cell`` and print its result line; the exit code."""
    card = env.power_limit() if device.type == "cuda" else "cpu"
    print(f"{cell.name}: seed {seed}, {seconds} s, trace {int(traced)}, "
          f"card {card}", file=sys.stderr)
    run = measure(cell, seed, seconds, traced, device, t_start)
    found = env.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    line = result(cell, run, traced, device)
    line["card"] = card
    line["checks"] = line.pop("checks")
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}"
              f" {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> Dict[str, Any]:
    """The runner of the mix's kind (``harness/<kind>.py``), with what
    the readers need beside its own output."""
    runner = importlib.import_module(f"{__package__}.{cell.traffic['kind']}")
    run = runner.run(cell, seed, seconds, traced, device, t_start)
    run.update(cell=cell.name, config=cell.config, traffic=cell.traffic,
               device_kind=env.device_info(device, cell.chips)["kind"])
    for k, v in run.get("info", {}).items():
        print(f"info {k} {v}", file=sys.stderr)
    return run


def result(cell: Cell, run: Dict[str, Any], traced: bool, device
           ) -> Dict[str, Any]:
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = env.device_info(device, cell.chips)
    dev["memory_peak_bytes"] = int(run["memory_peak_bytes"])
    line: Dict[str, Any] = {}
    if traced and run.get("trace"):
        tr = run["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in run["checks"].items() if k in cell.limits}
    unlimited = set(run["checks"]) - set(cell.limits)
    for k in sorted(unlimited):
        print(f"info {k} {run['checks'][k]!r} (no limit)", file=sys.stderr)
    correct = run["failed"] == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values())
    line.update(correct=correct, attempted=run["attempted"],
                failed=run["failed"], metrics=metrics, device=dev,
                checks=checks)
    return line
