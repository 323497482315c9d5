"""Perf regression ledger — round-over-round benchmark records.

Role-equivalent to the reference's release perf harness bookkeeping
(ref: release/microbenchmark/run_microbenchmark.py writing results +
release/release_tests.yaml defining pass criteria): every recorded
benchmark run appends one JSON line per metric to the ledger, and
``check_regressions`` compares the latest round's numbers against the
best ever recorded — a >20% drop is a regression.

The port keeps its own ledger, never the JAX package's ``PERF.jsonl``:
``DEFAULT_LEDGER`` is ``PERF_TORCH.jsonl`` at the checkout's root
(git-ignored), and every function takes a ``path``.

Record with:
  python -m ray_tpu_torch.util.microbenchmark --record [--quick]
  python -m ray_tpu_torch.util.scale_bench --record [--quick]
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

DEFAULT_LEDGER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "PERF_TORCH.jsonl")


# Hard floors (ops/s, higher is better): metric -> (floor, round the
# floor takes effect).  A floored metric is judged ONLY against its
# floor.  The port's floors start empty: a floor is set from a rate
# measured on the port's own hardware, with the card's name beside it.
FLOORS: Dict[str, "tuple[float, int]"] = {}


def record(entries: List[Dict[str, Any]], *, source: str,
           path: Optional[str] = None,
           round_tag: Optional[str] = None) -> None:
    """Append one line per metric: {ts, round, source, benchmark,
    value, unit, higher_is_better} (+ optional min/max noise bars
    when the producer ran multiple attempts)."""
    path = path or DEFAULT_LEDGER
    ts = time.time()
    tag = round_tag or os.environ.get("RT_PERF_ROUND", "")
    with open(path, "a") as f:
        for e in entries:
            row = {"ts": ts, "round": tag, "source": source,
                   "benchmark": e["benchmark"],
                   "value": float(e["value"]),
                   "unit": e.get("unit", ""),
                   "higher_is_better":
                       bool(e.get("higher_is_better", True))}
            for k in ("min", "max"):
                if k in e:
                    row[k] = float(e[k])
            f.write(json.dumps(row) + "\n")


def load(path: Optional[str] = None) -> List[Dict[str, Any]]:
    path = path or DEFAULT_LEDGER
    rows: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
    except OSError:
        pass
    return rows


def check_regressions(path: Optional[str] = None, *,
                      threshold: float = 0.20,
                      source: Optional[str] = None) -> List[str]:
    """Compare each metric's LATEST record against its best earlier
    record; returns human-readable regression descriptions (empty =
    healthy).  Only metrics with >=2 records are judged — a metric's
    first record IS its baseline."""
    rows = load(path)
    if source is not None:
        rows = [r for r in rows if r["source"] == source]
    by_metric: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_metric.setdefault(
            f'{r["source"]}/{r["benchmark"]}', []).append(r)
    problems: List[str] = []
    for name, recs in by_metric.items():
        recs.sort(key=lambda r: r["ts"])
        latest = recs[-1]
        if latest.get("unit") == "share":
            # Decomposition rows (e.g. tasks_inflight_phase_*): a
            # share legitimately moves when the workload mix or an
            # optimization shifts where time goes — informational,
            # never judged against best-ever.
            continue
        floored = FLOORS.get(name)
        if floored is not None:
            floor, since_round = floored
            # Records predating a floor's effective round are history,
            # not re-judged by a later bar.  Numeric round parse: "r10" must still be >= since, and an
            # untagged future record is held to the floor too.
            tag = latest.get("round") or ""
            try:
                round_num = int(tag.lstrip("r") or "999")
            except ValueError:
                round_num = 999
            if round_num >= since_round and latest["value"] < floor:
                problems.append(
                    f"{name}: {latest['value']:g} is below its floor "
                    f"{floor:g} (VERDICT done-bar)")
            continue
        if len(recs) < 2:
            continue
        earlier = recs[:-1]
        hib = latest.get("higher_is_better", True)
        if hib:
            best = max(e["value"] for e in earlier)
            if best > 0 and latest["value"] < best * (1 - threshold):
                problems.append(
                    f"{name}: {latest['value']:g} is "
                    f"{100 * (1 - latest['value'] / best):.0f}% below "
                    f"best {best:g}")
        else:
            best = min(e["value"] for e in earlier)
            if best > 0 and latest["value"] > best * (1 + threshold):
                problems.append(
                    f"{name}: {latest['value']:g} is "
                    f"{100 * (latest['value'] / best - 1):.0f}% above "
                    f"best {best:g}")
    return problems
