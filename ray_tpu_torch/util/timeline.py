"""Chrome-trace / Perfetto assembly of task, span and metrics records.

A copy of ``ray_tpu/util/timeline.py``: pure functions over plain
records, so a process can write its own span ring
(``util/spans.snapshot()``) as a Chrome trace.

- ``build_trace(tasks, spans, history)`` merges task-event records, span
  records and a metrics history into one Chrome-trace event list: one
  ``pid`` track per node or process, ``tid`` per worker, ``"X"``
  duration events, ``"s"``/``"f"`` flow arrows between a parent span
  and a child on another track, ``"C"`` counter tracks (MFU, goodput
  seconds, serve in-flight).
- ``critical_path_summary(spans)`` reduces per-rank ``train_step``
  spans and goodput phase spans to the slowest rank of each step and
  what it waited on.

Load the JSON in https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

_US = 1e6


def _node8(node_id: Any) -> str:
    s = node_id.hex() if hasattr(node_id, "hex") else str(node_id or "")
    return s[:8]


def _track_of(rec: Dict[str, Any], is_task: bool
              ) -> Tuple[Tuple[str, str], str]:
    """(process key, thread key) a record renders on.  Task events and
    spans from the same worker share one thread track (both are keyed
    by the worker's OS pid), so collective/phase spans nest visually
    inside the task slices that produced them."""
    node = _node8(rec.get("node_id"))
    pid = rec.get("worker_pid") if is_task else rec.get("pid")
    if node:
        return ("node", node), f"worker-{pid}"
    src = rec.get("source") or f"pid-{pid}"
    return ("proc", str(src)), "main"


class _Tracks:
    """Stable integer pid/tid assignment + "M" metadata events."""

    def __init__(self):
        self._pids: Dict[Tuple[str, str], int] = {}
        self._tids: Dict[Tuple[int, str], int] = {}
        self.meta: List[Dict] = []

    def pid(self, pkey: Tuple[str, str]) -> int:
        p = self._pids.get(pkey)
        if p is None:
            p = self._pids[pkey] = len(self._pids) + 1
            label = (f"node:{pkey[1]}" if pkey[0] == "node"
                     else pkey[1])
            self.meta.append({"ph": "M", "name": "process_name",
                              "pid": p, "tid": 0, "ts": 0,
                              "args": {"name": label}})
        return p

    def tid(self, pid: int, tkey: str) -> int:
        t = self._tids.get((pid, tkey))
        if t is None:
            t = self._tids[(pid, tkey)] = \
                sum(1 for k in self._tids if k[0] == pid) + 1
            self.meta.append({"ph": "M", "name": "thread_name",
                              "pid": pid, "tid": t, "ts": 0,
                              "args": {"name": tkey}})
        return t


def build_trace(tasks: List[Dict], spans: Optional[List[Dict]] = None,
                history: Optional[Dict[str, List]] = None,
                now: Optional[float] = None) -> List[Dict]:
    """Merge task records + span records + metrics history into one
    Chrome-trace event list (see module docstring for the shape)."""
    now = time.time() if now is None else now
    tracks = _Tracks()
    events: List[Dict] = []
    # span_id -> slice location, for flow-arrow pairing.
    slices: Dict[str, Dict[str, Any]] = {}

    def _emit_slice(name: str, cat: str, start: float, end: float,
                    rec: Dict, is_task: bool, args: Dict) -> None:
        pkey, tkey = _track_of(rec, is_task)
        p = tracks.pid(pkey)
        t = tracks.tid(p, tkey)
        ev = {"ph": "X", "name": name, "cat": cat,
              "ts": start * _US, "dur": max(end - start, 0.0) * _US,
              "pid": p, "tid": t, "args": args}
        events.append(ev)
        sid = rec.get("span_id")
        if sid:
            slices[sid] = {"pid": p, "tid": t, "ts": ev["ts"],
                           "dur": ev["dur"],
                           "parent": rec.get("parent_span_id")}

    for rec in tasks or []:
        times = rec.get("times") or {}
        start = times.get("RUNNING")
        if start is None:
            continue  # never started executing; nothing to draw
        end = times.get("FINISHED") or times.get("FAILED")
        state = rec.get("state")
        if end is None:
            # Still running: clip to now instead of an unmatched "B"
            # (which Perfetto renders as an unclosed/zero slice).
            end, state = max(now, start), "RUNNING"
        args = {"task_id": rec.get("task_id"), "state": state}
        if rec.get("error"):
            args["error"] = rec["error"]
        _emit_slice(rec.get("name", "?"), "task", start, end, rec,
                    True, args)

    for rec in spans or []:
        args = dict(rec.get("tags") or {})
        if rec.get("source"):
            args["source"] = rec["source"]
        _emit_slice(rec.get("name", "?"), rec.get("cat", "span"),
                    rec.get("start", 0.0), rec.get("end", 0.0), rec,
                    False, args)

    # Flow arrows: submitter span -> remote child execution, whenever
    # the two landed on different tracks (i.e. different processes).
    flow_id = 0
    for child in list(slices.values()):
        parent = slices.get(child.get("parent") or "")
        if parent is None or (parent["pid"], parent["tid"]) == \
                (child["pid"], child["tid"]):
            continue
        flow_id += 1
        s_ts = min(max(child["ts"], parent["ts"]),
                   parent["ts"] + parent["dur"])
        events.append({"ph": "s", "cat": "flow", "name": "submit",
                       "id": flow_id, "pid": parent["pid"],
                       "tid": parent["tid"], "ts": s_ts})
        events.append({"ph": "f", "bp": "e", "cat": "flow",
                       "name": "submit", "id": flow_id,
                       "pid": child["pid"], "tid": child["tid"],
                       "ts": max(child["ts"], s_ts)})

    events.extend(_counter_events(history, tracks))
    return tracks.meta + events


def _counter_events(history: Optional[Dict[str, List]],
                    tracks: _Tracks) -> List[Dict]:
    """"C" tracks from the controller's retained per-source series:
    MFU, goodput phase seconds, serve in-flight."""
    out: List[Dict] = []
    goodput_prefix = "rt_goodput_seconds{phase="
    for src in sorted(history or {}):
        pid = None
        for ts, vals in history[src]:
            mfu = vals.get("rt_train_mfu")
            phases = {k[len(goodput_prefix):-1]: v
                      for k, v in vals.items()
                      if k.startswith(goodput_prefix)}
            inflight = vals.get("rt_serve_inflight")
            if mfu is None and not phases and inflight is None:
                continue
            if pid is None:
                pid = tracks.pid(("proc", f"counters:{src}"))
            if mfu is not None:
                out.append({"ph": "C", "name": "MFU", "pid": pid,
                            "tid": 0, "ts": ts * _US,
                            "args": {"mfu": mfu}})
            if phases:
                out.append({"ph": "C", "name": "goodput_seconds",
                            "pid": pid, "tid": 0, "ts": ts * _US,
                            "args": phases})
            if inflight is not None:
                out.append({"ph": "C", "name": "serve_inflight",
                            "pid": pid, "tid": 0, "ts": ts * _US,
                            "args": {"inflight": inflight}})
    return out


# ------------------------------------------------------ critical path
def critical_path_summary(span_records: List[Dict]) -> Dict[str, Any]:
    """Per-step critical path from the span sink: for every training
    step reported by ``session.report`` (cat="train_step", tagged
    step/rank), name the slowest rank and the goodput phase that
    dominated its non-compute time (cat="phase" spans from the same
    source overlapping the step window)."""
    steps: Dict[int, Dict[int, Dict]] = {}
    phases_by_src: Dict[str, List[Dict]] = {}
    for rec in span_records or []:
        cat = rec.get("cat")
        if cat == "train_step":
            tags = rec.get("tags") or {}
            try:
                step = int(tags.get("step"))
                rank = int(tags.get("rank", 0))
            except (TypeError, ValueError):
                continue
            steps.setdefault(step, {})[rank] = rec  # latest wins
        elif cat == "phase":
            phases_by_src.setdefault(
                rec.get("source") or "", []).append(rec)

    rows: List[Dict[str, Any]] = []
    for step in sorted(steps):
        ranks = steps[step]
        durs = {r: max(rec["end"] - rec["start"], 0.0)
                for r, rec in ranks.items()}
        slowest = max(durs, key=durs.get)
        rec = ranks[slowest]
        waits: Dict[str, float] = {}
        for ph in phases_by_src.get(rec.get("source") or "", []):
            if ph.get("name") == "compute":
                continue
            overlap = (min(ph["end"], rec["end"])
                       - max(ph["start"], rec["start"]))
            if overlap > 0:
                waits[ph["name"]] = waits.get(ph["name"], 0.0) + overlap
        dominant = max(waits, key=waits.get) if waits else "compute"
        rows.append({
            "step": step, "slowest_rank": slowest,
            "slowest_source": rec.get("source"),
            "step_time_s": durs[slowest],
            "dominant_wait": dominant,
            "wait_s": waits.get(dominant, 0.0),
            "rank_step_times": {r: durs[r] for r in sorted(durs)},
        })
    return {"steps": rows}


def render_summary(summary: Dict[str, Any]) -> str:
    rows = summary.get("steps", [])
    if not rows:
        return ("(no train_step spans recorded yet — steps appear "
                "once workers call session.report)\n")
    lines = ["Per-step critical path (slowest rank + dominant wait):"]
    for row in rows:
        spread = ""
        times = row.get("rank_step_times", {})
        if len(times) > 1:
            spread = (f"  (fastest "
                      f"{min(times.values()) * 1e3:.1f}ms over "
                      f"{len(times)} ranks)")
        lines.append(
            f"  step {row['step']:>5}: rank {row['slowest_rank']} "
            f"slowest at {row['step_time_s'] * 1e3:.1f}ms, "
            f"dominant wait {row['dominant_wait']}"
            + (f" ({row['wait_s'] * 1e3:.1f}ms)"
               if row["dominant_wait"] != "compute" else "")
            + spread)
    return "\n".join(lines) + "\n"
