"""SLO / error-budget plane — declarative per-deployment objectives
evaluated from the cluster's metrics history.

Objectives come from ``RT_SLO_CONFIG`` (inline JSON, or ``@/path`` to
a JSON file), keyed by deployment name (``"default"`` applies to every
deployment that lacks its own entry)::

    RT_SLO_CONFIG='{"llm": {"availability": 0.999,
                            "ttft_p99_ms": 100,
                            "latency_p99_ms": 500,
                            "window_s": 3600},
                    "default": {"availability": 0.99}}'

Three objective kinds:

  availability     fraction of non-error responses.  Errors are 5xx +
                   deadline-exceeded + shed (server-caused); 4xx is the
                   client's fault and counts as served.  Evaluated with
                   MULTI-WINDOW BURN RATES over the status-class
                   counter history (``rt_serve_requests_total``): the
                   burn rate is error_rate / (1 - target) — burn 1.0
                   spends the window's error budget exactly at the end
                   of the window.  Fast burn (>= ``fast_burn``x on both
                   the long and short window — the short window gates
                   alert CLEARING, Google SRE ch.5) pages; budget fully
                   spent is critical.
  ttft_p99_ms      p99 of ``rt_serve_ttft_seconds`` (the ingress-to-
                   first-token histogram) vs a millisecond target.
  latency_p99_ms   p99 of ``rt_serve_request_seconds`` vs a target.

A copy of ``ray_tpu/util/slo.py``.  Pure functions over plain dicts (no
torch, no cluster) — ``evaluate_objective`` / ``burn_rate`` unit-test
exactly; ``report`` wires them to a live controller, and
``util.telemetry.cluster_summary`` evaluates them over its snapshot.
The ``rt slo`` command is not ported (ROADMAP Queue 1 item 5, "doctor,
state and the rt CLI").
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

# Status classes the serve ingresses tag requests with.
ERROR_CLASSES = ("5xx", "deadline", "shed")
GOOD_CLASSES = ("2xx", "4xx")

REQUESTS_METRIC = "rt_serve_requests_total"
LATENCY_METRIC = "rt_serve_request_seconds"
TTFT_METRIC = "rt_serve_ttft_seconds"


@dataclass(frozen=True)
class Objective:
    deployment: str
    kind: str                 # availability | ttft_p99_ms | latency_p99_ms
    target: float             # fraction (availability) or milliseconds
    window_s: float = 3600.0  # error-budget window
    fast_burn: float = 14.4   # page: budget gone in window_s/fast_burn
    slow_burn: float = 3.0    # ticket: budget gone in ~window_s/3
    # Below this many requests in the budget window the objective
    # reports "low_traffic" instead of a status: one error on a
    # near-idle dev deployment must not page CRITICAL.
    min_requests: float = 10.0

    @property
    def budget(self) -> float:
        """Allowed error fraction (availability objectives)."""
        return max(1.0 - self.target, 1e-9)


DEFAULT_OBJECTIVES = {"availability": 0.99}


def parse_objectives(spec: Any) -> List[Objective]:
    """Parse the config mapping (already-decoded JSON) into
    ``Objective`` rows.  Unknown keys raise — a typo'd objective must
    not silently evaluate as 'no SLO'."""
    out: List[Objective] = []
    for dep, obj in (spec or {}).items():
        if not isinstance(obj, dict):
            raise ValueError(
                f"SLO entry for {dep!r} must be an object, "
                f"got {type(obj).__name__}")
        window = float(obj.get("window_s", 3600.0))
        fast = float(obj.get("fast_burn", 14.4))
        slow = float(obj.get("slow_burn", 3.0))
        min_req = float(obj.get("min_requests", 10.0))
        for kind, target in obj.items():
            if kind in ("window_s", "fast_burn", "slow_burn",
                        "min_requests"):
                continue
            if kind not in ("availability", "ttft_p99_ms",
                            "latency_p99_ms"):
                raise ValueError(f"unknown SLO kind {kind!r} for "
                                 f"deployment {dep!r}")
            if kind == "availability" and not 0.0 < float(target) < 1.0:
                raise ValueError(
                    f"availability target for {dep!r} must be in "
                    f"(0, 1), got {target}")
            out.append(Objective(dep, kind, float(target), window,
                                 fast, slow, min_req))
    return out


def objectives_from_env(env: Optional[Dict[str, str]] = None
                        ) -> Tuple[List[Objective], Dict[str, Any]]:
    """(explicit objectives, default spec) from ``RT_SLO_CONFIG``.
    The default spec applies to deployments with traffic but no
    explicit entry."""
    env = os.environ if env is None else env
    raw = (env.get("RT_SLO_CONFIG") or "").strip()
    if not raw:
        return [], dict(DEFAULT_OBJECTIVES)
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    spec = json.loads(raw)
    default = spec.pop("default", dict(DEFAULT_OBJECTIVES))
    return parse_objectives(spec), default


# ------------------------------------------------- burn-rate math (pure)
def window_counts(samples: List[Tuple[float, Dict[str, float]]],
                  now: float, window_s: float) -> Dict[str, float]:
    """Per-status-class request DELTAS over [now - window_s, now] from
    cumulative counter samples ``[(ts, {class: cumulative}), ...]``.

    The baseline is the newest sample at-or-before the window start
    (or the oldest in-window sample when history doesn't reach back
    that far).  Counter resets (a restarted proxy reports a smaller
    cumulative value) clamp the per-class delta at 0 from the reset
    point, never negative."""
    if not samples:
        return {}
    start = now - window_s
    before = [s for s in samples if s[0] <= start]
    inside = [s for s in samples if start < s[0] <= now]
    seq = ([before[-1]] if before else []) + inside
    if len(seq) < 2:
        return {}
    out: Dict[str, float] = {}
    for (_, prev), (_, cur) in zip(seq, seq[1:]):
        for cls in set(prev) | set(cur):
            d = cur.get(cls, 0.0) - prev.get(cls, 0.0)
            out[cls] = out.get(cls, 0.0) + max(d, 0.0)
    return out


def error_rate(counts: Dict[str, float]) -> Optional[float]:
    """Errors / total over a window's deltas; None with no traffic."""
    errors = sum(counts.get(c, 0.0) for c in ERROR_CLASSES)
    total = errors + sum(counts.get(c, 0.0) for c in GOOD_CLASSES)
    if total <= 0:
        return None
    return errors / total


def burn_rate(rate: Optional[float], budget: float) -> float:
    """How many windows' worth of error budget the observed error rate
    spends per window: 1.0 = exactly on budget."""
    if rate is None:
        return 0.0
    return rate / max(budget, 1e-9)


def evaluate_objective(obj: Objective,
                       samples: List[Tuple[float, Dict[str, float]]],
                       now: float,
                       latency_p99_ms: Optional[float] = None,
                       ttft_p99_ms: Optional[float] = None
                       ) -> Dict[str, Any]:
    """Evaluate ONE objective.  Returns a row with ``status`` in
    {"no_data", "ok", "slow_burn", "fast_burn", "exhausted",
    "breach"} — availability uses the burn-rate ladder, latency/TTFT
    objectives compare the observed p99 to the target."""
    row: Dict[str, Any] = {"deployment": obj.deployment,
                           "kind": obj.kind, "target": obj.target,
                           "window_s": obj.window_s}
    if obj.kind == "availability":
        # Budget accounting over the FULL window; burn-rate alerting
        # over two much shorter windows (long catches sustained burn,
        # short clears the alert quickly once a burst stops — the
        # multi-window policy, Google SRE workbook ch.5, scaled to
        # our short windows: 30d/1h/5m becomes window / window÷60 /
        # window÷720 with floors).  A burn rate of 1.0 sustained for
        # the whole budget window spends the budget exactly, so a
        # fast burn detected on the small windows still leaves most
        # of the budget to act in.
        long_w = max(obj.window_s / 60.0, 60.0)
        short_w = max(obj.window_s / 720.0, 30.0)
        budget_c = window_counts(samples, now, obj.window_s)
        long_c = window_counts(samples, now, long_w)
        short_c = window_counts(samples, now, short_w)
        long_r, short_r = error_rate(long_c), error_rate(short_c)
        long_b = burn_rate(long_r, obj.budget)
        short_b = burn_rate(short_r, obj.budget)
        errors = sum(budget_c.get(c, 0.0) for c in ERROR_CLASSES)
        total = errors + sum(budget_c.get(c, 0.0)
                             for c in GOOD_CLASSES)
        consumed = (errors / (total * obj.budget)) if total > 0 \
            else 0.0
        row.update({
            "error_rate": long_r, "error_rate_short": short_r,
            "burn_rate": long_b, "burn_rate_short": short_b,
            "budget_consumed": consumed,
            "errors": errors, "requests": total,
        })
        # The controller retains ~30 min of history: a declared
        # window beyond the retained span evaluates over what exists.
        # Report the effective span so the report is honest about it.
        if samples:
            row["window_effective_s"] = round(
                min(obj.window_s, now - samples[0][0]), 1)
        if total <= 0:
            row["status"] = "no_data"
        elif total < obj.min_requests:
            # Too little traffic for the math to mean anything.
            row["status"] = "low_traffic"
        elif consumed >= 1.0:
            row["status"] = "exhausted"
        elif long_b >= obj.fast_burn and short_b >= obj.fast_burn:
            row["status"] = "fast_burn"
        elif long_b >= obj.slow_burn and short_b >= obj.slow_burn:
            row["status"] = "slow_burn"
        else:
            row["status"] = "ok"
        return row
    observed = ttft_p99_ms if obj.kind == "ttft_p99_ms" \
        else latency_p99_ms
    row["observed_p99_ms"] = observed
    if observed is None:
        row["status"] = "no_data"
    else:
        row["status"] = "breach" if observed > obj.target else "ok"
    return row


def evaluate_all(objectives: List[Objective],
                 series_by_deployment: Dict[
                     str, List[Tuple[float, Dict[str, float]]]],
                 now: float,
                 latency_p99_ms: Optional[Dict[str, float]] = None,
                 ttft_p99_ms: Optional[Dict[str, float]] = None,
                 default_spec: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Evaluate every declared objective, plus the default spec for
    deployments that have traffic but no explicit objectives."""
    explicit = {o.deployment for o in objectives}
    objectives = list(objectives)
    if default_spec:
        for dep in sorted(set(series_by_deployment)
                          | set(latency_p99_ms or {})):
            # "?" is the proxies' pre-route-resolution bucket, not a
            # deployment — a default objective there would page
            # CRITICAL for something nobody can act on.
            if dep not in explicit and dep != "?":
                objectives += parse_objectives({dep: default_spec})
    rows = [evaluate_objective(
        o, series_by_deployment.get(o.deployment, []), now,
        latency_p99_ms=(latency_p99_ms or {}).get(o.deployment),
        ttft_p99_ms=(ttft_p99_ms or {}).get(o.deployment))
        for o in objectives]
    sev = {"exhausted": 0, "fast_burn": 1, "breach": 2,
           "slow_burn": 3, "ok": 4, "low_traffic": 5, "no_data": 6}
    rows.sort(key=lambda r: (sev.get(r["status"], 9),
                             r["deployment"], r["kind"]))
    return {"ts": now, "objectives": rows,
            "worst": rows[0]["status"] if rows else "no_data"}


# ------------------------------------------- metric extraction (pure)
def status_series(history: Dict[str, List],
                  ) -> Dict[str, List[Tuple[float, Dict[str, float]]]]:
    """Per-deployment cumulative status-class series from the
    controller's flattened metrics history ({source: [[ts, {key:
    value}], ...]}, keys like
    ``rt_serve_requests_total{deployment=llm,status_class=2xx}``).

    Several proxies report the SAME deployment as independent
    cumulative counters; naively interleaving them by timestamp would
    read every source switch as a counter reset.  Instead each output
    point carries the sum of every source's latest-known cumulative
    value (carry-forward), which stays monotone so ``window_counts``
    deltas are exact — only a real proxy restart looks like a reset.
    """
    # dep -> [(ts, source, {cls: cumulative})]
    raw: Dict[str, List[Tuple[float, str, Dict[str, float]]]] = {}
    for source, rows in (history or {}).items():
        for ts, vals in rows or []:
            by_dep: Dict[str, Dict[str, float]] = {}
            for key, value in vals.items():
                if not key.startswith(REQUESTS_METRIC + "{"):
                    continue
                tags = _parse_tags(key)
                by_dep.setdefault(tags.get("deployment", "?"), {})[
                    tags.get("status_class", "?")] = float(value)
            for dep, classes in by_dep.items():
                raw.setdefault(dep, []).append(
                    (float(ts), source, classes))
    out: Dict[str, List[Tuple[float, Dict[str, float]]]] = {}
    for dep, points in raw.items():
        points.sort(key=lambda p: p[0])
        latest: Dict[str, Dict[str, float]] = {}   # source -> classes
        series: List[Tuple[float, Dict[str, float]]] = []
        for ts, source, classes in points:
            latest[source] = classes
            summed: Dict[str, float] = {}
            for cls_map in latest.values():
                for cls, v in cls_map.items():
                    summed[cls] = summed.get(cls, 0.0) + v
            if series and series[-1][0] == ts:
                series[-1] = (ts, summed)
            else:
                series.append((ts, summed))
        out[dep] = series
    return out


def _parse_tags(key: str) -> Dict[str, str]:
    inner = key[key.index("{") + 1:key.rindex("}")]
    out = {}
    for part in inner.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def latency_p99s(sources: Dict[str, List[Dict]],
                 metric: str = LATENCY_METRIC,
                 phase: Optional[str] = None) -> Dict[str, float]:
    """Per-deployment p99 (ms) from the latest histogram snapshots,
    merged across sources/status classes (conservative max).  With
    ``phase`` only series carrying that phase tag contribute (the
    TTFT-phase histogram)."""
    from .telemetry import _hist_quantile

    out: Dict[str, float] = {}
    for snaps in (sources or {}).values():
        for snap in snaps:
            if snap.get("name") != metric:
                continue
            for s in snap.get("series", []):
                tags = s.get("tags") or {}
                if phase is not None and tags.get("phase") != phase:
                    continue
                dep = tags.get("deployment", "?")
                h = s.get("hist") or {}
                if not h.get("count"):
                    continue
                p99 = _hist_quantile(snap.get("boundaries") or [],
                                     h.get("buckets") or [],
                                     h.get("count", 0), 0.99) * 1e3
                out[dep] = max(out.get(dep, 0.0), p99)
    return out


# ------------------------------------------------------- live report
def report(*, address: Optional[str] = None,
           now: Optional[float] = None,
           sources: Optional[Dict[str, List[Dict]]] = None,
           history: Optional[Dict[str, List]] = None
           ) -> Dict[str, Any]:
    """Assemble the full SLO report from a live controller.  ``sources`` /
    ``history`` accept already-fetched telemetry so callers that hold
    them (the doctor fetches the telemetry snapshot for its own
    checks) don't pay the heaviest controller RPC twice."""
    from . import state as state_api

    objectives, default = objectives_from_env()
    if history is None:
        try:
            history = state_api.metrics_history(address=address)
        except Exception:
            history = {}
    if sources is None:
        try:
            raw = state_api.telemetry(address=address)
        except Exception:
            raw = {}
        sources = raw.get("sources") or {}
    return evaluate_all(
        objectives, status_series(history),
        now=time.time() if now is None else now,
        latency_p99_ms=latency_p99s(sources),
        ttft_p99_ms=latency_p99s(sources, metric=TTFT_METRIC),
        default_spec=default)


def render_text(rep: Dict[str, Any]) -> str:
    """Human-readable SLO report."""
    rows = rep.get("objectives") or []
    if not rows:
        return ("no SLO objectives evaluated (no serve traffic yet; "
                "declare objectives via RT_SLO_CONFIG)\n")
    lines = [f"SLOs ({len(rows)} objective(s), worst: "
             f"{rep.get('worst', '?')}):"]
    for r in rows:
        dep, kind = r["deployment"], r["kind"]
        status = r["status"].upper()
        if kind == "availability":
            er = r.get("error_rate")
            lines.append(
                f"  [{status:>9}] {dep:<16} availability >= "
                f"{100 * r['target']:g}%"
                + (f"  error rate {100 * er:.3f}%" if er is not None
                   else "  (no traffic)")
                + (f"  burn {r.get('burn_rate', 0.0):.1f}x"
                   f"/{r.get('burn_rate_short', 0.0):.1f}x "
                   f"(long/short)  budget used "
                   f"{100 * r.get('budget_consumed', 0.0):.1f}%"
                   if er is not None else ""))
        else:
            obs = r.get("observed_p99_ms")
            lines.append(
                f"  [{status:>9}] {dep:<16} {kind} <= "
                f"{r['target']:g}ms"
                + (f"  observed p99 {obs:.1f}ms" if obs is not None
                   else "  (no data)"))
    return "\n".join(lines) + "\n"
