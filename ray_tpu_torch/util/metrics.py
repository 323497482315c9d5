"""Metrics: Counter / Gauge / Histogram in a process-local registry.

A copy of ``ray_tpu/util/metrics.py`` (no JAX there either; the port
keeps its own so it imports nothing of the JAX package).  Every process
keeps one registry; ``registry().snapshot()`` gives its series as plain
dicts and ``render_prometheus`` turns snapshots of one or more sources
into the Prometheus text exposition.  Names, tags and help strings of
the series the port emits are the JAX package's, so the same readers
(the telemetry summary, the doctor, a dashboard) read both.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    50.0, 100.0)


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, "Metric"] = {}

    def register(self, metric: "Metric") -> "Metric":
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(
                        f"metric {metric.name!r} already registered with "
                        f"type {type(existing).__name__}")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def snapshot(self) -> List[Dict]:
        with self._lock:
            metrics = list(self._metrics.values())
        return [m._snapshot() for m in metrics]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


_registry = _Registry()


def registry() -> _Registry:
    return _registry


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Base: named metric with per-tag-set series."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}
        inst = _registry.register(self)
        if inst is not self:  # re-registration returns the first instance
            self.__dict__ = inst.__dict__

    def _check_tags(self, tags: Optional[Dict[str, str]]):
        extra = set(tags or {}) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"metric {self.name!r}: unknown tags {sorted(extra)} "
                f"(declared {list(self.tag_keys)})")

    def _snapshot(self) -> Dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "series": [{"tags": dict(k), "value": v}
                               for k, v in self._series.items()]}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc value must be >= 0")
        self._check_tags(tags)
        k = _tag_key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._check_tags(tags)
        with self._lock:
            self._series[_tag_key(tags)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = _DEFAULT_BUCKETS,
                 tag_keys: Sequence[str] = ()):
        self.boundaries = tuple(sorted(boundaries))
        self._hist: Dict[Tuple[Tuple[str, str], ...], Dict] = {}
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self._check_tags(tags)
        k = _tag_key(tags)
        with self._lock:
            h = self._hist.get(k)
            if h is None:
                h = self._hist[k] = {
                    "buckets": [0] * (len(self.boundaries) + 1),
                    "sum": 0.0, "count": 0}
            import bisect

            h["buckets"][bisect.bisect_left(self.boundaries, value)] += 1
            h["sum"] += value
            h["count"] += 1

    def _snapshot(self) -> Dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "description": self.description,
                    "boundaries": list(self.boundaries),
                    "series": [{"tags": dict(k), "hist":
                                {"buckets": list(h["buckets"]),
                                 "sum": h["sum"], "count": h["count"]}}
                               for k, h in self._hist.items()]}


def ttft_phase_histogram() -> Histogram:
    """THE time-to-first-token phase histogram — one definition so the
    proxy, the handle's admission gate, and the generation engine all
    register the identical (name, tag_keys) pair; drift here would
    silently split the metric at the telemetry merge."""
    return Histogram("rt_serve_ttft_phase_seconds",
                     "Time-to-first-token split by phase.",
                     tag_keys=("phase",))


def observe_ttft_phase(phase: str, seconds: float) -> None:
    """Record one TTFT phase observation; never raises (observability
    must not fail the request path)."""
    try:
        ttft_phase_histogram().observe(seconds,
                                       tags={"phase": phase})
    except Exception:
        pass


def _esc(v: str) -> str:
    """Prometheus exposition label-value escaping."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt_tags(tags: Dict[str, str], extra: Dict[str, str]) -> str:
    merged = {**tags, **extra}
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def render_prometheus(sources: Dict[str, List[Dict]]) -> str:
    """Cluster-wide Prometheus text exposition.

    ``sources`` maps a source id (node/worker tag) to its snapshot list.
    Series carry a ``source`` label so same-named metrics from different
    processes stay distinct (aggregate in the scraper, the Prometheus
    way).
    """
    by_name: Dict[str, List[Tuple[str, Dict]]] = {}
    for src, snaps in sources.items():
        for snap in snaps:
            by_name.setdefault(snap["name"], []).append((src, snap))
    lines: List[str] = []
    for name in sorted(by_name):
        first = by_name[name][0][1]
        if first.get("description"):
            lines.append(f"# HELP {name} {first['description']}")
        lines.append(f"# TYPE {name} {first['kind']}")
        for src, snap in by_name[name]:
            extra = {"source": src} if src else {}
            if snap["kind"] == "histogram":
                bounds = snap["boundaries"]
                for s in snap["series"]:
                    cum = 0
                    for b, cnt in zip(list(bounds) + ["+Inf"],
                                      s["hist"]["buckets"]):
                        cum += cnt
                        le = {**s["tags"], "le": str(b)}
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_tags(le, extra)} {cum}")
                    lines.append(f"{name}_sum"
                                 f"{_fmt_tags(s['tags'], extra)} "
                                 f"{s['hist']['sum']}")
                    lines.append(f"{name}_count"
                                 f"{_fmt_tags(s['tags'], extra)} "
                                 f"{s['hist']['count']}")
            else:
                for s in snap["series"]:
                    lines.append(f"{name}"
                                 f"{_fmt_tags(s['tags'], extra)} "
                                 f"{s['value']}")
    return "\n".join(lines) + ("\n" if lines else "")
