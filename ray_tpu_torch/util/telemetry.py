"""Histogram read-side helpers of the telemetry summary.

The JAX package's ``util/telemetry.py`` assembles the cluster summary
behind ``rt telemetry`` from a live controller.  The port has no
runtime yet: it keeps a copy of the histogram statistics (count, sum,
mean and bucket-bound quantiles of a ``Histogram`` series), which read
the process-local registry as well, and ``cluster_summary`` raises
until the runtime slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _hist_stats(boundaries: List[float], hist: Dict) -> Dict[str, float]:
    count = hist.get("count", 0)
    total = hist.get("sum", 0.0)
    out = {"count": count, "sum": total,
           "mean": (total / count) if count else 0.0}
    out["p50"] = _hist_quantile(boundaries, hist.get("buckets", []),
                                count, 0.5)
    out["p99"] = _hist_quantile(boundaries, hist.get("buckets", []),
                                count, 0.99)
    return out


def _hist_quantile(boundaries: List[float], buckets: List[int],
                   count: int, q: float) -> float:
    """Upper-bound estimate of the q-quantile from bucket counts (the
    +Inf bucket reports the last finite boundary)."""
    if not count or not buckets:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= target:
            if i < len(boundaries):
                return float(boundaries[i])
            return float(boundaries[-1]) if boundaries else 0.0
    return float(boundaries[-1]) if boundaries else 0.0


def cluster_summary(*, address: Optional[str] = None) -> Dict[str, Any]:
    """The cluster-wide summary needs a controller to pull per-source
    snapshots from; the port has none yet."""
    raise NotImplementedError(
        "cluster_summary reads a cluster controller; it arrives with the "
        "runtime slice of the port (ROADMAP Queue 1 item 5).  The "
        "process-local registry is util.metrics.registry().snapshot()")
