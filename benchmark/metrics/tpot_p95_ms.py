"""The 95th percentile of every gap between consecutive tokens of every
request, both received inside the window (linear interpolation between
order statistics)."""

import sys

import numpy as np

from benchmark.harness.serve import window_gaps


def read(run):
    if run["kind"] != "serve":
        return None
    gaps = window_gaps(run)
    print(f"tpot_p95_ms: {len(gaps)} gaps, "
          f"{int(len(gaps) * 0.05)} beyond the 95th percentile",
          file=sys.stderr)
    if not gaps:
        return None
    return float(np.percentile(np.asarray(gaps), 95)) * 1e3
