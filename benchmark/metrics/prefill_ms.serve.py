"""The engine's mean prefill time of a request admitted in the window,
from its own counters (``stats()``: ``ttft_prefill_s_total`` over
``ttft_requests``).  A prefill inside a step lengthens that step's gap
between tokens."""


def read(run):
    if run["kind"] != "serve":
        return None
    a, b = run["stats_open"], run["stats_close"]
    n = b["ttft_requests"] - a["ttft_requests"]
    if n <= 0:
        return None
    return 1e3 * (b["ttft_prefill_s_total"] - a["ttft_prefill_s_total"]) / n
