"""The decode steps' least bytes over the window, over the card's HBM
bandwidth, in percent: the served-type weights read once a step
(engine steps over the window, ``stats()``), and for every token a
decode step produced inside the window the K and V of its context read
and its own written (``costs``)."""

from benchmark import costs
from benchmark.harness.serve import window_decodes


def read(run):
    peak = costs.peak_hbm(run["device_kind"])
    if run["kind"] != "serve" or not peak:
        return None
    cfg = run["config"]
    item = 2 if cfg["dtype"] in ("bfloat16", "float16") else 4
    steps = run["stats_close"]["steps"] - run["stats_open"]["steps"]
    total = steps * costs.decode_step_weight_bytes(cfg, item)
    total += sum(costs.decode_token_kv_bytes(cfg, ctx, item)
                 for ctx in window_decodes(run))
    return 100.0 * total / run["window_s"] / peak
