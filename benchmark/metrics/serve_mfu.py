"""Model FLOP utilisation of serving over the window: the frozen decode
FLOPs of every token a decode step produced inside it, at its context,
and the prefill FLOPs of every request admitted inside it, over the
window, over the card's dense bf16 peak, in percent."""

from benchmark import costs
from benchmark.harness.serve import window_decodes, window_prefills


def read(run):
    peak = costs.peak_flops(run["device_kind"])
    if run["kind"] != "serve" or not peak:
        return None
    cfg = run["config"]
    flops = sum(costs.decode_flops_per_token(cfg, ctx)
                for ctx in window_decodes(run))
    flops += sum(costs.prefill_flops(cfg, p) for p in window_prefills(run))
    return 100.0 * flops / run["window_s"] / peak
