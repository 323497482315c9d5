"""Model FLOP utilisation of the traced training steps: their tokens
times the frozen training FLOPs a token (no remat recompute), over the
traced window, over the card's dense bf16 peak, in percent."""

from benchmark import costs


def read(run):
    tr = run.get("trace")
    peak = costs.peak_flops(run["device_kind"])
    if run["kind"] != "train" or not tr or not tr["busy_s"] or not peak:
        return None
    flops = run["trace_steps"] * run["tokens_per_step"] \
        * costs.train_flops_per_token(run["config"])
    return 100.0 * flops / tr["window_s"] / peak
