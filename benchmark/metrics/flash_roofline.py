"""The flash kernels' share of their roofline in the traced steps: the
frozen bound (the larger of FLOPs over peak and bytes over bandwidth,
``costs.flash_cost``) of every launch of ``fwd_kernel``, ``dkv_kernel``
and ``dq_kernel`` in the trace, over their summed device time, in
percent."""

from benchmark import costs

KERNELS = {"fwd_kernel": "flash_fwd", "dkv_kernel": "flash_dkv",
           "dq_kernel": "flash_dq"}


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or not tr:
        return None
    cfg = run["config"]
    bh = run["traffic"]["batch"] * cfg["n_head"]
    t, d = run["traffic"]["seq"], cfg["n_embd"] // cfg["n_head"]
    bound = spent = 0.0
    for name, (launches, seconds) in tr["kernels"].items():
        kind = next((v for k, v in KERNELS.items() if k in name), None)
        if kind is None:
            continue
        least = costs.roofline_seconds(
            *costs.flash_cost(kind, bh, t, d, causal=True),
            run["device_kind"])
        if least is None:
            return None
        bound += launches * least
        spent += seconds
    return 100.0 * bound / spent if spent else None
