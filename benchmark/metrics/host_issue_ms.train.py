"""The host's own time to issue one training step, in the traced steps:
the traced window less the host's waits on the card (a full launch
queue, the closing synchronisation), over the steps.  Under the card's
step time, the card paces training; near it, the host does.  (A host
clock around each call reads the step time itself once the launch
queue is full, so the trace separates the waits.)"""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or not tr or not tr["busy_s"]:
        return None
    return 1e3 * (tr["window_s"] - tr["host_wait_s"]) / run["trace_steps"]
