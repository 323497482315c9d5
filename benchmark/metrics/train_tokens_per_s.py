"""Tokens trained a second: batch x sequence x steps issued in the
window, over the window, which ends in a synchronisation after the last
step."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["steps"] * run["tokens_per_step"] / run["window_s"]
