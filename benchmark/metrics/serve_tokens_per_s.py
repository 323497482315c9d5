"""Generated tokens that clients received inside the window, a second."""

from benchmark.harness.serve import window_tokens


def read(run):
    if run["kind"] != "serve":
        return None
    return window_tokens(run) / run["window_s"]
