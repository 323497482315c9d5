"""Tokens the engine generated a step over the window, from its own
counters (``stats()``: ``tokens_generated`` and ``steps``)."""


def read(run):
    if run["kind"] != "serve":
        return None
    a, b = run["stats_open"], run["stats_close"]
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return (b["tokens_generated"] - a["tokens_generated"]) / steps
