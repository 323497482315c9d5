"""The share of the traced serving seconds in which no kernel, copy or
set ran on the card, in percent."""


def read(run):
    tr = run.get("trace")
    if run["kind"] != "serve" or not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
