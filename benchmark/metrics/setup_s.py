"""Set-up: from the process's start to the window's opening (imports,
the kernels' load or build, weights, warm-up, the serving ramp)."""


def read(run):
    return run["setup_s"]
