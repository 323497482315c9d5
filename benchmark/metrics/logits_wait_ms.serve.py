"""The engine thread's ``wait`` a step over the window, in ms: the wall
time of its copies of logits to the host, which wait for the card to
finish each forward and then for the interpreter lock (``_phases``).  A
program without the engine's phase clock gives no reading."""

from benchmark.metrics._phases import per_step


def read(run):
    phases = per_step(run)
    return None if phases is None else phases[0]["wait"]
