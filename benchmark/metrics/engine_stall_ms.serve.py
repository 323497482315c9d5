"""The engine thread's stall a step over the window, in ms: wall time
less CPU time over its host phases (``_phases.HOST``), the time it was
ready but not running, as while the clients' thread held the
interpreter lock.  A program without the engine's phase clock gives no
reading."""

from benchmark.metrics._phases import HOST, per_step


def read(run):
    phases = per_step(run)
    if phases is None:
        return None
    wall, cpu = phases
    return sum(wall[p] - cpu[p] for p in HOST)
