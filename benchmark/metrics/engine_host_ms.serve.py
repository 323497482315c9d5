"""The engine thread's host time a step over the window, in ms: the wall
time of every phase of its ``step()`` but ``wait`` (the logits copies,
which wait for the card) and ``idle``, from the engine's phase clock
(``_phases``).  A program without that clock gives no reading.

Prints on standard error each phase's wall and CPU ms a step, and the
coverage: host + wait over the window's wall time a step, and all
phases together over the window's wall time."""

import sys

from benchmark.metrics._phases import HOST, per_step


def read(run):
    phases = per_step(run)
    if phases is None:
        return None
    wall, cpu = phases
    host = sum(wall[p] for p in HOST)
    step_ms = run["window_s"] * 1e3 / (run["stats_close"]["steps"]
                                       - run["stats_open"]["steps"])
    print("engine phases, ms a step (wall / cpu): " + ", ".join(
        f"{p} {wall[p]:.3f} / {cpu[p]:.3f}" for p in wall), file=sys.stderr)
    print(f"engine coverage: host {host:.3f} + wait {wall['wait']:.3f} = "
          f"{host + wall['wait']:.3f} of a {step_ms:.3f} ms step "
          f"({100 * (host + wall['wait']) / step_ms:.2f}%); all phases "
          f"{100 * sum(wall.values()) / step_ms:.2f}% of the window",
          file=sys.stderr)
    return host
