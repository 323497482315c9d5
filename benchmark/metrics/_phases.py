"""The engine's phase clock over a serving window, for the readers of
``engine_host_ms``, ``logits_wait_ms`` and ``engine_stall_ms``: not a
metric of its own.

``stats()`` of a program with the clock holds ``phase_wall_s`` and
``phase_cpu_s``, each phase's cumulative seconds on the engine thread
(``ray_tpu_torch/llm/engine.py`` ``PHASES``).  ``HOST`` are the phases
in which that thread works on the host; ``wait`` waits for the card and
``idle`` for work."""

HOST = ("admit", "tables", "issue", "sample", "other")


def per_step(run):
    """Each phase's wall and CPU ms a step over the window, as two dicts,
    or None for a training run, a window with no step, or a program
    without the clock."""
    if run["kind"] != "serve":
        return None
    a, b = run["stats_open"], run["stats_close"]
    steps = b["steps"] - a["steps"]
    if "phase_wall_s" not in b or steps <= 0:
        return None
    return tuple({p: (b[key][p] - a[key][p]) * 1e3 / steps for p in b[key]}
                 for key in ("phase_wall_s", "phase_cpu_s"))
