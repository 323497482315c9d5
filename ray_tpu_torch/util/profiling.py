"""On-demand worker profiling: stack dumps, a sampling profiler, and a
dependency-free SVG flamegraph renderer.

Role-equivalent to the reference's dashboard profiling actions (ref:
dashboard/modules/reporter/profile_manager.py:121 py-spy flamegraph,
:189 memray) — redesigned in-process: this image ships no py-spy, so
the worker samples its own threads via sys._current_frames() (same
sampling principle, no ptrace needed) and the dashboard renders the
folded stacks as an SVG.  Stack dumps use the live frame objects
directly, like py-spy --dump.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import Counter
from typing import Dict, List, Optional, Tuple


def dump_stacks() -> str:
    """Formatted stacks of every thread in this process."""
    out: List[str] = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {ident} ({names.get(ident, '?')}) ---")
        out.extend(line.rstrip() for line in
                   traceback.format_stack(frame))
    return "\n".join(out)


def torch_capture(duration_s: float, log_dir: str
                  ) -> Tuple[str, Dict[str, int]]:
    """A ``torch.profiler`` capture of this process for ``duration_s``,
    written as a Chrome trace to ``<log_dir>/trace.json``; returns its
    path and the device kernels it holds by name and launch count.

    It records every thread's host operators and scopes (a train loop's,
    the generation engine's ``engine.*`` phases), not only the calling
    thread's, which is all a default capture holds; the card's activity
    is the whole process's either way."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        time.sleep(duration_s)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = Counter(e["name"] for e in events if e.get("cat") == "kernel")
    return path, dict(kernels)


def sample_profile(duration_s: float = 2.0, hz: float = 100.0,
                   exclude_threads: Optional[List[str]] = None
                   ) -> Dict[str, int]:
    """Sample all threads for ``duration_s``; returns folded stacks
    ("outer;inner;leaf" -> sample count), the flamegraph input format.

    Runs inline in the calling thread (the worker's RPC loop), so the
    sampled task threads keep executing undisturbed.
    """
    exclude = set(exclude_threads or [])
    exclude.add(threading.current_thread().name)
    folded: Counter = Counter()
    period = 1.0 / hz
    deadline = time.monotonic() + duration_s
    names = {}
    while time.monotonic() < deadline:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            name = names.get(ident, "?")
            if name in exclude:
                continue
            stack: List[str] = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}"
                             f":{f.f_lineno})")
                f = f.f_back
            folded[f"{name};" + ";".join(reversed(stack))] += 1
        time.sleep(period)
    return dict(folded)


# ------------------------------------------------------------ flamegraph
_COLORS = ["#e4593b", "#e67e22", "#e6a23c", "#d8b446", "#c8742f"]


class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.children: Dict[str, _Node] = {}


def _build_trie(folded: Dict[str, int]) -> _Node:
    root = _Node("all")
    for stack, count in folded.items():
        root.value += count
        node = root
        for part in stack.split(";"):
            child = node.children.get(part)
            if child is None:
                child = node.children[part] = _Node(part)
            child.value += count
            node = child
    return root


def render_flamegraph_svg(folded: Dict[str, int],
                          title: str = "profile") -> str:
    """Folded stacks -> standalone SVG flamegraph (widths proportional
    to sample counts, one row per stack depth, hover shows counts)."""
    root = _build_trie(folded)
    total = max(root.value, 1)
    width, row_h, char_w = 1200.0, 18, 6.7
    rects: List[str] = []

    def esc(s: str) -> str:
        return (s.replace("&", "&amp;").replace("<", "&lt;")
                .replace(">", "&gt;").replace('"', "&quot;"))

    max_depth = [1]

    def layout(node: _Node, x: float, depth: int) -> None:
        w = width * node.value / total
        if w < 1.0:
            return
        max_depth[0] = max(max_depth[0], depth + 1)
        color = _COLORS[hash(node.name) % len(_COLORS)]
        label = esc(node.name) if w > 40 else ""
        label = label[: int(w / char_w)]
        pct = 100.0 * node.value / total
        rects.append(
            f'<g><title>{esc(node.name)} — {node.value} samples '
            f'({pct:.1f}%)</title>'
            f'<rect x="{x:.1f}" y="{depth * row_h}" width="{w:.1f}" '
            f'height="{row_h - 1}" fill="{color}" rx="2"/>'
            f'<text x="{x + 3:.1f}" y="{depth * row_h + 13}" '
            f'font-size="11" font-family="monospace" '
            f'fill="#fff">{label}</text></g>')
        cx = x
        for child in sorted(node.children.values(),
                            key=lambda c: -c.value):
            layout(child, cx, depth + 1)
            cx += width * child.value / total

    layout(root, 0.0, 0)
    height = max_depth[0] * row_h + 30
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
        f'height="{height}" viewBox="0 0 {width:.0f} {height}">'
        f'<text x="4" y="{height - 8}" font-size="12" '
        f'font-family="sans-serif">{esc(title)} — {total} samples'
        f'</text>' + "".join(rects) + "</svg>")
