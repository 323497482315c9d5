"""A short ``torch.profiler`` capture, reduced to what the metrics read.

``Capture`` profiles the CPU and the card around a block and keeps the
events in memory (the profiler's own list, nothing written to disk).
``summarize`` turns them into:

- ``window_s``: from the first host event to the last event's end;
- ``busy_s``: the union of the device's kernels, copies and sets;
- ``kernels``: {name: (launches, device seconds)};
- ``device_ops``: the ten names that took most device time;
- ``idle_gaps``: the device's idle time between its operations, summed
  by what the host was running at each gap's middle (the innermost
  operator, else the CUDA runtime call, else ``host``), ten largest;
- ``host_wait_s``: the host's time blocked on the card (a full launch
  queue, a synchronisation), so that the window less it is the time the
  host spent issuing work.

Names in ``device_ops`` and ``idle_gaps`` are cut to ``NAME_CHARS``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]          # (name, start s, end s)
NAME_CHARS = 160
# Host events in which the host waits for the card.
WAITS = ("Command Buffer Full", "cudaDeviceSynchronize",
         "cudaStreamSynchronize", "cudaEventSynchronize")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(points: List[float], events: Sequence[Interval]
               ) -> List[Optional[str]]:
    """For each time in ``points`` (sorted), the name of the latest
    started event that covers it, or None: one sweep over the events."""
    import heapq

    order = sorted(range(len(events)), key=lambda i: events[i][1])
    active: List[Tuple[float, float, int]] = []   # (-start, end, index)
    out: List[Optional[str]] = []
    j = 0
    for t in points:
        while j < len(order) and events[order[j]][1] <= t:
            ev = events[order[j]]
            heapq.heappush(active, (-ev[1], ev[2], order[j]))
            j += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        # the top is now the latest started event that has not ended
        out.append(events[active[0][2]][0] if active else None)
    return out


def summarize(ops: List[Interval], runtime: List[Interval],
              device: List[Interval]) -> Dict[str, object]:
    """Reduce host operators, CUDA runtime calls and device operations
    (each (name, start, end) in seconds on one clock)."""
    host = ops + runtime
    if not host and not device:
        return {"window_s": 0.0, "busy_s": 0.0, "host_wait_s": 0.0,
                "complete": True, "kernels": {},
                "device_ops": [], "idle_gaps": []}
    start = min(ev[1] for ev in (host or device))
    end = max(ev[2] for ev in host + device)
    busy = _union([(max(a, start), min(b, end)) for _n, a, b in device])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in device:
        kernels[name][0] += 1
        kernels[name][1] += b - a
    edges = [start] + [x for ab in busy for x in ab] + [end]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in idle]
    by_op, by_call = _innermost(mids, ops), _innermost(mids, runtime)
    gaps: Dict[str, float] = defaultdict(float)
    for (a, b), op, call in zip(idle, by_op, by_call):
        gaps[op or call or "host"] += b - a
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    launches = sum(1 for name, _a, _b in runtime if "LaunchKernel" in name)
    computed = sum(1 for name, _a, _b in device
                   if not name.startswith(("Memcpy", "Memset")))
    waits = _union([(a, b) for name, a, b in host if name in WAITS])
    return {
        "window_s": end - start,
        "busy_s": sum(b - a for a, b in busy),
        "host_wait_s": sum(b - a for a, b in waits),
        # a capture can lose the card's kernel records (seen once while
        # another thread launched): then it holds far fewer kernels than
        # the host launched, and is not read
        "complete": computed >= 0.5 * launches,
        "kernels": {k: (int(v[0]), v[1]) for k, v in kernels.items()},
        "device_ops": [[k[:NAME_CHARS], v[1]] for k, v in top],
        "idle_gaps": [[k[:NAME_CHARS], v] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


class Capture:
    """``with Capture(device) as cap: ...`` then ``cap.summary``.  On a
    card the block's end synchronises before the profiler stops."""

    def __init__(self, device):
        self.device = device
        self.summary: Optional[Dict[str, object]] = None

    def __enter__(self) -> "Capture":
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(*split_events(
                self._prof.profiler.kineto_results.events()))
        self._prof = None


def split_events(events) -> Tuple[List[Interval], List[Interval],
                                  List[Interval]]:
    """Kineto events -> (host operators, CUDA runtime calls, device
    operations), in seconds."""
    from torch.autograd import DeviceType

    ops, runtime, device = [], [], []
    for ev in events:
        a, b = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        name = ev.name()
        if name.startswith("void "):
            name = name[5:]
        if ev.device_type() == DeviceType.CUDA:
            device.append((name, a, b))
        elif name.startswith("cuda") or name.startswith("cu"):
            runtime.append((name, a, b))
        elif not name.startswith("PyTorch Profiler") and b > a:
            ops.append((name, a, b))
    return ops, runtime, device


def complete_capture(device, block, tries: int = 3) -> Dict[str, object]:
    """The summary of a capture around ``block()`` that holds the card's
    kernels, capturing again (``block`` runs again) where one lost
    them."""
    for _ in range(tries):
        with Capture(device) as cap:
            block()
        if cap.summary["complete"]:
            return cap.summary
    raise RuntimeError(f"{tries} captures in a row lost the card's "
                       "kernel records")


def warm(device) -> None:
    """Start the profiler once, so that its first start (CUPTI's set-up)
    falls in set-up and not in a captured window."""
    import torch

    with Capture(device):
        torch.ones(1, device=device).add_(1)
