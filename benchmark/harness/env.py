"""The process around a run: its start time, its cache directories, the
card it runs on, and the modules it must not hold."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List

from .spec import ROOT

# Top-level module names that no run may load: the JAX package and JAX.
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")
CACHE = ROOT / ".bench_cache"


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from
    ``/proc`` (10 ms ticks), so that set-up counts the interpreter's own
    start and every import; the first caller's clock where ``/proc`` is
    missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        started = int(fields[19]) / ticks          # since boot
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a cell's first run there builds.  The port
    builds its CUDA kernels into ``ray_tpu_torch/_build/<hash>/`` by
    itself; Triton and torch extensions, where anything loads them,
    cache here.  ``USE_FLAX=0`` keeps libraries from loading JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or ''."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return ""


def after_window(device) -> None:
    """Note on standard error the state of the card and the speed of the
    host as the window closes: the SM clock against its maximum, the
    temperature and the power drawn, and the time of a fixed loop of
    Python.  A run that reads far from the others is told apart by
    them."""
    t0 = time.perf_counter()
    total = 0
    for i in range(300_000):
        total += i * i
    loop_ms = 1e3 * (time.perf_counter() - t0)
    card = "cpu"
    if device.type == "cuda":
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "temperature.gpu,power.draw", "--format=csv,noheader"],
                capture_output=True, text=True,
                timeout=20).stdout.strip().replace("\n", "; ")
        except (OSError, subprocess.SubprocessError):
            card = ""
    print(f"after window: card {card}; host loop {loop_ms:.1f} ms",
          file=sys.stderr)


def device_info(device, chips: int) -> Dict[str, object]:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def phase(t_start: float, label: str) -> None:
    """Note on standard error how far set-up has come."""
    print(f"setup: {label} at {time.time() - t_start:.3f} s",
          file=sys.stderr)


def device_memory(device) -> str:
    import torch

    if device.type != "cuda":
        return "cpu"
    return (f"{torch.cuda.memory_allocated(device) / 2**30:.3f} GiB "
            f"allocated, {torch.cuda.memory_reserved(device) / 2**30:.3f} "
            "GiB reserved")
