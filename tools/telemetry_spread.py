#!/usr/bin/env python3
"""Spread of ``chip_smoke.py``'s ``[main path]`` and ``[telemetry]``
phases between rounds on one card, the last round with one busy
process per host core.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/telemetry_spread.py [--rounds N]

It builds the kernels, then runs ``main_path`` and ``telemetry_phase``
``N`` times (default 1) on an idle host and once more beside
``os.cpu_count()`` processes that spin, printing the card's SM clock,
temperature and power around each phase.  A failed ``[telemetry]``
check is printed and the next round runs; the script itself exits 0
unless a phase raises something else.  It shows whether the step is
host-bound on that machine (``[main path]`` prints the host's time to
issue one step to an idle card) and how far the telemetry's checks sit
from their limits there.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.ops import _kernels

    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("telemetry_spread: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"host: {os.cpu_count()} cores, load {os.getloadavg()}")
    _kernels.build()
    card = cs.card_line()
    print(card)
    for rnd in range(args.rounds + 1):
        busy = []
        if rnd == args.rounds:
            busy = [subprocess.Popen([sys.executable, "-c",
                                      "while True: pass"])
                    for _ in range(os.cpu_count())]
        try:
            print(f"== round {rnd}, {len(busy)} busy processes; card "
                  f"{smi()}", flush=True)
            _counts, unsharded = cs.main_path(card)
            cs.free_device_memory()
            print(f"  after [main path]: {smi()}", flush=True)
            try:
                cs.telemetry_phase(card, unsharded)
            except RuntimeError as e:
                print(f"  {e}", flush=True)
            cs.free_device_memory()
            print(f"  after [telemetry]: {smi()}", flush=True)
        finally:
            for p in busy:
                p.kill()
                p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
