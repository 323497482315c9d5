"""``python -m ray_tpu_torch.dashboard`` — serve the cluster dashboard."""

import argparse

from . import run_dashboard

parser = argparse.ArgumentParser(prog="ray_tpu_torch.dashboard")
parser.add_argument("--address", default=None)
parser.add_argument("--port", type=int, default=8265)
args = parser.parse_args()
print(f"dashboard on http://0.0.0.0:{args.port}")
run_dashboard(args.address, args.port)
