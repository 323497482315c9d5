#!/usr/bin/env python3
"""Where a new GPU process's first GPT-2 124M training step goes.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/worker_start.py [--rounds N]

Each round starts fresh processes, one per variant, and prints each
stage's seconds on the host clock: ``import torch``, the CUDA context,
the port's modules and kernels, the model (``chip_smoke.main_path_parts``:
seed-0 weights, B16 T1024), the first step and the second, and which of
``torch._dynamo``, sympy and ``torch.distributed.tensor`` the process had
imported by then.  The variants:

- ``port``: the port as it is (``ops.remat.checkpoint``);
- ``torch checkpoint``: the model's remat through
  ``torch.utils.checkpoint`` and ``torch.distributed.tensor`` imported
  before the step, as the port did before ``ops.remat``;
- ``dynamo first``: ``import torch._dynamo`` timed on its own after
  CUDA, then the port's step.

Then one round through the runtime: a ``num_gpus=1`` actor created on a
fresh cluster runs the ``port`` stages, its creation included.  The
script builds the kernels first and exits 0 unless a stage raises.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = r'''
import json, os, sys, time
sys.path.insert(0, ROOT)


def stages(variant, created):
    out = {"to_first_line": time.time() - created}
    t = time.time()
    import torch
    out["import_torch"] = time.time() - t
    t = time.time()
    torch.empty(1, device="cuda")
    out["cuda"] = time.time() - t
    if variant == "dynamo first":
        t = time.time()
        import torch._dynamo  # noqa: F401
        out["import_dynamo"] = time.time() - t
    t = time.time()
    import chip_smoke
    from ray_tpu_torch.ops import _kernels
    _kernels.library()
    if variant == "torch checkpoint":
        import torch.distributed.tensor  # noqa: F401
        from torch.utils.checkpoint import checkpoint
        from ray_tpu_torch.models import gpt2
        gpt2.checkpoint = lambda fn, *a: checkpoint(fn, *a,
                                                    use_reentrant=False)
    out["modules_kernels"] = time.time() - t
    t = time.time()
    cfg, state, step, data = chip_smoke.main_path_parts()
    torch.cuda.synchronize()
    out["model"] = time.time() - t
    for name in ("step1", "step2"):
        t = time.time()
        state, m = step(state, data)
        torch.cuda.synchronize()
        out[name] = time.time() - t
    out["imported"] = [n for n in ("torch._dynamo", "sympy",
                                   "torch.distributed.tensor")
                       if n in sys.modules]
    out["loss"] = float(m["loss"])
    return out
'''.replace("ROOT", repr(ROOT))

VARIANTS = ("port", "torch checkpoint", "dynamo first")


def fresh(variant: str) -> dict:
    created = time.time()
    code = STAGES + (f"\nprint('STAGES ' + json.dumps(stages("
                     f"{variant!r}, {created!r})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("STAGES ")]
    if r.returncode != 0 or not line:
        raise RuntimeError(f"{variant}: {r.stdout}{r.stderr}")
    return json.loads(line[0][len("STAGES "):])


class Starter:
    def run(self, created):
        scope = {}
        exec(STAGES, scope)
        return scope["stages"]("port", created)


def show(what: str, got: dict) -> None:
    print(f"  {what}: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in got.items()), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    from ray_tpu_torch.ops import _kernels

    _kernels.build()
    for i in range(args.rounds):
        print(f"round {i + 1}: fresh processes (seconds, host clock)")
        for variant in VARIANTS:
            show(variant, fresh(variant))
    import ray_tpu_torch as rt

    rt.init(mode="cluster", num_cpus=4)
    try:
        created = time.time()
        actor = rt.remote(num_gpus=1)(Starter).remote()
        got = rt.get(actor.run.remote(created), timeout=600)
        got["created_to_step2"] = time.time() - created
        show("num_gpus=1 actor", got)
        rt.kill(actor)
    finally:
        rt.shutdown()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
