"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--control fp8] [--fault <name>] [--seconds S]

For each seed it prints one JSON line with the numbers that decide a
cell's ``correct`` for the program as the cell runs it (the lower
readings), and with ``--control fp8`` (or ``int8``, ``fp8_bf16``: see
``reference/gpt2.py``) also for the reference computed in that
precision in the program's place, or with ``--fault`` for the program
with one fault planted (the upper readings):

- training (no window: only the first steps are compared):
  ``half_batch`` (the loss of half the rows, its mean taken over them),
  ``state_unchanged`` (each step's update skipped);
- serving (a window of ``--seconds`` at the cell's own load):
  ``kv_unchanged`` (no K/V written to the paged cache), ``token_altered``
  (every 20th sampled token replaced by the next id).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def planted(fault: str, vocab: int):
    """Plant ``fault`` in the program for the block's length."""
    if fault in ("", "half_batch"):
        yield
        return
    if fault == "state_unchanged":
        from ray_tpu_torch.train import train_step as ts

        keep = ts.ClippedAdamW.update
        ts.ClippedAdamW.update = lambda self, grads, state, params, \
            norm=None: ts.global_norm(grads)
        try:
            yield
        finally:
            ts.ClippedAdamW.update = keep
        return
    if fault == "kv_unchanged":
        from ray_tpu_torch.llm import kv_cache

        keep = kv_cache.paged_store
        kv_cache.paged_store = lambda k, v, *a, **kw: (k, v)
        try:
            yield
        finally:
            kv_cache.paged_store = keep
        return
    if fault == "token_altered":
        from ray_tpu_torch.llm import engine

        keep = engine.sample
        calls = [0]

        def altered(logits, params=None, rng=None):
            calls[0] += 1
            tok = keep(logits, params, rng)
            return (tok + 1) % vocab if calls[0] % 20 == 0 else tok

        engine.sample = altered
        try:
            yield
        finally:
            engine.sample = keep
        return
    raise SystemExit(f"unknown fault {fault!r}")


def train_readings(cell, seed: int, device, control: str, fault: str):
    from benchmark.harness import train as T
    from benchmark.harness import weights as W

    cfg = cell.config
    rows = cell.traffic["batch"]
    with planted(fault, cfg["vocab_size"]):
        prog = T.Program(cfg, seed, device,
                         loss_rows=rows // 2 if fault == "half_batch"
                         else None)
        feed = W.TokenFeed(seed, rows, cell.traffic["seq"] + 1,
                           cfg["vocab_size"], device)
        batches, losses, grad, change = T.first_steps(
            prog, cfg, feed, cell.traffic["first_steps"], seed, device)
        read = {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}
        del prog
    T._free(device)
    ref = T.reference_readings(cfg, seed, batches, device)
    out = {"program": T.compare(read, ref),
           "pieces_left_out": int((~T.counted(ref)).sum()),
           "worst_pieces": T.worst_pieces(cfg, read, ref)}
    if control:
        low = T.reference_readings(cfg, seed, batches, device, control)
        out["control_readings"] = T.compare(low, ref)
        out["control_worst_pieces"] = T.worst_pieces(cfg, low, ref)
    return out


def serve_readings(cell, seed: int, device, control: str, fault: str,
                   seconds: float):
    from benchmark.harness import serve as S

    with planted(fault, cell.config["vocab_size"]):
        run = S.run(cell, seed, seconds, False, device, time.time(),
                    control=control or None)
    out = {"program": run["checks"], "failed": run["failed"],
           **run["info"]}
    if control:
        out["control_readings"] = {"logit_gap": run["control_gap"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="",
                    choices=("", "fp8", "int8", "fp8_bf16"))
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env
    from benchmark.harness.spec import load_cell

    env.set_cache_dirs()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card {env.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        if cell.traffic["kind"] == "train":
            out = train_readings(cell, seed, device, args.control,
                                 args.fault)
        else:
            out = serve_readings(cell, seed, device, args.control,
                                 args.fault, args.seconds)
        out.update(workload=cell.name, seed=seed, fault=args.fault,
                   precision=args.control or "program",
                   seconds=time.time() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
