#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--profile]

It builds the hand-written CUDA kernels from ``ray_tpu_torch/csrc/``
(one ``nvcc`` per source, in parallel), holds each against its plain
PyTorch version at small shapes (T = 64 and 320 leave partial 128-row
tiles; B*H = 144 gives the persistent blocks several rounds) and at the
GPT-2 pretraining shape, then drives the main path
(GPT-2 124M training steps, flash attention, remat, chunked cross
entropy, clip + AdamW) and checks that every step went through the
kernels.

Right after the main path, ``[telemetry]`` runs the same training
(weights, tokens, 1 + 10 steps) through the measurement plane:
``make_sharded_train_step(mesh=None, telemetry=True)`` (the goodput
ledger and the xprof harvest of the first call), fed by
``TrainSession.iter_device_batches`` from pinned host batches, with
``session.report`` after every call.  It prints the goodput phases, the
harvested program (FLOPs, bytes, memory, the flash kernels' part) and
its roofline report, the forward/backward/optimizer decomposition and
the device-memory gauges, and fails unless the losses equal the main
path's bit for bit, launches are 24/12/12 a step, the session's MFU
(the median of its per-step readings) is within 5% of the CUDA-event
MFU, the flash FLOPs equal launches x ``flash_cost`` and the total lies
in ``HARVEST_BAND``, the decomposition keeps its structure, the host
time that the plane adds to a step (``plane_host_cost``) is under 2% of
the main path's step and the peak gauge equals the allocator's peak.  The
later phases check their series too: ``[sharded]`` the NCCL group's
eager-op latencies (each at least the op's CUDA-event time),
``[checkpoint]`` the save and restore series and goodput, ``[serve]
GPT-2 124M`` the engine's counters, TTFT phases, request spans, page
gauges and registered programs over the load.

Beside the main path, two more checks of the flash kernels and two
training phases of the distributed slice:

- ``[kernels] lse cotangent``: ``flash_attention_with_lse`` at the
  main-path shape with a random lse cotangent (the one ring attention
  feeds the backward kernels), causal and not, against the float32
  plain version under the kernel gate;
- ``[sharded]``: the main path's step through ``setup_distributed_mesh``
  (a world-1 NCCL gang), ``shard_state`` (DTensor parameters and
  moments) and ``make_sharded_train_step`` with ring attention over the
  one-device ``seq`` axis: first loss within 1e-2 of the unsharded
  step's, launches 24/12/12 a step, ms/step beside the unsharded one;
- ``[ring]``: 2 and 4 processes sharing the card in a gloo group run
  ring (flash) and Ulysses attention at B4 T4096 H12 D64; the gathered
  outputs and gradients against the single-process flash attention
  under the kernel gate, and each rank's launches.

Then the runtime and the trainer (``ray_tpu_torch.core``,
``ray_tpu_torch.train``):

- ``[runtime]``: ``init(mode="cluster")`` detects as many ``GPU`` as
  ``nvidia-smi`` lists; ``num_gpus=1`` actors see their lease's id in
  ``CUDA_VISIBLE_DEVICES`` and the card; with every GPU leased one more
  stays pending until a holder is killed and then gets its id; a task's
  bf16 CUDA tensor reaches the driver's host memory bit-equal; a
  ``torch.profiler`` capture of an actor running 3 main-path steps
  holds all three flash kernels;
- ``[trainer]``: ``TorchTrainer(ScalingConfig(num_workers=1,
  use_gpu=True))`` runs the main path's 1 + 10 steps in a runtime
  worker holding the leased GPU, with ``train.report`` every step
  (11 reports, launches 24/12/12 a step, losses within 1e-3 of the main
  path's); at 2 layers a world-2 gloo gang on GPU halves (first loss
  within 1e-2 of one worker's) and a restart from a checkpoint after a
  hard exit (losses within 1e-3 of the uninterrupted run).

Then the serving path (``ray_tpu_torch.llm``: the continuous-batching
engine over the paged KV cache, plain PyTorch, no kernel of its own)
runs in three phases, each through ``LLMDeployment.__call__`` after the
engine's warmup, with ``bench.py --serve-llm``'s engine configuration
(page 16, 256 pages, batch 8, prefill budget 512):

- ``[serve] GPT-2 124M``: bf16, random weights from seed 0, 8 client
  threads with 4 requests each, prompts of 16 tokens, 32 greedy tokens
  per request.  Every request must end with 32 tokens and reason
  "length", no error frame, no step error, every page free at the end,
  and each greedy token of two requests within 0.1 of the top logit of
  the non-cached forward on the same weights.
- ``[serve] GPT-2 124M float32``: two requests of 8 tokens whose tokens
  must equal the non-cached full forward's greedy tokens.
- ``[serve] Llama-2-7B widths``: Meta's Llama 2 7B widths at full depth
  (bf16, random weights), the first phase's load and checks.

The two bf16 phases print tokens/s, TTFT and TPOT percentiles, decode
MFU, peak device memory, the engine's stats and one batch-8 decode
forward's host time, CUDA-event time and kernel breakdown
(``torch.profiler``); the float32 phase, too small a load for such
numbers, prints its checks and the engine's stats.

Last, ``[serve plane]`` serves the first phase's model, load and
checks through the port's serve plane (``ray_tpu_torch.serve``):
``serve.run(llm_deployment(..., num_gpus=1))`` on a cluster runtime,
every request streamed through ``DeploymentHandle.stream``; then the
stdlib HTTP ingress (frames equal the handle's, a client disconnect
frees every page, the error frame, 404; gRPC where ``grpc`` imports),
the cluster read back (``util.telemetry.cluster_summary`` counts the
tokens and the ingress requests, ``util.xprof.cluster_report`` lists
the engine's programs) and two ``num_gpus=0.5`` replicas on the card.
It prints its serving numbers beside ``[serve] GPT-2 124M``'s of the
same run (see ``serve_plane``).  The serving path launches no
hand-written kernel.  Any failure exits non-zero; with no CUDA device
it exits 1 before doing anything.

Output, last lines: one JSON line ``{"kernels": [...]}`` with each
kernel's launches on the main path, error against its plain version,
times and bound; one JSON line ``{"telemetry": {...}}`` with
``[telemetry]``'s numbers; one JSON line ``{"serving": [...]}`` with
each serve phase's numbers; one JSON line ``{"runtime": {...}}`` with
``[runtime]``'s and ``[trainer]``'s; one JSON line
``{"serve_plane": {...}}`` with ``[serve plane]``'s; the card's name and
power limit
(``nvidia-smi``); and
last ``{"ok": true, "device": {...}}``.  ``--profile`` adds a
device-time breakdown of two more training steps, unsharded and sharded
(see ``profile_steps``).
"""

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import threading
import time

# H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# GPT-2 124M at its published widths (OpenAI GPT-2 small).
GPT2_124M = dict(n_layer=12, n_head=12, d_model=768, d_ff=3072,
                 vocab_size=50257, max_seq=1024)

SOURCES = {
    "flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
    "flash_dkv": "ray_tpu_torch/csrc/flash_dkv.cu",
    "flash_dq": "ray_tpu_torch/csrc/flash_dq.cu",
}
REPLACES = {
    "flash_fwd": "ray_tpu/ops/flash_attention.py:45",   # _fwd_kernel
    "flash_dkv": "ray_tpu/ops/flash_attention.py:128",  # _dkv_kernel
    "flash_dq": "ray_tpu/ops/flash_attention.py:174",   # _dq_kernel
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(kernel: str, bh: int, t: int, d: int, causal: bool):
    """Least time on the card for the work of one call, from its shapes:
    the larger of the bf16 matrix-product operations over the tensor-core
    peak and the bytes (each input read once, each output written once)
    over the HBM rate, both from ``flash_cost`` (the formula the xprof
    harvest counts).  Returns (ms, "operations" | "bytes", FLOPs)."""
    from ray_tpu_torch.ops.flash_attention import flash_cost

    flops, nbytes = flash_cost(kernel, bh, t, d, causal)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes"), flops


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def attention_inputs(b, t, h, d, seed):
    """Random bf16 q, k, v, dO on the card: q, k, v are column slices of
    one [B, T, 3*H*D] tensor, the layout the model hands the kernels."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    q, k, v = (z.unflatten(-1, (h, d)) for z in qkv.split(h * d, dim=-1))
    do = torch.randn((b, t, h, d), generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    return q, k, v, do


def check_kernels(b, t, h, d, causal, seed, timed):
    """Each kernel against its plain version on the same bf16 inputs
    (``attention_inputs``).  Both are judged against the plain version
    run in float32 on the same (upcast) inputs: the kernel's error must
    stay within twice the bf16 plain version's error plus 2^-8 of the
    reference's peak (1e-5 for the fp32 lse)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.flash_attention import (flash_dkv_plain,
                                                   flash_dq_plain,
                                                   flash_fwd_plain)

    q, k, v, do = attention_inputs(b, t, h, d, seed)
    f32 = [x.float() for x in (q, k, v, do)]
    scale = d ** -0.5
    # The model's call: whole-sequence blocks, clamped to T.
    plain_kw = dict(scale=scale, causal=causal, block_q=t, block_k=t)
    kern_kw = dict(scale=scale, causal=causal)

    o_ref, lse_ref = flash_fwd_plain(*f32[:3], **plain_kw)
    delta = (f32[3] * o_ref).sum(-1).transpose(1, 2).contiguous()
    runs = {
        "flash_fwd": (lambda: _kernels.flash_fwd(q, k, v, **kern_kw),
                      lambda: flash_fwd_plain(q, k, v, **plain_kw),
                      (o_ref, lse_ref)),
        "flash_dkv": (
            lambda: _kernels.flash_dkv(q, k, v, do, lse_ref, delta,
                                       **kern_kw),
            lambda: flash_dkv_plain(q, k, v, do, lse_ref, delta,
                                       **plain_kw),
            flash_dkv_plain(*f32, lse_ref, delta, **plain_kw)),
        "flash_dq": (
            lambda: (_kernels.flash_dq(q, k, v, do, lse_ref, delta,
                                       **kern_kw),),
            lambda: (flash_dq_plain(q, k, v, do, lse_ref, delta,
                                       **plain_kw),),
            (flash_dq_plain(*f32, lse_ref, delta, **plain_kw),)),
    }
    results = {}
    for name, (kernel, plain, ref) in runs.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        errs = []
        for g, p, r in zip(got, want, ref):
            if g.shape != r.shape or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: bad output {tuple(g.shape)}")
            err_k, err_p = max_abs(g, r), max_abs(p, r)
            # 2^-8 of the peak for bf16 outputs, 1e-5 for fp32 (lse).
            rel = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-5
            tol = 2 * err_p + rel * float(r.abs().max())
            print(f"  {name} B{b} T{t} H{h} D{d} causal={causal}: "
                  f"|kernel-ref| {err_k:.3e}  |plain-ref| {err_p:.3e}  "
                  f"tol {tol:.3e}  |kernel-plain| {max_abs(g, p):.3e}")
            if not err_k <= tol:
                raise RuntimeError(f"{name}: kernel error {err_k} over "
                                   f"tolerance {tol}")
            errs.append(max_abs(g, p))
        results[name] = {"max_abs_err": max(errs)}
        if not timed:
            continue
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        b_ms, b_by, flops = bound(name, b * h, t, d, causal)
        results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
        print(f"  {name}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if timed:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        lib = results["flash_fwd"]["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   is_causal=causal), 20)
        # No single library call computes dK/dV or dQ alone; the SDPA
        # backward (dQ, dK and dV together) is a yardstick for their sum.
        qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        dout = do.transpose(1, 2)
        bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), dout, retain_graph=True), 20)
        print(f"  library: sdpa forward {lib:.4f} ms, sdpa backward "
              f"(dq+dk+dv) {bwd:.4f} ms")
    return results


MATMUL_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")


def device_profile(fn, n: int):
    """Run ``fn`` ``n`` times under ``torch.profiler``; returns the
    device time and launches by kernel name ({name: [us, count]}), the
    device's busy time (union of the kernel intervals) and the wall time
    on the host clock, both in us.  None when the profiler traced no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += us
        row[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return by_name, busy, wall_us


def group_kernels(by_name, groups, rest: str):
    """Device us by group: a kernel joins the first group one of whose
    keys its name contains, else ``rest``."""
    sums = {g: 0.0 for g in list(groups) + [rest]}
    for name, (us, _count) in by_name.items():
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), rest)
        sums[group] += us
    return sums


def profile_steps(step, state, data, n: int = 2) -> None:
    """--profile: device time by kernel over ``n`` more steps, from
    ``torch.profiler``, grouped into the attention kernels, matrix
    products, the optimizer's multi-tensor kernels and the rest, and the
    device's busy share of the window (host clock)."""
    prof = device_profile(lambda: step(state, data), n)
    if prof is None:
        print("  profile: the profiler traced no device time")
        return
    by_name, busy, wall_us = prof
    sums = group_kernels(
        by_name,
        {"flash attention kernels": ("fwd_kernel", "dkv_kernel",
                                     "dq_kernel"),
         "matrix products (cuBLAS)": MATMUL_KERNELS,
         "optimizer (multi-tensor)": ("multi_tensor_apply",)},
        "elementwise, reductions, copies")
    total = sum(sums.values())
    print(f"  profile of {n} steps: device busy {busy / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({busy / wall_us:.4f}); kernel "
          f"time per step {total / n / 1e3:.3f} ms")
    for group, us in sums.items():
        print(f"    {group}: {us / n / 1e3:.3f} ms/step "
              f"({us / total:.4f})")
    print("  top kernels (ms/step, launches/step):")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:25]:
        print(f"    {us / n / 1e3:9.3f} {count // n:5d}  {name[:110]}")


def main_path(card: str, profile: bool = False):
    """GPT-2 124M pretraining steps at B16, T1024 through the port's
    entry points; returns the kernels' launch counts."""
    import torch

    from ray_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                           gpt2_loss_fn)
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                                make_train_step)

    cfg = GPT2Config(**GPT2_124M, remat=True, attn_impl="flash")
    batch, warm, steps = 16, 1, 10
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           generator=gen, device="cuda")

    # Output check against the dense-attention model on the same weights
    # (the repo's own bound, tests/test_ops.py: |flash - dense| < 1e-2),
    # and a random-init loss near ln(V).
    dense = dataclasses.replace(cfg, attn_impl="dense")
    small = {"tokens": tokens[:2]}
    with torch.no_grad():
        l_flash = float(gpt2_loss_fn(cfg, model, small, loss_chunk=256))
        l_dense = float(gpt2_loss_fn(dense, model, small, loss_chunk=256))
    print(f"  loss at init: flash {l_flash:.6f} dense {l_dense:.6f} "
          f"ln(V) {math.log(cfg.vocab_size):.6f}")
    if not abs(l_flash - l_dense) < 1e-2 \
            or not abs(l_flash - math.log(cfg.vocab_size)) < 0.5:
        raise RuntimeError("flash loss disagrees with dense / ln(V)")

    optimizer = make_optimizer(total_steps=1000)
    state = TrainState.create(model, optimizer)
    step = make_train_step(
        lambda m, b: gpt2_loss_fn(cfg, m, b, loss_chunk=256), optimizer)
    data = {"tokens": tokens}
    metrics = []
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    for _ in range(warm):
        state, m = step(state, data)
        metrics.append(m)
    # Steps run back to back, as in training; a CUDA event at each step
    # boundary gives per-step device times without a sync in the loop.
    bounds = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounds[0].record()
    for i in range(steps):
        state, m = step(state, data)
        bounds[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_kernels.launches)

    total = warm + steps
    want = {"flash_fwd": 2 * cfg.n_layer * total,
            "flash_dkv": cfg.n_layer * total,
            "flash_dq": cfg.n_layer * total}
    if counts != want:
        raise RuntimeError(f"kernel launches {counts}, expected {want}")
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"non-finite loss/grad_norm {losses} {norms}")
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(bounds, bounds[1:]))
    median = (step_ms[(steps - 1) // 2] + step_ms[steps // 2]) / 2
    tok_s = batch * cfg.max_seq * steps / wall
    mfu = tok_s * cfg.flops_per_token() / PEAK_BF16_FLOPS
    print(f"  losses {losses}")
    print(f"  grad_norms {norms}")
    print(f"  {steps} steps back to back: {1e3 * wall / steps:.3f} ms/step "
          f"(host clock); per-step device time median {median:.3f} ms, "
          f"min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}; "
          f"{tok_s:.1f} tokens/s, MFU "
          f"{mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 "
          f"(card: {card}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches over {total} steps: {counts} "
          f"(per step 24 fwd / 12 dK,dV / 12 dQ)")
    # The host's time to issue one step to an idle card: where it
    # exceeds the step's device time, the steps above were host-bound.
    issue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _m = step(state, data)
        issue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    print(f"  host issues one step to an idle card in "
          f"{sorted(issue)[1]:.3f} ms (median of {[round(x, 3) for x in issue]}; card: {card})")
    if profile:
        profile_steps(step, state, data)
    return counts, {"first_loss": losses[0], "median_ms": median,
                    "tokens_per_s": tok_s, "losses": losses}


def registry_series():
    """The port's metrics registry as {(name, sorted tags): value}, a
    histogram's value being (count, sum)."""
    from ray_tpu_torch.util.metrics import registry

    out = {}
    for snap in registry().snapshot():
        for s in snap["series"]:
            key = (snap["name"], tuple(sorted(s["tags"].items())))
            out[key] = ((s["hist"]["count"], s["hist"]["sum"])
                        if "hist" in s else s["value"])
    return out


def need(series, name: str, **tags):
    """One series of ``registry_series()``; a missing one fails the run
    (telemetry swallows its own errors, so a series that never came is
    how a telemetry fault shows)."""
    key = (name, tuple(sorted(tags.items())))
    if key not in series:
        raise RuntimeError(f"telemetry series {name}{tags} is missing")
    return series[key]


# [telemetry]: the harvested FLOPs of the main path's step over
# flops_per_token() x B x T, from the shapes (PERF.md section 6): remat's
# block forward again (early-stopped before mlp_out), the chunked loss's
# four logits products, the flash kernels' visible pairs.
HARVEST_BAND = (1.19, 1.22)          # predicted 1.2053


def telemetry_phase(card: str, unsharded: dict):
    """[telemetry] The main path at full width and depth (GPT-2 124M,
    B16 T1024, flash + remat, chunk 256; seed-0 weights and tokens,
    the main path's) through the measurement plane:
    ``make_sharded_train_step(mesh=None, telemetry=True)`` fed by
    ``TrainSession.iter_device_batches`` (depth 2) from pinned host
    batches, ``session.report`` after every call, one call then 10.
    Checks: (a) the losses equal [main path]'s bit for bit; (b) 24/12/12
    launches a step; (c) the session's ``rt_train_mfu``, the median of
    its ten per-step readings (each is one report interval on the host
    clock), within 5% of the MFU of the CUDA-event step median; (d) the
    harvested flash
    FLOPs equal launches x ``flash_cost`` exactly and the total over
    ``flops_per_token() x 16384`` within ``HARVEST_BAND``; (e) the
    decomposition's shares sum to 1 within 0.05, the optimizer's under
    0.15, backward above forward; (f) ``compile`` entered once and
    ``compute`` 10 times, the plane's host cost per step
    (``plane_host_cost``) under 2% of [main path]'s median step,
    ``data_stall`` under 0.02 of the ten steps' wall time; (g) the
    ``peak`` device-memory gauge equal to the allocator's peak.

    The compute median is printed beside [main path]'s but not held to
    it: where the host dispatches the step's ~2,700 launches slower
    than the card runs them, both phases are host-bound and two runs of
    the same code differ by more than 2% (PERF.md section 6, PR 7)."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss_fn
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.flash_attention import flash_cost
    from ray_tpu_torch.train.config import TelemetryConfig
    from ray_tpu_torch.train.session import TrainSession
    from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                                make_sharded_train_step)
    from ray_tpu_torch.util import goodput, spans, xprof

    cfg = GPT2Config(**GPT2_124M, remat=True, attn_impl="flash")
    batch, steps = 16, 10
    per_step = batch * cfg.max_seq
    fpt = cfg.flops_per_token()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           generator=gen, device="cuda")
    host = [tokens.cpu().pin_memory() for _ in range(1 + steps)]
    del tokens
    optimizer = make_optimizer(total_steps=1000)
    state = TrainState.create(model, optimizer)

    def loss_fn(m, b):
        return gpt2_loss_fn(cfg, m, b, loss_chunk=256)

    step = make_sharded_train_step(loss_fn, optimizer, mesh=None,
                                   telemetry=True)
    session = TrainSession(0, 1, 0, 1, 0, "telemetry",
                           telemetry=TelemetryConfig(fpt, per_step))
    goodput.reset()
    spans.reset()
    xprof._reset_local()
    _kernels.reset_launches()
    bounds = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    out, sess_mfus = [], []
    t0 = time.perf_counter()
    for i, b in enumerate(session.iter_device_batches(
            ({"tokens": t} for t in host), depth=2)):
        state, m = step(state, b)
        bounds[i].record()
        if i == 0:
            first_s, t1 = time.perf_counter() - t0, time.perf_counter()
        session.report({"step": i + 1, "loss": m["loss"]})
        if i:   # the gauge is one report interval: read each step's
            sess_mfus.append(need(registry_series(), "rt_train_mfu"))
        out.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = dict(_kernels.launches)
    losses = [float(x) for x in out]
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(bounds, bounds[1:]))
    med = median(step_ms)
    series = registry_series()
    led = goodput.ledger().snapshot()
    phase_spans = [sp["name"] for sp in spans.snapshot()
                   if sp["cat"] == "phase"]
    prog = xprof.local_programs()["train_step"]

    print(f"  first call (compile: harvest) {first_s:.3f} s; {steps} "
          f"compute steps: CUDA-event median {med:.3f} ms (min "
          f"{step_ms[0]:.3f}, max {step_ms[-1]:.3f}) against [main path]'s "
          f"{unsharded['median_ms']:.3f} ({med / unsharded['median_ms']:.4f}"
          f"x), host clock {1e3 * wall / steps:.3f} ms/step (card: {card})")
    total = max(led["total"], 1e-9)
    print("  goodput seconds (share): " + ", ".join(
        f"{p} {v:.4f} ({v / total:.4f})" for p, v in led["seconds"].items()))
    flash = sum(k["flops"] for k in prog["kernels"].values())
    ratio = prog["flops"] / (fpt * per_step)
    print(f"  train_step harvested: {prog['flops'] / 1e12:.6f} TFLOP "
          f"({ratio:.4f}x flops_per_token x {per_step}; flash kernels "
          f"{flash / 1e12:.6f}, {flash / prog['flops']:.4f}), "
          f"{prog['bytes'] / 1e9:.3f} GB accessed; memory " + ", ".join(
              f"{k} {v / 2**30:.3f} GiB" for k, v in prog["memory"].items()))
    print("  kernels in the harvest: " + json.dumps(prog["kernels"]))
    report = xprof.build_report({"train_step": prog},
                                {"train_step": {"step_time_s": med / 1e3}})
    for line in xprof.render_report(report).splitlines():
        print("  | " + line)
    sess_mfu = median(sess_mfus)
    event_mfu = per_step / (med / 1e3) * fpt / PEAK_BF16_FLOPS
    print(f"  session: rt_train_mfu median {sess_mfu:.4f} of its "
          f"{len(sess_mfus)} readings {[round(x, 4) for x in sess_mfus]}, "
          f"last rt_train_tokens_per_sec "
          f"{need(series, 'rt_train_tokens_per_sec'):.1f}; from the "
          f"CUDA-event median: MFU {event_mfu:.4f}")

    dec = xprof.measure_step_decomposition(
        loss_fn, optimizer, state, {"tokens": host[0].to("cuda")}, steps=4,
        reps=3, flops_per_step=fpt * per_step)
    sh = dec["shares"]
    print(f"  decomposition (4 calls x 3 reps, CUDA events): forward "
          f"{1e3 * dec['forward_s']:.3f} ms, backward "
          f"{1e3 * dec['backward_s']:.3f}, optimizer "
          f"{1e3 * dec['optimizer_s']:.3f}, full step "
          f"{1e3 * dec['full_step_s']:.3f}; shares {json.dumps(sh)}; of "
          f"peak {json.dumps(dec.get('of_peak'))}")
    plane_ms, plane_rounds = plane_host_cost()
    print(f"  the plane's host cost: {plane_ms:.4f} ms a step (median of "
          f"{len(plane_rounds)} rounds {[round(x, 4) for x in plane_rounds]}"
          f"), {plane_ms / unsharded['median_ms']:.5f} of [main path]'s "
          f"step (card: {card})")
    n_mem = xprof.publish_device_memory()
    mem = {k[1][1][1]: v for k, v in registry_series().items()
           if k[0] == "rt_xla_device_memory_bytes"}
    alloc_peak = torch.cuda.memory_stats()["allocated_bytes.all.peak"]
    print(f"  rt_xla_device_memory_bytes ({n_mem} series): " + ", ".join(
        f"{k} {v / 2**30:.3f} GiB" for k, v in mem.items()))

    want = {"flash_fwd": 2 * cfg.n_layer, "flash_dkv": cfg.n_layer,
            "flash_dq": cfg.n_layer}
    checks = {
        "(a) losses equal [main path]'s": losses == unsharded["losses"],
        "(b) launches 24/12/12 a step": counts == {
            k: v * (1 + steps) for k, v in want.items()},
        "(c) session MFU within 5%": abs(sess_mfu / event_mfu - 1) < 0.05,
        "(d) flash FLOPs = launches x flash_cost": all(
            prog["kernels"][k]["launches"] == n and prog["kernels"][k][
                "flops"] == n * flash_cost(k, batch * cfg.n_head,
                                           cfg.max_seq, 64, True)[0]
            for k, n in want.items()),
        f"(d) harvest ratio in {HARVEST_BAND}":
            HARVEST_BAND[0] <= ratio <= HARVEST_BAND[1],
        "(e) shares sum to 1 +- 0.05": abs(sum(sh.values()) - 1) <= 0.05,
        "(e) optimizer share < 0.15": sh["optimizer"] < 0.15,
        "(e) backward > forward": dec["backward_s"] > dec["forward_s"],
        "(f) compile once, compute 10 times":
            (phase_spans.count("compile"), phase_spans.count("compute"))
            == (1, steps),
        "(f) the plane's host cost < 2% of the step":
            plane_ms < 0.02 * unsharded["median_ms"],
        "(f) data_stall < 0.02 of the steps":
            led["seconds"]["data_stall"] < 0.02 * wall,
        "(g) peak gauge = allocator peak": mem.get("peak") == alloc_peak,
    }
    print("  checks: " + ", ".join(f"{k} {'ok' if v else 'FAILED'}"
                                   for k, v in checks.items()))
    if not all(checks.values()):
        print(f"  losses {losses}\n  [main path] {unsharded['losses']}\n"
              f"  launches {counts}")
        raise RuntimeError("[telemetry] failed: " + ", ".join(
            k for k, v in checks.items() if not v))
    return {"harvest_tflop": prog["flops"] / 1e12, "harvest_ratio": ratio,
            "harvest_gb": prog["bytes"] / 1e9, "memory": prog["memory"],
            "compute_median_ms": med, "plane_host_ms": plane_ms,
            "main_path_median_ms": unsharded["median_ms"],
            "session_mfu": sess_mfu, "event_mfu": event_mfu,
            "goodput_seconds": led["seconds"],
            "forward_ms": 1e3 * dec["forward_s"],
            "backward_ms": 1e3 * dec["backward_s"],
            "optimizer_ms": 1e3 * dec["optimizer_s"],
            "full_step_ms": 1e3 * dec["full_step_s"],
            "shares": sh, "of_peak": dec.get("of_peak")}


def plane_host_cost(rounds: int = 5, n: int = 100):
    """Host milliseconds that the measurement plane adds to one training
    step: the step hook (goodput phase, dispatch histogram), the
    prefetching iterator (feeder thread, pinned copy on a side stream,
    stream wait) and ``session.report``.  A step with almost no device
    work (one 8 -> 1 linear layer, clip + AdamW) on the main path's
    token batch (16 x 1025 int64) runs ``n`` times from batches already
    on the card with telemetry off, then ``n`` times through
    ``make_sharded_train_step(telemetry=True)``,
    ``iter_device_batches`` and ``report``; the cost is the difference
    per step on the host clock, one per round, and the median of
    ``rounds`` alternated rounds is returned with the rounds.  The
    telemetry's first call (the harvest, goodput ``compile``) runs
    before the rounds and registers a ``train_step`` program over the
    main path's."""
    import torch

    from ray_tpu_torch.train.config import TelemetryConfig
    from ray_tpu_torch.train.session import TrainSession
    from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                                make_sharded_train_step)

    def loss_fn(m, b):
        return m(b["tokens"][:, :8].float()).mean()

    optimizer = make_optimizer(total_steps=1000)
    state = TrainState.create(torch.nn.Linear(8, 1, device="cuda"),
                              optimizer)
    off, on = (make_sharded_train_step(loss_fn, optimizer, mesh=None,
                                       telemetry=t) for t in (False, True))
    session = TrainSession(0, 1, 0, 1, 0, "plane cost",
                           telemetry=TelemetryConfig(1.0, 16 * 1024))
    host = [torch.zeros(16, 1025, dtype=torch.int64).pin_memory()
            for _ in range(n)]
    placed = [{"tokens": t.to("cuda")} for t in host]

    def plain(state):
        for b in placed:
            state, _m = off(state, b)
        return state

    def measured(state):
        batches = session.iter_device_batches(
            ({"tokens": t} for t in host), depth=2)
        for i, b in enumerate(batches):
            state, m = on(state, b)
            session.report({"step": i + 1, "loss": m["loss"]})
        return state

    state = measured(plain(state))      # the harvest and warm-up
    costs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = plain(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state = measured(state)
        torch.cuda.synchronize()
        costs.append(1e3 * ((time.perf_counter() - t1) - (t1 - t0)) / n)
    return median(costs), costs


def paired_excess(latencies, events) -> float:
    """Median over calls of the group's latency minus the device time of
    the same call (ms).  A latency that covers the op's completion gives
    at least 0; one that times only the launch falls short by about the
    device time."""
    return median([a - b for a, b in zip(latencies, events)])


def nccl_telemetry(group_name: str, card: str) -> dict:
    """[sharded] Eager ops on the world-1 gang's NCCL group (an allreduce
    and a broadcast of 256 MiB, a barrier): one call to set NCCL up,
    then 5 timed calls each.  Every call must add one
    ``rt_collective_latency_seconds{backend="nccl"}`` sample, and the
    group's latency must cover the device time of the same call: the
    timed region holds the op's completion, not only its launch.  The
    device time runs between two CUDA events that hooks on the group
    record inside the timed region: one as the call stages its input,
    one after the op's ``wait()``, before the call synchronises.  The
    median of the calls' differences (latency minus device time) must
    not be negative.  (Against the device time of the same work run
    just before the call, the check failed one run in ten: that time
    alone moves between about 0.19 and 0.42 ms from call to call.)
    The barrier is held to its sample count only: NCCL's barrier blocks
    the host in ``wait()`` itself and stages nothing.  Returns each op's
    paired median and series."""
    import torch

    from ray_tpu_torch import collective as col

    group = col.get_group(group_name)
    x = torch.ones(64 << 20, device="cuda")
    stamps = {}

    def record(key):
        stamps[key] = torch.cuda.Event(enable_timing=True)
        stamps[key].record()

    def stage(tensor, _stage=group._stage):
        record("start")
        return _stage(tensor)

    def completed(_completed=group._completed):
        record("end")
        _completed()

    calls = (("allreduce", lambda: group.allreduce(x)),
             ("broadcast", lambda: group.broadcast(x, 0)),
             ("barrier", group.barrier))
    name, rounds = "rt_collective_latency_seconds", 5
    out = {}
    group._stage, group._completed = stage, completed
    try:
        for op, call in calls:
            tags = dict(op=op, backend="nccl", world="1")
            n0, _s = registry_series().get(
                (name, tuple(sorted(tags.items()))), (0, 0.0))
            call()
            torch.cuda.synchronize()
            events, latencies = [], []
            for _ in range(rounds):
                stamps.clear()
                _n, s1 = need(registry_series(), name, **tags)
                call()
                _n, s2 = need(registry_series(), name, **tags)
                latencies.append(1e3 * (s2 - s1))
                if "start" in stamps:
                    stamps["end"].synchronize()
                    events.append(stamps["start"].elapsed_time(stamps["end"]))
            n, _s = need(registry_series(), name, **tags)
            size = "" if op == "barrier" else f" {x.nbytes / 2**20:.0f} MiB"
            line = (f"  {op}{size}: telemetry latency median "
                    f"{median(latencies):.4f} ms "
                    f"{[round(v, 4) for v in latencies]}")
            if op == "barrier":
                paired = None
            else:
                paired = paired_excess(latencies, events)
                line += (f", the same calls' device time "
                         f"{[round(v, 4) for v in events]} (CUDA events); "
                         f"median difference {paired:.4f} ms, least "
                         f"{min(a - b for a, b in zip(latencies, events)):.4f}")
            print(f"{line}; {n - n0} samples for {1 + rounds} calls "
                  f"(card: {card})")
            out[op] = dict(paired=paired, latencies=latencies, events=events)
            if n - n0 != 1 + rounds or not (paired is None or paired >= 0):
                raise RuntimeError(f"NCCL timed_op {op}: {n - n0} samples; "
                                   f"latency minus the same call's device "
                                   f"time, median {paired} ms < 0")
    finally:
        del group._stage, group._completed
    return out


def check_lse_cotangent(b, t, h, d, causal, seed):
    """``flash_attention_with_lse`` (the kernels, through autograd) with
    random dO and a random lse cotangent dlse: O, lse, dQ, dK and dV
    against the plain version run in float32, under ``check_kernels``'
    gate (twice the bf16 plain version's error plus 2^-8 of the peak;
    1e-5 for the lse).  Only ring attention gives the kernels a nonzero
    dlse, which enters as delta = rowsum(dO * O) - dlse."""
    import torch

    from ray_tpu_torch.ops.flash_attention import (flash_attention_with_lse,
                                                   flash_dkv_plain,
                                                   flash_dq_plain,
                                                   flash_fwd_plain)

    q, k, v, do = attention_inputs(b, t, h, d, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    dlse = torch.randn((b, t, h), generator=gen, device="cuda")

    def plain(q, k, v, do):
        kw = dict(scale=d ** -0.5, causal=causal, block_q=t, block_k=t)
        out, lse = flash_fwd_plain(q, k, v, **kw)
        delta = ((do.float() * out.float()).sum(-1) - dlse).transpose(
            1, 2).contiguous()
        dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, **kw)
        dq = flash_dq_plain(q, k, v, do, lse, delta, **kw)
        return out, lse.transpose(1, 2), dq, dk, dv

    ref = plain(*(x.float() for x in (q, k, v, do)))
    bf16 = plain(q, k, v, do)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = flash_attention_with_lse(qg, kg, vg, causal=causal,
                                        block_q=t, block_k=t)
    got = (out.detach(), lse.detach(),
           *torch.autograd.grad((out, lse), (qg, kg, vg), (do, dlse)))
    torch.cuda.synchronize()
    for name, g, p, r in zip(("O", "lse", "dQ", "dK", "dV"), got, bf16,
                             ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"lse cotangent {name}: bad output "
                               f"{tuple(g.shape)}")
        err_k, err_p = max_abs(g, r), max_abs(p, r)
        rel = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-5
        tol = 2 * err_p + rel * float(r.abs().max())
        print(f"  {name} B{b} T{t} H{h} D{d} causal={causal}: |kernel-ref| "
              f"{err_k:.3e}  |plain-ref| {err_p:.3e}  tol {tol:.3e}")
        if not err_k <= tol:
            raise RuntimeError(f"lse cotangent {name}: kernel error {err_k} "
                               f"over tolerance {tol}")


@contextlib.contextmanager
def world1_gang():
    """A world-1 NCCL gang (``setup_distributed_mesh``) through a
    ``file://`` store in a temporary directory; yields the all-axes
    mesh (``create_mesh(MeshSpec())``) and the gang's group name, and
    leaves the gang on exit."""
    import tempfile

    import torch

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh
    from ray_tpu_torch.train.distributed import setup_distributed_mesh

    with tempfile.TemporaryDirectory() as rendezvous:
        gang = setup_distributed_mesh(rank=0, world=1, device="cuda",
                                      init_method=f"file://{rendezvous}/gang")
        try:
            print(f"  gang {gang.group_name!r}: world {gang.world}, mesh "
                  f"{gang.axis_sizes}, backend "
                  f"{torch.distributed.get_backend()}")
            yield create_mesh(MeshSpec(), device="cuda"), gang.group_name
        finally:
            col.destroy_collective_group(gang.group_name)


def timed_steps(step, state, data, warm: int, steps: int):
    """``warm`` then ``steps`` training steps back to back, a CUDA event
    at each step boundary (no sync in the loop).  Returns (metrics of
    every step, sorted per-step device ms of the timed ones, host-clock
    seconds of the timed ones)."""
    import torch

    metrics = []
    for _ in range(warm):
        state, m = step(state, data)
        metrics.append(m)
    bounds = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounds[0].record()
    for i in range(steps):
        state, m = step(state, data)
        bounds[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return metrics, sorted(a.elapsed_time(b)
                           for a, b in zip(bounds, bounds[1:])), wall


def median(xs):
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2


def check_finite(metrics):
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(math.isfinite(x) for x in losses + norms):
        raise RuntimeError(f"non-finite loss/grad_norm {losses} {norms}")
    return losses, norms


def sharded_path(card: str, unsharded: dict, mesh, profile: bool = False):
    """[sharded] The main path's step sharded over ``mesh`` (a world-1
    NCCL gang's): ``shard_state`` places GPT-2 124M (bf16, remat, ring
    attention over the one-device ``seq`` axis) as DTensors, and
    ``make_sharded_train_step`` takes 1 warm and 10 timed steps at B16
    T1024 on the main path's weights and batch (seed 0).  The loss under
    a mesh is the full-logits one, as in the JAX package.  Checks: the
    first loss within 1e-2 of the unsharded step's, finite loss and grad
    norm every step, launches exactly 24/12/12 a step.  Returns the
    launch counts and what ``[checkpoint]`` goes on from: the config,
    the state after the steps, the step function and the batch."""
    import torch

    from ray_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                           gpt2_loss_fn, gpt2_param_axes)
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel.sharding import (ShardingRules, distribute,
                                                 logical_sharding)
    from ray_tpu_torch.parallel.mesh import mesh_axis_sizes
    from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                                make_sharded_train_step,
                                                shard_state)
    from ray_tpu_torch.util import xprof

    batch, warm, steps = 16, 1, 10
    rules = ShardingRules()
    cfg = GPT2Config(**GPT2_124M, remat=True, attn_impl="ring", mesh=mesh,
                     rules=rules)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           generator=gen, device="cuda")
    optimizer = make_optimizer(total_steps=1000)
    state = shard_state(TrainState.create(model, optimizer), mesh,
                        gpt2_param_axes, rules)
    step = make_sharded_train_step(
        lambda m, b: gpt2_loss_fn(cfg, m, b), optimizer, mesh)
    data = {"tokens": distribute(tokens, logical_sharding(
        mesh, ("batch", None), rules))}
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    metrics, step_ms, wall = timed_steps(step, state, data, warm, steps)
    counts = dict(_kernels.launches)
    if profile:
        profile_steps(step, state, data)

    total = warm + steps
    want = {"flash_fwd": 2 * cfg.n_layer * total,
            "flash_dkv": cfg.n_layer * total,
            "flash_dq": cfg.n_layer * total}
    if counts != want:
        raise RuntimeError(f"kernel launches {counts}, expected {want}")
    losses, norms = check_finite(metrics)
    gap = abs(losses[0] - unsharded["first_loss"])
    print(f"  first loss {losses[0]:.6f}, unsharded step's "
          f"{unsharded['first_loss']:.6f}: gap {gap:.3e} (limit 1e-2)")
    if not gap < 1e-2:
        raise RuntimeError("sharded first loss disagrees with the "
                           "unsharded step's")
    ms = median(step_ms)
    tok_s = batch * cfg.max_seq * steps / wall
    print(f"  losses {losses}")
    print(f"  grad_norms {norms}")
    print(f"  {steps} steps: per-step device time median {ms:.3f} ms "
          f"(min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}) against the "
          f"unsharded step's {unsharded['median_ms']:.3f} ms "
          f"({ms / unsharded['median_ms']:.4f}x); {tok_s:.1f} tokens/s "
          f"(host clock; unsharded {unsharded['tokens_per_s']:.1f}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(card: {card})")
    print(f"  launches over {total} steps: {counts} "
          f"(per step 24 fwd / 12 dK,dV / 12 dQ)")
    prog = xprof.local_programs()["train_step"]
    print(f"  train_step registered on mesh {mesh_axis_sizes(mesh)}: "
          f"{prog['flops'] / 1e12:.6f} TFLOP, {prog['bytes'] / 1e9:.3f} GB, "
          f"collectives {prog['collectives']} (world 1: none cross a "
          f"device), compiles {prog['compiles']}")
    return counts, {"cfg": cfg, "state": state, "step": step, "data": data,
                    "optimizer": optimizer}


# [ring]: GPT-2's attention width at the context ring attention is for.
RING = dict(b=4, t=4096, h=12, d=64, seed=5)


def ring_rank(rank: int, world: int, rendezvous: str):
    """[ring] One of ``world`` processes on cuda:0: its sequence shard of
    the seed-5 inputs through ring (flash) and Ulysses attention, forward
    and backward, over a gloo group (CUDA tensors staged through host
    memory).  Returns each kind's launch counts and host-clock ms and,
    on rank 0, the output and gradients gathered over the group (float32
    numpy)."""
    import functools

    import torch

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.dryrun import join
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    torch.cuda.set_device(0)
    group = join(rank, world, rendezvous, backend="gloo")
    try:
        b, t, h, d = RING["b"], RING["t"], RING["h"], RING["d"]
        q, k, v, do = attention_inputs(b, t, h, d, RING["seed"])
        rows = slice(rank * t // world, (rank + 1) * t // world)
        out = {}
        for kind, fn in (("ring", functools.partial(ring_attention,
                                                    impl="flash")),
                         ("ulysses", ulysses_attention)):
            ql, kl, vl = (x[:, rows].contiguous().requires_grad_()
                          for x in (q, k, v))
            _kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = fn(ql, kl, vl, group=group, causal=True)
            grads = torch.autograd.grad(o, (ql, kl, vl),
                                        do[:, rows].contiguous())
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = dict(_kernels.launches)
            full = [torch.cat(col.allgather(x.detach().contiguous(), "gang"),
                              dim=1) for x in (o, *grads)]
            out[kind] = {"launches": counts, "ms": ms,
                         "full": [f.float().cpu().numpy() for f in full]
                         if rank == 0 else None}
        return out
    finally:
        col.destroy_collective_group("gang")


def ring_phase(card: str):
    """[ring] ``seq`` = 2 and 4 processes sharing the card, a gloo group
    and a ``file://`` rendezvous (``dryrun.spawn``, join timeout 300 s):
    ring (flash kernels) and Ulysses attention at B4, global T 4096, H12,
    D64, bf16, causal.  The outputs and dQ/dK/dV gathered to rank 0 must
    be as close to the float32 reference as the single-process
    ``flash_attention`` on the full sequence is, under the kernel gate:
    within twice its error plus 2^-8 of the peak.  Each rank of the ring
    must launch its diagonal block and every block before it: r + 1
    forward, dK/dV and dQ kernels on rank r."""
    import torch

    from ray_tpu_torch.dryrun import spawn
    from ray_tpu_torch.ops import flash_attention

    b, t, h, d = RING["b"], RING["t"], RING["h"], RING["d"]
    q, k, v, do = attention_inputs(b, t, h, d, RING["seed"])

    def forward_backward(fn, *xs):
        xs = [x.detach().requires_grad_() for x in xs]
        o = fn(*xs)
        return [o.detach(), *torch.autograd.grad(o, xs, do.to(o.dtype))]

    def dense32(q, k, v):
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        mask = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
        p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    ref = forward_backward(dense32, *(x.float() for x in (q, k, v)))
    single = forward_backward(
        lambda *x: flash_attention(*x, causal=True), q, k, v)
    torch.cuda.synchronize()
    for world in (2, 4):
        t0 = time.perf_counter()
        runs = spawn(ring_rank, world, timeout=300.0)
        print(f"  seq={world}: {world} processes on cuda:0 ran in "
              f"{time.perf_counter() - t0:.1f} s")
        for kind in ("ring", "ulysses"):
            for rank, run in enumerate(runs):
                counts = run[kind]["launches"]
                print(f"    {kind} rank {rank}: launches {counts}, "
                      f"{run[kind]['ms']:.1f} ms (first call, host clock)")
                want = ({"flash_fwd": rank + 1, "flash_dkv": rank + 1,
                         "flash_dq": rank + 1} if kind == "ring" else
                        {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0})
                if counts != want:
                    raise RuntimeError(f"{kind} seq={world} rank {rank}: "
                                       f"launches {counts}, expected {want}")
            for name, g, s1, r in zip(("O", "dQ", "dK", "dV"),
                                      runs[0][kind]["full"], single, ref):
                g = torch.from_numpy(g).to("cuda")
                err, err_single = max_abs(g, r), max_abs(s1, r)
                tol = 2 * err_single + 2.0 ** -8 * float(r.abs().max())
                print(f"    {kind} seq={world} {name}: |{kind}-ref| "
                      f"{err:.3e}  |single-ref| {err_single:.3e}  tol "
                      f"{tol:.3e}  |{kind}-single| {max_abs(g, s1):.3e}")
                if not err <= tol:
                    raise RuntimeError(f"{kind} seq={world} {name}: error "
                                       f"{err} over tolerance {tol}")


# [moe]: GPT-2 124M widths with Switch-Base-8's expert layout (8 experts
# of d_ff 3072 in every other block) and the JAX package's routing
# defaults (top-2, capacity factor 1.25, aux weight 0.01).
MOE = dict(moe_num_experts=8, moe_every=2, moe_top_k=2,
           moe_capacity_factor=1.25, moe_aux_weight=0.01)


def moe_routing_at_init(model, inputs):
    """The MoE blocks' aux losses and the share of (token, k)
    assignments dropped by capacity, from one no-grad forward; each
    block's routing is recomputed from its captured input."""
    import torch

    from ray_tpu_torch.ops.moe import _route

    seen = []
    hooks = [blk.moe_mlp.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for blk in model.blocks() if blk.use_moe]
    try:
        with torch.no_grad():
            _logits, aux = model(inputs, return_aux=True)
            dropped = total = 0
            for mod, x in seen:
                _i, slot, _g, cap, _a = _route(
                    x.reshape(-1, x.shape[-1]), mod.router, mod.top_k,
                    mod.capacity_factor, ())
                dropped += int((slot == cap).sum())
                total += slot.numel()
    finally:
        for h in hooks:
            h.remove()
    return float(aux), dropped / total


def moe_profile(step, state, data, n_experts: int, capacity: int,
                n: int = 2) -> None:
    """--profile: device time of the MoE products over ``n`` more steps,
    by operator and input shapes (``torch.profiler``): the dispatch and
    combine products (an operand with E*C rows or columns) apart from
    the expert FFNs (batched over E) and every other product."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            step(state, data)
        torch.cuda.synchronize()
    sums = {"dispatch/combine": 0.0, "expert FFNs": 0.0,
            "other products": 0.0, "everything else": 0.0}
    rest = {}
    ec = n_experts * capacity
    for evt in prof.key_averages(group_by_input_shape=True):
        # Operators only: each kernel's time counts once, under the
        # operator that launched it.
        if evt.device_type != DeviceType.CPU:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if not us:
            continue
        shapes = [tuple(x) for x in evt.input_shapes if x]
        if evt.key in ("aten::mm", "aten::bmm", "aten::addmm"):
            if any(ec in sh for sh in shapes):
                sums["dispatch/combine"] += us
            elif shapes and len(shapes[0]) == 3 and \
                    shapes[0][0] == n_experts:
                sums["expert FFNs"] += us
            else:
                sums["other products"] += us
        else:
            sums["everything else"] += us
            rest[evt.key] = rest.get(evt.key, 0.0) + us
    total = sum(sums.values())
    print(f"  profile of {n} steps: kernel time {total / n / 1e3:.3f} "
          f"ms/step")
    for key, us in sums.items():
        print(f"    {key}: {us / n / 1e3:.3f} ms/step "
              f"({us / max(total, 1e-9):.4f})")
    print("  everything else, the largest operators (ms/step):")
    for key, us in sorted(rest.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / n / 1e3:9.3f}  {key}")


def moe_phase(card: str, unsharded: dict, profile: bool = False):
    """[moe] GPT-2 124M widths with MoE blocks (``MOE``), bf16, flash,
    remat, B16 T1024, random weights and tokens from seed 0: 1 warm and
    10 timed unsharded steps, then the world-1 NCCL sharded step on the
    same weights and batch (ring attention over the one-device ``seq``
    axis), 1 warm and 3 timed.  Checks: the init loss within 0.5 of
    ln(V) + 0.01 aux, finite loss and grad norm every step, exactly
    24/12/12 launches a step in both, the sharded first loss within 1e-2
    of the unsharded one.  No MFU: ``flops_per_token`` does not count
    the expert work."""
    import torch

    from ray_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                           gpt2_loss_fn, gpt2_param_axes)
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel.sharding import distribute, logical_sharding
    from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                                make_sharded_train_step,
                                                make_train_step, shard_state)

    batch = 16
    cfg = GPT2Config(**GPT2_124M, **MOE, remat=True, attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                           generator=gen, device="cuda")
    aux, drop = moe_routing_at_init(model, tokens[:, :-1])
    capacity = max(int(cfg.moe_capacity_factor * batch * cfg.max_seq
                       / cfg.moe_num_experts), cfg.moe_top_k)
    n_moe = sum(b.use_moe for b in model.blocks())
    print(f"  at init: aux {aux:.6f} ({n_moe} MoE blocks), capacity "
          f"{capacity} a expert, share of (token, k) assignments dropped "
          f"{drop:.6f}")

    def run(step, state, data, warm, steps):
        _kernels.reset_launches()
        metrics, step_ms, wall = timed_steps(step, state, data, warm, steps)
        counts = dict(_kernels.launches)
        total = warm + steps
        want = {"flash_fwd": 2 * cfg.n_layer * total,
                "flash_dkv": cfg.n_layer * total,
                "flash_dq": cfg.n_layer * total}
        if counts != want:
            raise RuntimeError(f"kernel launches {counts}, expected {want}")
        losses, norms = check_finite(metrics)
        ms = median(step_ms)
        print(f"    losses {losses}")
        print(f"    grad_norms {norms}")
        print(f"    {steps} timed steps: per-step device time median "
              f"{ms:.3f} ms (min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}); "
              f"{batch * cfg.max_seq * steps / wall:.1f} tokens/s (host "
              f"clock); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"    launches over {total} steps: {counts} (per step 24 fwd "
              f"/ 12 dK,dV / 12 dQ)")
        return losses, ms

    optimizer = make_optimizer(total_steps=1000)
    state = TrainState.create(model, optimizer)
    step = make_train_step(lambda m, b: gpt2_loss_fn(cfg, m, b), optimizer)
    data = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    print("  unsharded:")
    losses, ms = run(step, state, data, 1, 10)
    want = math.log(cfg.vocab_size) + cfg.moe_aux_weight * aux
    print(f"  first loss {losses[0]:.6f} against ln(V) + 0.01 aux "
          f"{want:.6f} (limit 0.5); [main path] {unsharded['median_ms']:.3f}"
          f" ms/step, {unsharded['tokens_per_s']:.1f} tokens/s "
          f"(card: {card})")
    if not abs(losses[0] - want) < 0.5:
        raise RuntimeError("MoE init loss is not near ln(V) + aux")
    if profile:
        moe_profile(step, state, data, cfg.moe_num_experts, capacity)
    del state, step, model
    free_device_memory()

    with world1_gang() as (mesh, _group):
        scfg = dataclasses.replace(cfg, attn_impl="ring", mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(0)
        smodel = gpt2_init(scfg, gen, device="cuda")
        state = shard_state(TrainState.create(smodel, optimizer), mesh,
                            gpt2_param_axes)
        sstep = make_sharded_train_step(
            lambda m, b: gpt2_loss_fn(scfg, m, b), optimizer, mesh)
        sdata = {"tokens": distribute(tokens, logical_sharding(
            mesh, ("batch", None)))}
        torch.cuda.reset_peak_memory_stats()
        print("  sharded (world-1 NCCL gang, DTensor state):")
        slosses, sms = run(sstep, state, sdata, 1, 3)
    gap = abs(slosses[0] - losses[0])
    print(f"  sharded first loss {slosses[0]:.6f}, unsharded {losses[0]:.6f}"
          f": gap {gap:.3e} (limit 1e-2); sharded {sms:.3f} ms/step "
          f"({sms / ms:.4f}x the unsharded step)")
    if not gap < 1e-2:
        raise RuntimeError("sharded MoE first loss disagrees")


# [pipeline]: GPT-2 124M blocks split over S stages, hidden states of
# B16 T1024 in M = 8 microbatches.
PIPE = dict(batch=16, microbatches=8, seed=7)


def pipeline_rank(rank: int, world: int, rendezvous: str):
    """[pipeline] Stage ``rank`` of ``world`` on cuda:0: blocks
    [rank * 12 / S, (rank + 1) * 12 / S) of the seed-0 GPT-2 124M (bf16,
    flash, no block remat; ``checkpoint_stage`` recomputes each tick)
    through ``pipeline_apply`` over a gloo group.  Returns its launches
    and host-clock seconds, and on rank 0 the output, the input gradient
    and every stage's parameter gradients gathered over the group
    (float32 numpy)."""
    import torch

    from ray_tpu_torch import collective as col
    from ray_tpu_torch.dryrun import join
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    torch.cuda.set_device(0)
    group = join(rank, world, rendezvous, backend="gloo")
    try:
        cfg = GPT2Config(**GPT2_124M, remat=False, attn_impl="flash")
        model = gpt2_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
        per = cfg.n_layer // world
        blocks = model.blocks()[rank * per:(rank + 1) * per]
        params = [p for b in blocks for p in b.parameters()]
        x, dy = pipeline_inputs(cfg)

        def stage(blks, h):
            for b in blks:
                h = b(h)
            return h

        x = x.requires_grad_()
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pipeline_apply(stage, blocks, x,
                           num_microbatches=PIPE["microbatches"],
                           group=group, checkpoint_stage=True)
        grads = torch.autograd.grad(y, [x] + params, dy)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(_kernels.launches)
        flat = torch.cat([g.float().reshape(-1) for g in grads[1:]])
        every = col.allgather(flat, "gang")
        out = None
        if rank == 0:
            out = [y.detach().float().cpu().numpy(),
                   grads[0].float().cpu().numpy(),
                   torch.cat(every).cpu().numpy()]
        return {"launches": counts, "seconds": seconds, "full": out}
    finally:
        col.destroy_collective_group("gang")


def pipeline_inputs(cfg):
    """Seed-7 hidden states [B, T, D] (bf16) and output cotangent."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(PIPE["seed"])
    shape = (PIPE["batch"], cfg.max_seq, cfg.d_model)
    return (torch.randn(shape, generator=gen, device="cuda"
                        ).to(torch.bfloat16),
            torch.randn(shape, generator=gen, device="cuda"
                        ).to(torch.bfloat16))


def pipeline_phase(card: str):
    """[pipeline] S = 2 and 4 processes sharing the card (``dryrun.spawn``,
    gloo, join timeout 300 s), each a stage of 12/S GPT-2 124M blocks,
    B16 T1024 hidden states in M = 8 microbatches.  The output, the
    input gradient and every parameter gradient gathered to rank 0 must
    be as close to the float32 run of the 12 blocks in sequence (dense
    attention) as the bf16 sequential run (flash) is, under the kernel
    gate: within twice its error plus 2^-8 of the peak.  Every stage
    runs each of the M + S - 1 ticks, so each rank must launch
    2 (M + S - 1) 12/S forward kernels (the forward and its
    recomputation) and (M + S - 1) 12/S of each backward kernel."""
    import torch

    from ray_tpu_torch.dryrun import spawn
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    cfg = GPT2Config(**GPT2_124M, remat=False, attn_impl="flash")
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32, attn_impl="dense")
    x, dy = pipeline_inputs(cfg)

    def sequential(c):
        model = gpt2_init(c, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
        params = [p for b in model.blocks() for p in b.parameters()]
        xi = x.to(c.dtype).requires_grad_()
        h = xi
        for b in model.blocks():
            h = b(h)
        grads = torch.autograd.grad(h, [xi] + params, dy.to(c.dtype))
        return [h.detach().float(), grads[0].float(),
                torch.cat([g.float().reshape(-1) for g in grads[1:]])]

    seq, ref = sequential(cfg), sequential(ref_cfg)
    free_device_memory()
    m = PIPE["microbatches"]
    for world in (2, 4):
        t0 = time.perf_counter()
        runs = spawn(pipeline_rank, world, timeout=300.0)
        print(f"  S={world}: {world} processes on cuda:0 ran in "
              f"{time.perf_counter() - t0:.1f} s")
        ticks = (m + world - 1) * cfg.n_layer // world
        want = {"flash_fwd": 2 * ticks, "flash_dkv": ticks,
                "flash_dq": ticks}
        for rank, run in enumerate(runs):
            print(f"    rank {rank}: launches {run['launches']} (expected "
                  f"{want}), {run['seconds']:.2f} s forward + backward "
                  f"(host clock)")
            if run["launches"] != want:
                raise RuntimeError(f"pipeline S={world} rank {rank}: "
                                   f"launches {run['launches']}, expected "
                                   f"{want}")
        for name, g, s1, r in zip(("output", "input grad", "param grads"),
                                  runs[0]["full"], seq, ref):
            g = torch.from_numpy(g).to("cuda")
            err, err_seq = max_abs(g, r), max_abs(s1, r)
            tol = 2 * err_seq + 2.0 ** -8 * float(r.abs().max())
            print(f"    S={world} {name}: |pipe-ref| {err:.3e}  |seq-ref| "
                  f"{err_seq:.3e}  tol {tol:.3e}")
            if not err <= tol:
                raise RuntimeError(f"pipeline S={world} {name}: error {err} "
                                   f"over tolerance {tol}")
        del runs
    print(f"  (card: {card})")


def checkpoint_phase(card: str, sharded: dict):
    """[checkpoint] The ``[sharded]`` GPT-2 124M state after its steps
    (float32 parameters, both AdamW moments, the step): ``save_sharded``
    into a temporary directory; ``load_sharded`` onto the same world-1
    mesh, every leaf bit-identical; a host restore (numpy) into an
    unsharded TrainState, equal to the original's ``full_tensor()``;
    ``restore_train_state`` of the mesh restore into a fresh state, and
    one more step from it and from the original: equal losses, equal
    parameters after it.  The seconds and GB/s are this machine's
    disk."""
    import shutil
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models.gpt2 import GPT2, gpt2_param_axes
    from ray_tpu_torch.parallel.partition_rules import named_tree_map
    from ray_tpu_torch.train.distributed import (restore_train_state,
                                                 train_state_tree)
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)
    from ray_tpu_torch.train.train_step import TrainState, shard_state
    from ray_tpu_torch.util import goodput

    cfg, state, step, data, optimizer = (
        sharded[k] for k in ("cfg", "state", "step", "data", "optimizer"))
    mesh = cfg.mesh
    tree = train_state_tree(state)
    work = tempfile.mkdtemp()
    try:
        path = f"{work}/checkpoint_{state.step:06d}"
        torch.cuda.synchronize()
        ckpt_s = goodput.ledger().snapshot()["seconds"]["checkpoint"]
        t0 = time.perf_counter()
        saved = save_sharded(path, tree, mesh=mesh,
                             meta={"step": state.step})
        t_save = time.perf_counter() - t0
        series = registry_series()
        save_n, save_sum = need(series, "rt_train_checkpoint_save_seconds",
                                sharded="1")
        nbytes = need(series, "rt_checkpoint_bytes")
        shards = need(series, "rt_checkpoint_shards")
        ckpt_s = goodput.ledger().snapshot()["seconds"]["checkpoint"] - ckpt_s
        print(f"  telemetry: rt_checkpoint_bytes {nbytes / 1e9:.3f} GB, "
              f"rt_checkpoint_shards {shards:.0f}, save histogram {save_n} "
              f"sample(s) {save_sum:.3f} s, goodput checkpoint +{ckpt_s:.3f} s")
        if (save_n, nbytes, shards) != (1, saved["bytes"], saved["files"]) \
                or not ckpt_s > 0:
            raise RuntimeError("checkpoint telemetry disagrees with the save")
        t0 = time.perf_counter()
        back = load_sharded(path, mesh=mesh)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = load_sharded(path)
        t_host = time.perf_counter() - t0
        restores = need(registry_series(),
                        "rt_train_checkpoint_restore_seconds", sharded="1")
        if restores[0] != 2:
            raise RuntimeError(f"restore histogram: {restores}")
        gb = saved["bytes"] / 1e9
        print(f"  saved {saved['files']} files, {gb:.3f} GB in {t_save:.2f} "
              f"s ({gb / t_save:.3f} GB/s); restored onto the mesh in "
              f"{t_load:.2f} s ({gb / t_load:.3f} GB/s), on the host in "
              f"{t_host:.2f} s ({gb / t_host:.3f} GB/s) (this machine's "
              f"disk; card: {card})")

        def same(name, a):
            b, h = _at(back, name), _at(host, name)
            if isinstance(a, DTensor):
                full = a.full_tensor().cpu()
                ok = a.placements == b.placements and torch.equal(
                    a.to_local(), b.to_local()) and torch.equal(
                    full, torch.from_numpy(h))
            else:
                ok = int(a) == int(b) == int(h)
            if not ok:
                raise RuntimeError(f"checkpoint leaf {name} differs")
            return a

        named_tree_map(same, tree)
        plain = TrainState.create(
            GPT2(dataclasses.replace(cfg, mesh=None, attn_impl="flash"),
                 device="cuda"), optimizer)
        restore_train_state(plain, host)
        for (name, p), q in zip(plain.model.named_parameters(),
                                state.model.parameters()):
            if not torch.equal(p.detach(), q.full_tensor()):
                raise RuntimeError(f"host-restored {name} differs")
        print(f"  every leaf bit-identical: {len(tree['params'])} "
              f"parameters, both moments, step {int(host['step'])} (mesh "
              f"restore, host restore, and the host restore placed in an "
              f"unsharded TrainState)")
        del plain, host
        free_device_memory()

        fresh = shard_state(TrainState.create(GPT2(cfg, device="cuda"),
                                              optimizer),
                            mesh, gpt2_param_axes)
        restore_train_state(fresh, back)
        del back
        _, m_orig = step(state, data)
        _, m_back = step(fresh, data)
        l_orig, l_back = float(m_orig["loss"]), float(m_back["loss"])
        diff = [n for (n, a), b in zip(state.model.named_parameters(),
                                       fresh.model.parameters())
                if not torch.equal(a.to_local(), b.to_local())]
        print(f"  next step: loss {l_orig:.6f} from the original, "
              f"{l_back:.6f} from the restored state; parameters after it "
              f"differ in {len(diff)} tensors")
        if l_orig != l_back or diff:
            raise RuntimeError(f"the restored state steps differently: "
                               f"{l_orig} {l_back} {diff[:5]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------- runtime
def gpu_count() -> int:
    """The cards ``nvidia-smi`` lists."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return len([ln for ln in out.stdout.splitlines() if ln.strip()])


class GpuProbe:
    """An actor that reports what its GPU lease let it see."""

    def env(self):
        import os

        import torch

        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "count": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(0),
                "pid": os.getpid()}


def seeded_bf16(seed: int):
    """A bf16 tensor [16, 1024, 768] on the card, made from ``seed``."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(16, 1024, 768, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def main_path_parts(n_layer: int = 12, mesh=None):
    """The [main path] configuration at depth ``n_layer``: its config,
    state (seed-0 weights), step function and batch, built on the card.
    With a ``mesh``, [sharded]'s step over it: DTensor state, ring
    attention, the full-logits loss, the batch split over the mesh."""
    import torch

    from ray_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                           gpt2_loss_fn, gpt2_param_axes)
    from ray_tpu_torch.parallel.sharding import (ShardingRules, distribute,
                                                 logical_sharding)
    from ray_tpu_torch.train.train_step import (TrainState, make_optimizer,
                                                make_sharded_train_step,
                                                make_train_step,
                                                shard_state)

    width = dict(GPT2_124M, n_layer=n_layer)
    if mesh is None:
        cfg = GPT2Config(**width, remat=True, attn_impl="flash")
    else:
        rules = ShardingRules()
        cfg = GPT2Config(**width, remat=True, attn_impl="ring", mesh=mesh,
                         rules=rules)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (16, cfg.max_seq + 1),
                           generator=gen, device="cuda")
    optimizer = make_optimizer(total_steps=1000)
    state = TrainState.create(model, optimizer)
    if mesh is None:
        step = make_train_step(
            lambda m, b: gpt2_loss_fn(cfg, m, b, loss_chunk=256), optimizer)
        return cfg, state, step, {"tokens": tokens}
    state = shard_state(state, mesh, gpt2_param_axes, rules)
    step = make_sharded_train_step(
        lambda m, b: gpt2_loss_fn(cfg, m, b), optimizer, mesh)
    return cfg, state, step, {"tokens": distribute(tokens, logical_sharding(
        mesh, ("batch", None), rules))}


class MainPathStepper:
    """An actor holding the leased GPU that runs [main path] steps."""

    def setup(self):
        self.cfg, self.state, self.step, self.data = main_path_parts()
        self.state, _m = self.step(self.state, self.data)   # warm
        import torch

        torch.cuda.synchronize()
        return True

    def run(self, steps: int, delay_s: float):
        import time

        import torch

        from ray_tpu_torch.ops import _kernels

        time.sleep(delay_s)     # the capture starts meanwhile
        _kernels.reset_launches()
        for _ in range(steps):
            self.state, _m = self.step(self.state, self.data)
        torch.cuda.synchronize()
        return dict(_kernels.launches)


def runtime_phase(card: str) -> dict:
    """[runtime] The port's runtime on the card.  ``init(mode="cluster")``
    must detect as many ``GPU`` as ``nvidia-smi`` lists; a ``num_gpus=1``
    actor sees its id in ``CUDA_VISIBLE_DEVICES`` and the card's name;
    with every GPU leased, one more such actor stays pending until one
    holder is killed, then gets that id; a ``num_gpus=1`` task returns a
    bf16 CUDA tensor [16, 1024, 768] that reaches the driver's host
    memory bit-equal to the same tensor made in the driver from the same
    seed; a ``torch.profiler`` capture of an actor (``util.state.
    torch_profile``, started on the worker's RPC thread) while it runs 3
    [main path] steps on its loop thread holds all three flash kernels.
    Prints the actor start time and the tensor's transfer time."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state as rt_state

    t0 = time.perf_counter()
    rt.init(mode="cluster", num_cpus=8)
    out = {"init_s": time.perf_counter() - t0}
    try:
        gpus = rt.cluster_resources().get("GPU", 0.0)
        want = gpu_count()
        print(f"  init {out['init_s']:.3f} s; GPU {gpus} (nvidia-smi: "
              f"{want}); resources {rt.cluster_resources()}")
        if gpus != want:
            raise RuntimeError(f"runtime detected {gpus} GPU, nvidia-smi "
                               f"lists {want}")
        probe = rt.remote(num_gpus=1)(GpuProbe)
        t0 = time.perf_counter()
        holders = [probe.remote() for _ in range(want)]
        seen = rt.get([h.env.remote() for h in holders], timeout=300)
        out["actor_start_s"] = (time.perf_counter() - t0) / want
        print(f"  {want} num_gpus=1 actor(s) up in "
              f"{time.perf_counter() - t0:.3f} s: {seen}")
        for e in seen:
            if e["count"] != 1 or e["visible"] is None \
                    or e["name"] != torch.cuda.get_device_name(0):
                raise RuntimeError(f"actor's view of its lease {e}")
        if sorted(e["visible"] for e in seen) != \
                [str(i) for i in range(want)]:
            raise RuntimeError(f"GPU ids {seen}, expected 0..{want - 1}")
        extra = probe.remote()
        pending = extra.env.remote()
        ready, _ = rt.wait([pending], timeout=5.0)
        if ready:
            raise RuntimeError("a num_gpus=1 actor started with every "
                               "GPU leased")
        rt.kill(holders[0])
        got = rt.get(pending, timeout=300)
        print(f"  one more actor pending while all are leased; after "
              f"kill it runs with CUDA_VISIBLE_DEVICES={got['visible']}")
        if got["visible"] != seen[0]["visible"]:
            raise RuntimeError(f"freed id {seen[0]['visible']}, the "
                               f"pending actor got {got['visible']}")
        for h in holders[1:] + [extra]:
            rt.kill(h)

        make = rt.remote(num_gpus=1)(seeded_bf16)
        t0 = time.perf_counter()
        host = rt.get(make.remote(11), timeout=300)
        out["tensor_get_s"] = time.perf_counter() - t0
        ref = seeded_bf16(11).cpu()
        same = (host.device.type == "cpu" and host.dtype == ref.dtype
                and host.shape == ref.shape
                and torch.equal(host.view(torch.int16),
                                ref.view(torch.int16)))
        print(f"  task's bf16 CUDA tensor {tuple(host.shape)} reached the "
              f"driver's {host.device} in {out['tensor_get_s']:.3f} s "
              f"(task start included): bit-equal {same}")
        if not same:
            raise RuntimeError("the task's tensor differs from the driver's")

        stepper = rt.remote(num_gpus=1)(MainPathStepper).remote()
        rt.get(stepper.setup.remote(), timeout=600)
        rt_state.torch_profile(duration_s=0.5)   # profiler's first start
        run = stepper.run.remote(3, 2.0)
        captures = rt_state.torch_profile(duration_s=5.0)
        launches = rt.get(run, timeout=300)
        kernels = {}
        for c in captures:
            for name, n in (c.get("kernels") or {}).items():
                kernels[name] = kernels.get(name, 0) + n
        flash = {k: sum(n for name, n in kernels.items() if k in name)
                 for k in ("fwd_kernel", "dkv_kernel", "dq_kernel")}
        print(f"  capture of the actor over 3 steps: flash kernels "
              f"{flash} (3 steps launch 72/36/36; the actor counted "
              f"{launches}); {len(kernels)} kernel names; traces "
              f"{[c.get('path') for c in captures if c.get('kernels')]}")
        if launches != {"flash_fwd": 72, "flash_dkv": 36, "flash_dq": 36}:
            raise RuntimeError(f"actor's launches {launches}")
        if not all(flash.values()):
            raise RuntimeError(f"the capture misses a flash kernel: {flash}")
        out["captured"] = flash
        rt.kill(stepper)
    finally:
        rt.shutdown()
    return out


def trainer_loop(config):
    """The [trainer] train loop, in a runtime worker: the [main path]
    configuration at depth ``config["n_layer"]``, ``config["steps"]``
    steps with ``train.report`` after each.  One worker runs the
    unsharded step; a gang of several runs the sharded step
    data-parallel over the gang (``MeshSpec(data=world)``; each rank
    takes its half of the batch).  With ``config["crash_at"]`` it saves
    a checkpoint every step and rank 0 exits hard after that step's
    checkpoint, once; a restarted attempt resumes from the latest
    checkpoint.  Each report carries the step's device ms (CUDA events
    around the step) and the previous report's round trip; the last one
    also the flash launches counted in this worker."""
    import os
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.train import distributed

    mesh = None
    if train.get_world_size() > 1:
        from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh

        mesh = create_mesh(MeshSpec(data=train.get_world_size()),
                           device="cuda")
    cfg, state, step, data = main_path_parts(config["n_layer"], mesh)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        distributed.restore_train_state(state, ckpt.load_pytree("state"))
        start = state.step
    _kernels.reset_launches()
    report_ms = 0.0
    for i in range(start, config["steps"]):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        state, m = step(state, data)
        end.record()
        m = distributed.metrics_to_host(m)     # waits for the step
        metrics = {"step": i + 1, "loss": m["loss"],
                   "grad_norm": m["grad_norm"],
                   "step_ms": begin.elapsed_time(end),
                   "report_ms": report_ms, "pid": os.getpid()}
        if i + 1 == config["steps"]:
            metrics["launches"] = dict(_kernels.launches)
        checkpoint = None
        if config.get("crash_at"):
            with train.checkpoint_dir() as d:
                checkpoint = train.Checkpoint(d)
                checkpoint.save_pytree(
                    "state", distributed.train_state_tree(state))
        t0 = time.perf_counter()
        train.report(metrics, checkpoint=checkpoint)
        report_ms = 1e3 * (time.perf_counter() - t0)
        if i + 1 == config.get("crash_at") and train.get_world_rank() == 0 \
                and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)
    return True


def fit(config, storage: str, name: str, *, workers: int = 1,
        resources=None, max_failures: int = 0):
    """``TorchTrainer(trainer_loop)`` on a GPU gang; returns the Result
    and the seconds ``fit`` took."""
    from ray_tpu_torch.train import (FailureConfig, RunConfig,
                                     ScalingConfig, TorchTrainer)

    t0 = time.perf_counter()
    result = TorchTrainer(
        trainer_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=workers, use_gpu=True,
                                     resources_per_worker=resources),
        run_config=RunConfig(name=name, storage_path=storage,
                             failure_config=FailureConfig(
                                 max_failures=max_failures))).fit()
    if result.error is not None:
        raise RuntimeError(f"fit {name} failed: {result.error!r}")
    return result, time.perf_counter() - t0


def trainer_phase(card: str, unsharded: dict) -> dict:
    """[trainer] ``TorchTrainer`` with ``ScalingConfig(num_workers=1,
    use_gpu=True)`` runs the [main path] configuration (GPT-2 124M, full
    depth, B16 T1024, seed-0 weights and tokens, 1 + 10 steps) in a
    runtime worker holding the leased GPU, with ``train.report`` on
    every step.  Checks: 11 reports in ``Result.metrics_history``, the
    worker's launches 24/12/12 a step, losses within 1e-3 of [main
    path]'s (the largest difference printed; bit-equal expected).
    Printed, not gated: the worker's CUDA-event step median beside
    [main path]'s, the report round trip, the gang's start.  Then, at
    full width and 2 layers, 1 + 5 steps: one worker (the reference), a
    world-2 gang of ``{"CPU": 1, "GPU": 0.5}`` workers over gloo (one
    card cannot hold two NCCL ranks) whose first loss must be within
    1e-2 of the reference's, and one worker whose rank 0 exits after its
    step-3 checkpoint with ``max_failures=1``: the lease comes back and
    the run finishes with losses within 1e-3 of the reference's."""
    import tempfile

    import ray_tpu_torch as rt

    rt.init(mode="cluster", num_cpus=8)
    out = {}
    try:
        with tempfile.TemporaryDirectory() as storage:
            result, secs = fit({"n_layer": 12, "steps": 11}, storage,
                               "full")
            hist = [h["metrics"] for h in result.metrics_history]
            if len(hist) != 11:
                raise RuntimeError(f"{len(hist)} reports, expected 11")
            launches = hist[-1]["launches"]
            want = {"flash_fwd": 24 * 11, "flash_dkv": 12 * 11,
                    "flash_dq": 12 * 11}
            if launches != want:
                raise RuntimeError(f"worker launches {launches}, "
                                   f"expected {want}")
            losses = [h["loss"] for h in hist]
            gap = max(abs(a - b) for a, b in zip(losses,
                                                  unsharded["losses"]))
            step_ms = median([h["step_ms"] for h in hist[1:]])
            report_ms = median([h["report_ms"] for h in hist[1:]])
            start = registry_series().get(
                ("rt_train_worker_group_start_seconds", ()), (0, 0.0))
            print(f"  fit {secs:.3f} s (gang start {start[1]:.3f} s over "
                  f"{start[0]} starts); 11 reports; worker launches "
                  f"{launches}")
            print(f"  losses {losses}")
            print(f"  largest loss difference from [main path]: {gap:.3e} "
                  f"(limit 1e-3)")
            print(f"  worker's per-step device time median {step_ms:.3f} ms"
                  f" against [main path]'s {unsharded['median_ms']:.3f} "
                  f"({step_ms / unsharded['median_ms']:.4f}x; printed, not "
                  f"gated); report round trip median {report_ms:.3f} ms "
                  f"(card: {card})")
            if not gap <= 1e-3:
                raise RuntimeError("the trainer's losses differ from "
                                   "[main path]'s")
            out.update(fit_s=secs, gang_start_s=start[1],
                       step_median_ms=step_ms, report_ms=report_ms,
                       loss_gap=gap)

            ref, _s = fit({"n_layer": 2, "steps": 6}, storage, "ref2")
            ref = [h["metrics"]["loss"] for h in ref.metrics_history]
            pair, secs2 = fit({"n_layer": 2, "steps": 6}, storage, "world2",
                              workers=2, resources={"CPU": 1, "GPU": 0.5})
            pair = [h["metrics"] for h in pair.metrics_history]
            gap2 = abs(pair[0]["loss"] - ref[0])
            print(f"  depth 2: one worker {ref}")
            print(f"  world-2 gloo gang (GPU 0.5 each, {secs2:.3f} s): "
                  f"{[h['loss'] for h in pair]}; first-loss gap {gap2:.3e} "
                  f"(limit 1e-2)")
            if len(pair) != 6 or not gap2 < 1e-2:
                raise RuntimeError("the world-2 gang disagrees with one "
                                   "worker")
            marker = f"{storage}/crashed"
            crash, secs3 = fit({"n_layer": 2, "steps": 6, "crash_at": 3,
                                "marker": marker}, storage, "restart",
                               max_failures=1)
            crash = [h["metrics"] for h in crash.metrics_history]
            pids = sorted({h["pid"] for h in crash})
            by_step = {h["step"]: h["loss"] for h in crash}
            gap3 = max(abs(by_step[i + 1] - ref[i]) for i in range(6))
            print(f"  restart: steps {[h['step'] for h in crash]} from "
                  f"worker pids {pids} ({secs3:.3f} s); largest loss "
                  f"difference from the uninterrupted run {gap3:.3e} "
                  f"(limit 1e-3)")
            import os

            if not os.path.exists(marker) or len(pids) != 2 \
                    or sorted(by_step) != list(range(1, 7)) \
                    or not gap3 <= 1e-3:
                raise RuntimeError("the restarted run did not resume "
                                   "from its checkpoint")
            out.update(world2_loss_gap=gap2, restart_loss_gap=gap3)
    finally:
        rt.shutdown()
    return out


def _at(tree, name: str):
    for part in name.split("/"):
        tree = tree[part]
    return tree


# bench.py --serve-llm's engine configuration.
SERVE_ENGINE = dict(page_size=16, num_pages=256, max_batch=8,
                    prefill_token_budget=512)


def serve_requests(send, prompts, max_tokens: int, clients: int):
    """``bench.py --serve-llm``'s client loop: ``clients`` threads, each
    sending its share of ``prompts`` one after another and reading every
    frame of ``send(i, payload)`` for request i.  Returns each request's
    frames, TTFT and inter-token gaps (seconds, host clock) and the wall
    time of the whole load."""
    per = len(prompts) // clients
    results = [None] * len(prompts)

    def client(c: int) -> None:
        for i in range(c * per, (c + 1) * per):
            t0 = time.perf_counter()
            frames, stamps = [], []
            for fr in send(i, {"prompt": prompts[i],
                               "max_tokens": max_tokens}):
                frames.append(fr)
                if "token" in fr:
                    stamps.append(time.perf_counter())
            results[i] = {"frames": frames,
                          "ttft": stamps[0] - t0 if stamps else None,
                          "gaps": [b - a for a, b in zip(stamps, stamps[1:])]}

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise RuntimeError("serve clients still running after 600 s")
    return results, wall


def check_requests(results, max_tokens: int):
    """Every request ended with ``max_tokens`` tokens and reason
    "length", with no error frame.  Returns each request's tokens."""
    done = {"done": True, "reason": "length", "n_tokens": max_tokens}
    tokens = []
    for i, r in enumerate(results):
        if r is None:
            raise RuntimeError(f"request {i} got no result (client failed)")
        errors = [f for f in r["frames"] if "error" in f]
        toks = [f["token"] for f in r["frames"] if "token" in f]
        if errors or r["frames"][-1] != done or len(toks) != max_tokens:
            raise RuntimeError(f"request {i}: {len(toks)} tokens, last "
                               f"frame {r['frames'][-1]}, errors {errors}")
        tokens.append(toks)
    return tokens


def percentiles_ms(xs):
    import numpy as np

    ms = np.asarray(xs, np.float64) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def serve_load(model_cfg, clients: int, per_client: int, prompt_len: int,
               max_tokens: int):
    """Build an ``LLMDeployment`` (seed 0; its engine warms up in the
    background), wait for it, warm the request path with one request
    kept out of the accounting, then run the load and check it.
    Returns the load's record (with the metrics registry just before and
    just after the load, and the span ring after it), each request's
    tokens and the prompts."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import EngineConfig, LLMDeployment
    from ray_tpu_torch.util import tracing

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model_cfg.vocab_size, prompt_len).tolist()
               for _ in range(clients * per_client)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dep = LLMDeployment(model_cfg=model_cfg,
                        engine_cfg=EngineConfig(**SERVE_ENGINE), seed=0)
    try:
        dep.stats()                       # waits for build + warmup
        ready_s = time.perf_counter() - t0
        list(dep({"prompt": prompts[0], "max_tokens": 4, "warmup": True}))
        series_before = registry_series()

        def in_process(i, payload):
            # Without the serve plane: LLMDeployment.__call__ under the
            # request id req-<i>.
            with tracing.request_scope(f"req-{i}"):
                yield from dep(payload)

        results, wall = serve_requests(in_process, prompts, max_tokens,
                                       clients)
        stats = dep.stats()
        series_after = registry_series()
    finally:
        dep.stop()
    tokens = check_requests(results, max_tokens)
    if stats["step_errors"] != 0 or stats["kv_pages_used"] != 0:
        raise RuntimeError(f"engine stats after the load: {stats}")
    print(f"  {len(results)} requests ({clients} clients x {per_client}), "
          f"prompts {prompt_len}, {max_tokens} tokens each: every request "
          f"ended \"length\" with {max_tokens} tokens, no error frame, no "
          f"step error, every page free; engine built and warmed in "
          f"{ready_s:.1f} s")
    print(f"  engine stats: {json.dumps(stats)}")
    load = {"results": results, "wall": wall, "stats": stats,
            "ready_s": ready_s, "prompt_len": prompt_len,
            "max_tokens": max_tokens,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "series": (series_before, series_after)}
    return load, tokens, prompts


def load_numbers(model_cfg, load, card: str):
    """The serving numbers of a load (``serve_load``): tokens/s, TTFT and
    TPOT percentiles, decode MFU and peak device memory."""
    results = load["results"]
    n_tok = len(results) * load["max_tokens"]
    ttft = percentiles_ms([r["ttft"] for r in results])
    tpot = percentiles_ms([g for r in results for g in r["gaps"]])
    tok_s = n_tok / load["wall"]
    mfu = tok_s * model_cfg.decode_flops_per_token(
        load["prompt_len"] + load["max_tokens"] // 2) / PEAK_BF16_FLOPS
    out = {"requests": len(results), "tokens": n_tok,
           "tokens_per_s": tok_s, "ttft_p50_ms": ttft[0],
           "ttft_p99_ms": ttft[1], "tpot_p50_ms": tpot[0],
           "tpot_p99_ms": tpot[1], "decode_mfu": mfu,
           "ready_s": load["ready_s"], "engine_steps": load["stats"]["steps"],
           "evictions": load["stats"]["evictions"]}
    peak = ""
    if "peak_memory_gib" in load:    # the engine ran in this process
        out["peak_memory_gib"] = load["peak_memory_gib"]
        peak = f"; peak memory {out['peak_memory_gib']:.2f} GiB"
    print(f"  {n_tok} tokens in {load['wall']:.3f} s, {tok_s:.1f} tokens/s; "
          f"TTFT p50 {ttft[0]:.2f} ms p99 {ttft[1]:.2f} ms; TPOT p50 "
          f"{tpot[0]:.2f} ms p99 {tpot[1]:.2f} ms; decode MFU {mfu:.6f} of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 (card: {card})"
          + peak)
    return out


def check_serve_telemetry(load, num_pages: int, card: str):
    """The engine's series over the load (the registry's change from
    just before to just after it): tokens and prefill tokens, TPOT and
    TTFT-phase samples, one waiting, prefill and decode span per request
    id, the page gauges back to 0 of ``num_pages``, and the programs
    ``llm_decode`` and ``llm_prefill[...]`` registered with xprof.  The
    load's spans go through ``build_trace`` into a Chrome trace in a
    temporary directory; one request's hop chain and TTFT phases are
    printed."""
    import tempfile

    from ray_tpu_torch.util import reqtrace, spans, timeline, xprof

    before, after = load["series"]
    n = len(load["results"])
    prompt, max_tokens = load["prompt_len"], load["max_tokens"]

    def delta(name, **tags):
        key = (name, tuple(sorted(tags.items())))
        a, b = after.get(key, 0), before.get(key, 0)
        return a[0] - (b[0] if b else 0) if isinstance(a, tuple) else a - b

    got = {"tokens": delta("rt_llm_tokens_total"),
           "prefill tokens": delta("rt_llm_prefill_tokens_total"),
           "tpot samples": delta("rt_llm_tpot_seconds"),
           "ttft engine_waiting": delta("rt_serve_ttft_phase_seconds",
                                        phase="engine_waiting"),
           "ttft prefill": delta("rt_serve_ttft_phase_seconds",
                                 phase="prefill"),
           "pages used": need(after, "rt_llm_kv_pages_used"),
           "pages total": need(after, "rt_llm_kv_pages_total")}
    want = {"tokens": n * max_tokens, "prefill tokens": n * prompt,
            "tpot samples": n * (max_tokens - 1), "ttft engine_waiting": n,
            "ttft prefill": n, "pages used": 0, "pages total": num_pages}
    rids = {f"req-{i}" for i in range(n)}
    load_spans = [sp for sp in spans.snapshot()
                  if reqtrace.request_id_of(sp) in rids]
    found = set(reqtrace.find_request_ids(load_spans, prefix="req-"))
    names = {}
    for sp in load_spans:
        names.setdefault(reqtrace.request_id_of(sp), []).append(sp["name"])
    programs = sorted(xprof.local_programs())
    print(f"  telemetry over the load: {json.dumps(got)}; spans "
          f"{len(load_spans)} of {len(rids)} request ids; programs "
          f"{programs}")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/serve_trace.json"
        with open(path, "w") as f:
            json.dump(timeline.build_trace([], load_spans), f)
        with open(path) as f:
            n_events = len(json.load(f))
    trace = reqtrace.assemble_trace(load_spans, "req-0")
    print(f"  Chrome trace of the load: {n_events} events; req-0's TTFT "
          f"phases (s) {json.dumps(reqtrace.ttft_phases(trace['hops']))}, "
          f"hops (card: {card}):")
    for line in reqtrace.render_trace(trace).splitlines():
        print("  | " + line)
    if got != want or found != rids or any(sorted(names.get(r, [])) != [
            "decode", "engine_waiting", "prefill"] for r in rids) \
            or "llm_decode" not in programs \
            or not any(p.startswith("llm_prefill[") for p in programs):
        raise RuntimeError(f"serve telemetry: {got} against {want}, spans "
                           f"{names}, programs {programs}")


def check_logit_gaps(model, prompts, tokens):
    """Each greedy token of the first and the last request against the
    non-cached bf16 forward on the engine's weights: its logit must be
    within 0.1 of that forward's top logit.  A broken cache gives gaps
    of the order of the logits' spread (their standard deviation over
    the vocabulary, printed beside the gap).  Returns the largest gap and
    the spread."""
    import torch

    gaps, spreads = [], []
    with torch.no_grad():
        for i in (0, len(prompts) - 1):
            seq = torch.tensor([prompts[i] + tokens[i][:-1]], device="cuda")
            logits = model(seq)[0, len(prompts[i]) - 1:]
            got = logits.gather(-1, torch.tensor(tokens[i], device="cuda"
                                                 )[:, None])[:, 0]
            gaps.append(float((logits.max(-1).values - got).max()))
            spreads.append(float(logits.std(-1).mean()))
    print(f"  greedy tokens of requests 0 and {len(prompts) - 1} against the "
          f"non-cached bf16 forward: largest gap to the top logit "
          f"{max(gaps):.6f} (limit 0.1); logit spread {max(spreads):.6f}")
    if not max(gaps) <= 0.1:
        raise RuntimeError(f"greedy token {max(gaps)} below the top logit")
    return {"max_logit_gap": max(gaps), "logit_spread": max(spreads)}


def measure_decode(model, n_kv: int, card: str, batch: int = 8,
                   position: int = 31):
    """One decode forward at ``batch`` rows, each at ``position`` of its
    own pages, through the model's decode entry point over a pool of the
    engine's shape (the engine's forward, without the engine).  Host
    time (the call's return) and CUDA-event time over 10 calls; kernel
    time, launches and breakdown from the profiler; the weight casts and
    one layer's ``paged_attend`` timed alone; the device's busy share of
    an engine-like decode step (forward, logits to the host,
    sampling)."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm.kv_cache import (init_cache, pages_for,
                                            paged_attend)
    from ray_tpu_torch.llm.sampling import sample
    from ray_tpu_torch.models.gpt2 import Dense

    cfg = model.cfg
    ps, n_pages = SERVE_ENGINE["page_size"], SERVE_ENGINE["num_pages"]
    kv = init_cache(cfg.n_layer, n_pages, ps, n_kv, cfg.d_model // cfg.n_head,
                    cfg.dtype)
    per = position // ps + 1
    table = torch.zeros((batch, pages_for(min(cfg.max_seq, n_pages * ps),
                                          ps)), dtype=torch.long,
                        device="cuda")
    table[:, :per] = torch.arange(batch * per, device="cuda").view(batch,
                                                                   per)
    kv["page_table"] = table
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                           device="cuda")
    positions = torch.full((batch, 1), position, device="cuda")

    def forward():
        return model(tokens, kv_cache=kv, positions=positions)[0]

    def step():
        return [sample(row) for row in forward()[:, 0].cpu().numpy()]

    logits_w = model.wte if hasattr(model, "wte") else model.lm_head
    kernels = [m.kernel for m in model.modules() if isinstance(m, Dense)]

    def casts():
        for k in kernels:
            k.to(cfg.dtype)
        logits_w.to(cfg.dtype).float()   # matmul_f32 upcasts it again

    cast_bytes = (6 * sum(k.numel() for k in kernels)
                  + 12 * logits_w.numel()) if cfg.dtype != torch.float32 \
        else 0
    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        host, event = [], []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            forward()
            t1 = time.perf_counter()
            end.record()
            end.synchronize()
            host.append(1e3 * (t1 - t0))
            event.append(start.elapsed_time(end))
        prof = device_profile(forward, 3)
        step_prof = device_profile(step, 5)
        cast_ms = cuda_ms(casts, 5)
        q = torch.randn((batch, 1, cfg.n_head, cfg.d_model // cfg.n_head),
                        generator=gen, device="cuda").to(cfg.dtype)
        attend_ms = cfg.n_layer * cuda_ms(
            lambda: paged_attend(q, kv["k_pages"][0], kv["v_pages"][0],
                                 table, positions), 10)
    if prof is None or step_prof is None:
        raise RuntimeError("the profiler traced no device time")
    by_name = prof[0]
    groups = group_kernels(
        by_name, {"matrix products": MATMUL_KERNELS,
                  "copies and casts": ("copy",),
                  "gather (indexing)": ("index", "gather"),
                  "softmax": ("softmax",)}, "other")
    med = float(np.median(event))
    out = {"batch": batch, "position": position,
           "host_ms": float(np.median(host)), "event_ms": med,
           "kernel_ms": sum(groups.values()) / 3e3,
           "launches": sum(c for _us, c in by_name.values()) // 3,
           "kernel_ms_by_group": {g: us / 3e3 for g, us in groups.items()},
           "weight_cast_ms": cast_ms, "weight_cast_gb": cast_bytes / 1e9,
           "paged_attend_ms": attend_ms,
           "step_busy_share": step_prof[1] / step_prof[2]}
    print(f"  decode forward B{batch} at position {position}, medians of 10 "
          f"calls: host {out['host_ms']:.3f} ms to return, CUDA events "
          f"{med:.3f} ms; profiler: {out['launches']} launches, kernel "
          f"time {out['kernel_ms']:.3f} ms (card: {card})")
    print("    kernel ms by group: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in out["kernel_ms_by_group"].items()))
    print(f"    weight casts alone {cast_ms:.3f} ms ({cast_bytes / 1e9:.3f} "
          f"GB moved); paged_attend alone x {cfg.n_layer} layers "
          f"{attend_ms:.3f} ms; device busy share of a decode step "
          f"(forward, logits to host, sampling) {out['step_busy_share']:.4f}")
    for name, (us, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:12]:
        print(f"    {us / 3e3:9.4f} ms {count // 3:4d}x  {name[:150]}")
    return out


def free_device_memory() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def serve_gpt2(card: str):
    """[serve] GPT-2 124M, bf16: the load, the logit-gap check of two
    requests against the non-cached forward, one decode forward."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    cfg = GPT2Config(**GPT2_124M, remat=False, attn_impl="dense")
    load, tokens, prompts = serve_load(cfg, clients=8, per_client=4,
                                       prompt_len=16, max_tokens=32)
    out = load_numbers(cfg, load, card)
    check_serve_telemetry(load, SERVE_ENGINE["num_pages"], card)
    free_device_memory()
    # The engine's weights, made again from the same seed on the card.
    model = gpt2_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    out.update(check_logit_gaps(model, prompts, tokens))
    out["decode_forward"] = measure_decode(model, cfg.n_head, card)
    return out


def serve_gpt2_float32(card: str):
    """[serve] GPT-2 124M, float32: two requests' tokens equal the
    non-cached full forward's greedy tokens.  Too small a load for
    serving numbers; it records only its checks."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    cfg = GPT2Config(**GPT2_124M, remat=False, attn_impl="dense",
                     dtype=torch.float32)
    load, tokens, prompts = serve_load(cfg, clients=2, per_client=1,
                                       prompt_len=16, max_tokens=8)
    free_device_memory()
    model = gpt2_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        for prompt, got in zip(prompts, tokens):
            toks = list(prompt)
            for _ in range(len(got)):
                logits = model(torch.tensor([toks], device="cuda"))
                toks.append(int(logits[0, -1].argmax()))
            print(f"  engine {got}\n  full   {toks[len(prompt):]}")
            if toks[len(prompt):] != got:
                raise RuntimeError("float32 engine tokens differ from the "
                                   "non-cached forward's")
    return {"requests": len(tokens), "tokens": sum(map(len, tokens)),
            "engine_steps": load["stats"]["steps"],
            "tokens_equal_full_forward": True}


def serve_llama(card: str):
    """[serve] Llama-2-7B widths, bf16, full depth: the first phase's
    load, logit-gap check and decode forward."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, llama_init

    cfg = LlamaConfig.llama2_7b()
    load, tokens, prompts = serve_load(cfg, clients=8, per_client=4,
                                       prompt_len=16, max_tokens=32)
    out = load_numbers(cfg, load, card)
    free_device_memory()
    model = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    out.update(check_logit_gaps(model, prompts, tokens))
    out["decode_forward"] = measure_decode(model, cfg.n_kv_head, card)
    return out


def http_post(port: int, path: str, payload, close_after: int = 0):
    """POST JSON to the serve plane's HTTP ingress over a raw socket;
    returns (status, frames) for a streamed (chunked NDJSON) answer or
    (status, body) for a plain one.  ``close_after``: close the socket
    after that many token frames, the way a client that goes away does."""
    import socket

    body = json.dumps(payload).encode()
    req = (f"POST {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
           f"Content-Type: application/json\r\n"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(req)
        f = s.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        while (line := f.readline().strip()):
            k, _, v = line.decode().partition(":")
            headers[k.lower()] = v.strip()
        if "chunked" not in headers.get("transfer-encoding", ""):
            return status, json.loads(f.read(int(headers["content-length"])))
        frames = []
        while (size := int(f.readline().strip(), 16)):
            frames += [json.loads(ln) for ln in
                       f.read(size).decode().splitlines()]
            f.readline()
            if close_after and sum("token" in fr for fr in frames) \
                    >= close_after:
                break
    return status, frames


def until(cond, timeout: float, what: str, every: float = 0.1):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(every)
    raise RuntimeError(f"{what} (waited {timeout} s)")


def stream_via(handle):
    """``serve_requests``' sender through the serve plane: each request
    streamed by ``DeploymentHandle.stream`` under a fresh request id."""
    from ray_tpu_torch.util import tracing

    return lambda i, payload: handle.stream(
        payload, request_id=tracing.new_request_id())


def replica_stats(rt, ctl, name: str):
    """``stats()`` of every replica of a deployment, in replica order."""
    reps = rt.get(ctl.get_replicas.remote(name), timeout=60)
    return [rt.get(r.call_method.remote("stats", (), {}), timeout=600)
            for r in reps]


def replica_gpu_ids(rt, ctl, name: str):
    """Each replica's GPU ids as its node agent leased them (the ids the
    worker exported as ``CUDA_VISIBLE_DEVICES`` before CUDA started)."""
    from ray_tpu_torch.util import state as rt_state

    keys = {r.actor_id.hex()
            for r in rt.get(ctl.get_replicas.remote(name), timeout=60)}
    ids = []
    for n in rt_state.list_nodes():
        if not n["alive"]:
            continue
        workers = rt_state._agent_call(n["agent_addr"], "list_workers")
        pids = {w["pid"] for w in workers.get("workers", [])
                if w.get("actor_id") in keys}
        leases = rt_state._agent_call(n["agent_addr"], "list_leases")
        ids += [",".join(map(str, le["gpu_ids"]))
                for le in leases["leases"] if le["worker_pid"] in pids]
    return ids


def serve_plane(card: str, in_process: dict):
    """[serve plane] GPT-2 124M bf16 served through the port's serve
    plane, ``bench.py --serve-llm``'s way: ``serve.run(llm_deployment(
    ..., num_gpus=1), route_prefix="/llm")`` on a cluster runtime, the
    same engine configuration, prompts and load as ``[serve] GPT-2
    124M`` (8 clients x 4 requests, prompts 16, 32 greedy tokens), each
    request streamed through ``DeploymentHandle.stream`` under its own
    request id.  Fails unless every request ends "length" with 32
    tokens, the greedy tokens pass ``check_logit_gaps``, every page is
    free after the load and the controller replaced no replica.  Then
    the stdlib HTTP ingress: two requests' NDJSON frames equal the
    handle's for the same payloads, a client that closes its socket
    after 4 token frames leaves every page free within 5 s, a bad
    payload yields the error frame, an unknown route 404 (gRPC where
    ``grpc`` imports).  Then the cluster read back while the replica is
    up: ``cluster_summary``'s LLM tokens equal every token the clients
    received (the engine's own 2-token warmup included), its serve
    section counts the HTTP requests by status class, ``render_text``
    renders it and ``cluster_report`` lists the engine's programs.
    Last, two replicas on one card (``num_gpus=0.5``): both lease GPU
    id 0, both step, every request of the same load completes.  Prints
    tokens/s, TTFT/TPOT p50/p99 and decode MFU beside ``in_process``
    (the same run's ``[serve] GPT-2 124M``), the replica start time and
    the replicas' peak device memory."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineConfig, llm_deployment
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from ray_tpu_torch.util import telemetry, xprof

    cfg = GPT2Config(**GPT2_124M, remat=False, attn_impl="dense")
    clients, per_client, prompt_len, max_tokens = 8, 4, 16, 32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(clients * per_client)]
    out = {}
    rt.init(mode="cluster", num_cpus=8)
    try:
        # 1. Start the plane and warm it: serve.run to the first frame.
        t0 = time.perf_counter()
        handle = serve.run(llm_deployment(
            name="llm", model="gpt2", model_cfg=cfg,
            engine_cfg=EngineConfig(**SERVE_ENGINE), num_gpus=1),
            route_prefix="/llm")
        warm = list(handle.stream({"prompt": prompts[0], "max_tokens": 4,
                                   "warmup": True}))
        out["replica_start_s"] = time.perf_counter() - t0
        if sum("token" in fr for fr in warm) != 4:
            raise RuntimeError(f"warmup request: {warm}")
        ctl = rt.get_actor(serve.CONTROLLER_NAME)
        print(f"  serve.run to the warmup request's last frame: "
              f"{out['replica_start_s']:.3f} s (a GPU worker, the engine's "
              f"build and warmup)")

        # 2. bench.py --serve-llm's load through the handle.
        results, wall = serve_requests(stream_via(handle), prompts,
                                       max_tokens, clients)
        tokens = check_requests(results, max_tokens)
        (stats,) = replica_stats(rt, ctl, "llm")
        if stats["step_errors"] != 0 or stats["kv_pages_used"] != 0:
            raise RuntimeError(f"engine stats after the load: {stats}")
        load = {"results": results, "wall": wall, "stats": stats,
                "ready_s": out["replica_start_s"], "prompt_len": prompt_len,
                "max_tokens": max_tokens}
        print(f"  {len(results)} requests ({clients} clients x "
              f"{per_client}) through DeploymentHandle.stream: every "
              f"request ended \"length\" with {max_tokens} tokens, no error "
              f"frame, no step error, every page free")
        print(f"  engine stats: {json.dumps(stats)}")
        numbers = load_numbers(cfg, load, card)
        model = gpt2_init(cfg, torch.Generator(device="cuda").manual_seed(0))
        numbers.update(check_logit_gaps(model, prompts, tokens))
        del model
        free_device_memory()
        resil = rt.get(ctl.resilience_stats.remote(), timeout=60)["llm"]
        if resil["replacements"]:
            raise RuntimeError(f"replicas replaced: {resil}")
        print(f"  replacement log after warm-up and load: "
              f"{resil['replacements']} (replicas {resil['replicas']}/"
              f"{resil['target']})")
        received = 2 + 4 + len(tokens) * max_tokens   # engine warmup too
        summary = until(
            lambda: (s := telemetry.cluster_summary())["llm"]["tokens"]
            == received and s, 60, f"cluster_summary's LLM tokens never "
            f"reached the {received} the clients received", every=1.0)
        print(f"  cluster_summary after the load: LLM tokens "
              f"{summary['llm']['tokens']:.0f} = {received} received "
              f"(2 engine warmup + 4 warmup request + "
              f"{len(tokens)} x {max_tokens})")

        # 3. The stdlib HTTP ingress.
        port = serve.start_http_proxy()
        until(lambda: http_post(port, "/llm", {"prompt": [1],
                                               "max_tokens": 1})[0] == 200,
              60, "the /llm route never reached the HTTP proxy", 0.2)
        n_ingress = 1
        for i in (0, len(prompts) - 1):
            payload = {"prompt": prompts[i], "max_tokens": max_tokens}
            status, frames = http_post(port, "/llm", payload)
            n_ingress += 1
            want = list(handle.stream(payload))
            if status != 200 or frames != want:
                raise RuntimeError(f"HTTP request {i}: {status} {frames} "
                                   f"against the handle's {want}")
        print("  HTTP: two requests' NDJSON frames equal the handle's for "
              "the same payloads")
        status, frames = http_post(port, "/llm", {
            "prompt": prompts[1], "max_tokens": max_tokens}, close_after=4)
        n_ingress += 1
        t_close = time.perf_counter()
        until(lambda: replica_stats(rt, ctl, "llm")[0]["kv_pages_used"] == 0,
              5.0, "pages still held 5 s after the client went away")
        out["disconnect_pages_free_s"] = time.perf_counter() - t_close
        print(f"  a client closed its socket after "
              f"{sum('token' in fr for fr in frames)} token frames: every "
              f"page free {out['disconnect_pages_free_s']:.3f} s later")
        status, frames = http_post(port, "/llm", {"prompt": "not tokens"})
        n_ingress += 1
        if status != 200 or len(frames) != 1 or \
                not frames[0].get("error", "").startswith("bad request"):
            raise RuntimeError(f"bad payload: {status} {frames}")
        status, body = http_post(port, "/nope", {})
        if status != 404:
            raise RuntimeError(f"unknown route: {status} {body}")
        print(f"  bad payload -> {frames}; unknown route -> {status}")
        try:
            import grpc
        except ImportError:
            print("  gRPC: grpcio is absent on this machine; the gRPC "
                  "ingress is not run")
        else:
            gport = serve.start_grpc_proxy()
            with grpc.insecure_channel(f"127.0.0.1:{gport}") as ch:
                stream = ch.unary_stream(
                    "/ray_tpu.serve.Ingress/CallStream",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)
                payload = {"prompt": prompts[0], "max_tokens": 8}
                got = [json.loads(m) for m in stream(json.dumps(
                    {"deployment": "llm", "payload": payload}).encode(),
                    timeout=120)]
            n_ingress += 1
            if got != list(handle.stream(payload)):
                raise RuntimeError(f"gRPC frames {got}")
            print("  gRPC CallStream: frames equal the handle's")

        # 5. The cluster read back (while the replica is up: a replica's
        # series ship every metrics period and leave with it).
        def http_counted():
            s = telemetry.cluster_summary()
            classes = s["serve"].get("status_classes", {}).get("llm", {})
            return s if classes == {"2xx": n_ingress - 1, "4xx": 1} else None

        summary = until(http_counted, 60, f"cluster_summary never counted "
                        f"the {n_ingress} ingress requests to /llm", every=1.0)
        reqs = summary["serve"]["requests"]["llm"]
        if reqs["count"] != n_ingress:
            raise RuntimeError(f"rt_serve_request_seconds {reqs}")
        text = telemetry.render_text(summary)
        if "LLM engine (continuous batching):" not in text \
                or "Serve ingress:" not in text:
            raise RuntimeError("render_text lacks a section:\n" + text)
        report = xprof.cluster_report(summary=summary)
        programs = sorted(report["programs"])
        if "llm_decode" not in programs or not any(
                p.startswith("llm_prefill[") for p in programs):
            raise RuntimeError(f"cluster_report's programs {programs}")
        devmem = summary["xla"]["device_memory"]
        out["peak_memory_gib"] = max(
            (d.get("peak", 0.0) for src in devmem.values()
             for d in src.values()), default=0.0) / 2**30
        print(f"  cluster_summary: /llm requests {reqs['count']} "
              f"(rt_serve_request_seconds), status classes "
              f"{summary['serve']['status_classes']['llm']}, TTFT series "
              f"{summary['serve'].get('ttft', {}).get('llm', {})}; "
              f"cluster_report programs {programs}; the replica's peak "
              f"device memory {out['peak_memory_gib']:.3f} GiB")
        for line in text.splitlines():
            print("  | " + line)
        serve.delete("llm")

        # 4. Two replicas on one card.
        t0 = time.perf_counter()
        handle2 = serve.run(llm_deployment(
            name="llm2", model="gpt2", model_cfg=cfg,
            engine_cfg=EngineConfig(**SERVE_ENGINE), num_replicas=2,
            num_gpus=0.5), route_prefix="/llm2")
        handle2._ensure_fresh()
        replica_stats(rt, ctl, "llm2")       # both engines built, warm
        out["two_replicas_start_s"] = time.perf_counter() - t0
        ids = replica_gpu_ids(rt, ctl, "llm2")
        if ids != ["0", "0"]:
            raise RuntimeError(f"the two replicas' GPU ids {ids}")
        results2, wall2 = serve_requests(stream_via(handle2), prompts,
                                         max_tokens, clients)
        tokens2 = check_requests(results2, max_tokens)
        stats2 = replica_stats(rt, ctl, "llm2")
        if any(st["steps"] <= 0 or st["kv_pages_used"] != 0
               or st["step_errors"] for st in stats2):
            raise RuntimeError(f"two replicas' stats {stats2}")
        resil = rt.get(ctl.resilience_stats.remote(), timeout=60)["llm2"]
        if resil["replacements"]:
            raise RuntimeError(f"replicas replaced: {resil}")
        out["two_replicas"] = {
            "gpu_ids": ids, "steps": [st["steps"] for st in stats2],
            "tokens_per_s": len(tokens2) * max_tokens / wall2}
        print(f"  two replicas (num_gpus=0.5) up in "
              f"{out['two_replicas_start_s']:.3f} s, both on GPU id "
              f"{ids}; the load: every request ended \"length\" with "
              f"{max_tokens} tokens, engine steps "
              f"{out['two_replicas']['steps']}, "
              f"{out['two_replicas']['tokens_per_s']:.1f} tokens/s; "
              f"replacements {resil['replacements']}")
        serve.delete("llm2")
        serve.shutdown()
    finally:
        rt.shutdown()
    for key in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
                "tpot_p99_ms", "decode_mfu"):
        out[key] = numbers[key]
        out[f"{key}_in_process"] = in_process[key]
        out[f"{key}_ratio"] = numbers[key] / in_process[key]
    out.update({k: numbers[k] for k in ("requests", "tokens", "engine_steps",
                                        "max_logit_gap")})
    print("  through the plane / in process ([serve] GPT-2 124M, this "
          f"run; card: {card}):")
    for key in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
                "tpot_p99_ms", "decode_mfu"):
        plane_v, local_v = out[key], out[key + "_in_process"]
        print(f"    {key:<12} {plane_v:12.6f} / {local_v:12.6f} = "
              f"{out[key + '_ratio']:.4f}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _kernels

    # The float32 references run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{[str(p.name) for p in libs.values()]}")
    for name, lib in libs.items():
        print(f"[build] {name}: dynamic shared memory "
              f"{_kernels.dynamic_smem(name)} bytes a block; ptxas:")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print("  " + line.strip())

    print("[kernels] small cases: partial 128-row tiles (T = 64, 320), "
          "B*H = 6, and a non-causal T = 256")
    for t, causal in ((64, True), (64, False), (320, True), (320, False)):
        check_kernels(2, t, 3, 64, causal=causal, seed=3, timed=False)
    check_kernels(2, 256, 4, 64, causal=False, seed=1, timed=False)
    print("[kernels] B*H = 144 (more items per q block than the 132 SMs: "
          "several persistent rounds), T = 320 (last item half past T)")
    check_kernels(12, 320, 12, 64, causal=True, seed=4, timed=False)
    print("[kernels] main-path shape B16 T1024 H12 D64 bf16 causal")
    results = check_kernels(16, 1024, 12, 64, causal=True, seed=2,
                            timed=True)

    print("[kernels] lse cotangent: flash_attention_with_lse with random "
          "dO and dlse, B16 T1024 H12 D64 bf16")
    for causal in (True, False):
        check_lse_cotangent(16, 1024, 12, 64, causal=causal, seed=6)

    profile = "--profile" in sys.argv[1:]
    print("[main path] GPT-2 124M, B16 T1024, flash + remat, chunk 256")
    counts, unsharded = main_path(card, profile=profile)
    free_device_memory()

    print("[telemetry] the main path through make_sharded_train_step("
          "telemetry=True), TrainSession.iter_device_batches and "
          "session.report: goodput, the xprof harvest, the decomposition")
    telemetry = telemetry_phase(card, unsharded)
    free_device_memory()

    print("[sharded] GPT-2 124M, B16 T1024, world-1 NCCL gang, DTensor "
          "state, ring attention, full-logits loss")
    with world1_gang() as (mesh, group_name):
        _counts, sharded = sharded_path(card, unsharded, mesh,
                                        profile=profile)
        nccl_telemetry(group_name, card)
        print("[checkpoint] the [sharded] state: save_sharded, load_sharded "
              "onto the mesh and on the host, one more step from each")
        checkpoint_phase(card, sharded)
        del sharded
    free_device_memory()

    print("[moe] GPT-2 124M widths, 8 experts (d_ff 3072) in every other "
          "block, top-2, capacity 1.25, bf16, flash + remat, B16 T1024")
    moe_phase(card, unsharded, profile=profile)
    free_device_memory()

    print("[ring] ring (flash) and Ulysses attention, seq = 2 and 4 "
          "processes on one card, gloo, B4 T4096 H12 D64 bf16 causal")
    ring_phase(card)
    free_device_memory()

    print("[pipeline] GPipe over S = 2 and 4 processes on one card, gloo: "
          "GPT-2 124M blocks, B16 T1024 hidden states, M = 8, bf16 flash")
    pipeline_phase(card)
    free_device_memory()

    print("[runtime] the port's runtime: GPU detection and leases, "
          "CUDA_VISIBLE_DEVICES, a CUDA tensor through the object plane, "
          "a torch.profiler capture of an actor")
    runtime = runtime_phase(card)
    print("[trainer] TorchTrainer: the [main path] configuration in a GPU "
          "worker, a world-2 gloo gang, a restart from a checkpoint")
    runtime.update(trainer_phase(card, unsharded))

    serving = []
    for name, phase in (("GPT-2 124M", serve_gpt2),
                        ("GPT-2 124M float32", serve_gpt2_float32),
                        ("Llama-2-7B widths", serve_llama)):
        print(f"[serve] {name}")
        serving.append({"phase": name, **phase(card)})
        free_device_memory()

    print("[serve plane] GPT-2 124M bf16 through serve.run(llm_deployment("
          "num_gpus=1)): the handle, the stdlib HTTP ingress, the cluster "
          "read back, two replicas on one card")
    plane = serve_plane(card, serving[0])
    free_device_memory()

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name])
               for name in ("flash_fwd", "flash_dkv", "flash_dq")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"runtime": runtime}))
    print(json.dumps({"serve_plane": plane}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
