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
  within 1e-2 of the same steps in this process) and a restart from a
  checkpoint after a hard exit (losses within 1e-3 of the uninterrupted
  run).

Then the data and tune libraries (``ray_tpu_torch.data``,
``ray_tpu_torch.tune``) on the training path:

- ``[data]``: ``bench.py --data-pipeline``'s configuration: the main
  path's model fed from a Dataset of 8 block tasks (``{"tokens": int32
  [40, 1025]}`` from ``default_rng(1000 + i)``, 20 steps of B16) on a
  cluster runtime, an unpipelined epoch (``prefetch_blocks=0``, the
  copy to the card inline under ``train.data_wait()``) against a
  pipelined one (``prefetch_blocks=2`` into
  ``train.iter_device_batches(depth=2)``): every batch on ``cuda:0``
  and bit-equal to the rows made from the seeds, the losses within
  1e-3 of the same steps fed from host numpy, launches 24/12/12 a step;
  it prints both epochs' tokens/s and ``data_stall`` shares;
- ``[trainer data]``: ``TorchTrainer(datasets={"train": ds})``, the
  worker training on ``train.get_dataset_shard("train")``: 6 reports,
  losses within 1e-3 of ``[data]``'s first 6, launches 24/12/12 a step;
- ``[tune]``: a ``Tuner`` over a ``TorchTrainer`` at 2 layers, a grid
  of four rates under ASHA, all four trials at once sharing the card
  (``GPU: 0.25``): no trial in ERROR, the best result the lowest loss,
  every worker on GPU id 0, two trials overlapping, no libtorch in the
  runtime's controller or node agent.

Then the RL stack (``ray_tpu_torch.rl``) and the graft entry:

- ``[rl]`` (a): the PPO, IMPALA, DQN, SAC and BC learners at the JAX
  tests' default widths (hidden (64, 64); PPO a [T128, N4] rollout,
  minibatch 128, 4 epochs), each built on the card and on the CPU from
  the same weights, take one update on the same seeded batch: every
  parameter within 1e-4; then 20 more updates on the card, every loss
  finite, timed by CUDA events and the host clock, and 5 under
  ``torch.profiler`` (kernel busy time and launches an update); (b) two
  ``ImpalaTorchLearner`` actors leased ``GPU: 0.5`` each in a gloo
  group update on different batches, then ``sync_weights_collective``:
  both hold the host mean of their weights within 1e-6; (c)
  ``MultiAgentPPO`` self-play on tests/test_rl_multi_agent.py's
  two-agent bandit with the learners on the card, 12 iterations: each
  policy ends above 5.0 and 1.0 over its first iteration (JAX's bar),
  with env steps/s and the sampling/learning split; (d) where
  ``gymnasium`` is installed (decided once with ``find_spec``, printed
  either way), PPO on CartPole-v1 with the learner on the card to JAX's
  bar (above 50 after iteration 5, and 2.5x the first);
- ``[entry]``: ``ray_tpu_torch.entry.entry()`` (the counterpart of
  ``__graft_entry__.entry``): logits [2, 128, 8192], finite, within the
  bf16 bound of the same weights' CPU forward; its CUDA-event time.

Then the operator's path (the native pool, pip/uv envs, DAGs, state,
doctor and the ``rt`` CLI):

- ``[cluster]``: a head started by ``python -m ray_tpu_torch start
  --head --port 0 --num-gpus 1`` on the pool store, a driver attached
  with ``init(address="auto")``, ``rt status`` and ``rt list nodes``
  showing ``GPU: 1``; GPT-2 124M's float32 parameters (seed 0, 0.50 GB)
  and a 25.2 MB bf16 tensor through the pool (put and get GB/s), and a
  ``num_gpus=1`` actor that loads the parameters on the card and takes
  one main-path step (launches 24/12/12, the loss equal to ``[main
  path]``'s first loss bit for bit); ``num_gpus=1`` tasks in a pip env
  and, where ``uv`` is on PATH, a uv env, each holding a local package
  (its value, ``CUDA_VISIBLE_DEVICES``, a sum on the card; venv build and
  reuse seconds); a compiled DAG of a CPU token source and GPT-2 124M on
  the card, compiled outputs equal to interpreted ones (median ms per
  call of each); ``rt doctor`` without a critical finding, ``rt timeline
  --summary``, and ``rt stop`` leaving no process of the session and no
  pool region (see ``cluster_phase``).

Then the fleet tools (jobs, the ``rt://`` client, the dashboard, the
autoscaler and launcher, the control-plane benchmarks):

- ``[fleet]``: ``rt job submit --wait`` of a driver whose ``num_gpus=1``
  actor takes one [main path] step, a job stopped by ``rt job stop``
  (STOPPED, its process group gone), a driver with no GPU of its own
  through ``init(address="rt://...")`` taking the step in a task and
  moving [runtime]'s bf16 tensor through the relay, every dashboard
  route, the autoscaler launching a GPU node for a pending step and
  reaping it, ``rt up``/``exec``/``down`` with a GPU worker taking the
  step, and the quick control-plane benchmarks into a ledger of their
  own; every step's loss equal to [main path]'s first bit for bit at
  24/12/12 launches (see ``fleet_phase``);
- ``[tenant]``, on ``[fleet]``'s head after its jobs: two GPT-2 124M
  trainers submitted with ``rt job submit``, each ``TrainControllerV2``
  over a ``TorchTrainer`` gang of two half-GPU workers whose rank 0
  takes the [main path] steps.  ``train-hi`` (priority 10) preempts
  ``train-lo`` (priority 0) at its step 3: ``rt jobs`` shows the notice,
  ``train-lo`` saves its full state within the grace, no process of its
  gang holds the card when ``train-hi`` starts, ``train-hi`` takes 6
  steps, ``train-lo`` resumes from its notice checkpoint with an
  announced failure, every loss equals [main path]'s bit for bit at
  24/12/12, ``rt telemetry`` charges both jobs' workers' compute to
  them and ``rt doctor`` exits 0 (see ``tenant_phase``).

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
``[runtime]``'s and ``[trainer]``'s; one JSON line ``{"data": {...}}``
with ``[data]``'s, ``[trainer data]``'s and ``[tune]``'s; one JSON line
``{"serve_plane": {...}}`` with ``[serve plane]``'s; one JSON line
``{"rl": {...}}`` with ``[rl]``'s and ``[entry]``'s; one JSON line
``{"cluster": {...}}`` with ``[cluster]``'s; one JSON line
``{"tenant": {...}}`` with ``[tenant]``'s; one JSON line
``{"fleet": {...}}`` with ``[fleet]``'s; the card's name and power
limit (``nvidia-smi``); and last ``{"ok": true, "device": {...}}``.
``--profile`` adds a device-time breakdown of two more training steps, unsharded and sharded (see ``profile_steps``).
"""

import contextlib
import dataclasses
import gc
import json
import math
import shlex
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


def spawn_worlds(fn, axis: str, worlds=(2, 4)) -> dict:
    """``dryrun.spawn(fn, world)`` for every world at once, one thread
    each, so that the groups' processes start together; returns {world:
    the ranks' results}.  The groups share the card and nothing else
    (each has its own rendezvous directory)."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.dryrun import spawn

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(worlds)) as pool:
        futures = {w: pool.submit(spawn, fn, w, timeout=300.0)
                   for w in worlds}
        runs = {w: f.result() for w, f in futures.items()}
    print(f"  {axis} = {' and '.join(map(str, worlds))} at once: "
          f"{sum(worlds)} processes on cuda:0 ran in "
          f"{time.perf_counter() - t0:.1f} s")
    return runs


def ring_phase(card: str):
    """[ring] ``seq`` = 2 and 4 processes sharing the card, both groups
    at once, each a gloo group with a ``file://`` rendezvous
    (``dryrun.spawn``, join timeout 300 s):
    ring (flash kernels) and Ulysses attention at B4, global T 4096, H12,
    D64, bf16, causal.  The outputs and dQ/dK/dV gathered to rank 0 must
    be as close to the float32 reference as the single-process
    ``flash_attention`` on the full sequence is, under the kernel gate:
    within twice its error plus 2^-8 of the peak.  Each rank of the ring
    must launch its diagonal block and every block before it: r + 1
    forward, dK/dV and dQ kernels on rank r."""
    import torch

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
    for world, runs in spawn_worlds(ring_rank, "seq").items():
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
    """[pipeline] S = 2 and 4 processes sharing the card, both groups at
    once (``dryrun.spawn``, gloo, join timeout 300 s), each a stage of 12/S GPT-2 124M blocks,
    B16 T1024 hidden states in M = 8 microbatches.  The output, the
    input gradient and every parameter gradient gathered to rank 0 must
    be as close to the float32 run of the 12 blocks in sequence (dense
    attention) as the bf16 sequential run (flash) is, under the kernel
    gate: within twice its error plus 2^-8 of the peak.  Every stage
    runs each of the M + S - 1 ticks, so each rank must launch
    2 (M + S - 1) 12/S forward kernels (the forward and its
    recomputation) and (M + S - 1) 12/S of each backward kernel."""
    import torch

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
    for world, runs in spawn_worlds(pipeline_rank, "S").items():
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


def main_path_parts(n_layer: int = 12, mesh=None,
                    learning_rate: float = 3e-4):
    """The [main path] configuration at depth ``n_layer``: its config,
    state (seed-0 weights), step function and batch, built on the card.
    With a ``mesh``, [sharded]'s step over it: DTensor state, ring
    attention, the full-logits loss, the batch split over the mesh.
    ``learning_rate`` is the optimizer's peak rate ([tune] varies it)."""
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
    optimizer = make_optimizer(learning_rate=learning_rate,
                               total_steps=1000)
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
    a checkpoint at that step and the one before, and rank 0 exits hard
    after that step's checkpoint, once; a restarted attempt resumes from
    the latest checkpoint.  Each report carries the step's device ms (CUDA events
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
        crash_at = config.get("crash_at")
        if crash_at and i + 1 in (crash_at - 1, crash_at):
            with train.checkpoint_dir() as d:
                checkpoint = train.Checkpoint(d)
                checkpoint.save_pytree(
                    "state", distributed.train_state_tree(state))
        t0 = time.perf_counter()
        train.report(metrics, checkpoint=checkpoint)
        report_ms = 1e3 * (time.perf_counter() - t0)
        if i + 1 == crash_at and train.get_world_rank() == 0 \
                and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            os._exit(1)
    return True


def depth2_losses(steps: int) -> list:
    """[trainer]'s reference: the [main path] configuration at 2 layers,
    ``steps`` steps in this process, as one trainer worker runs them."""
    cfg, state, step, data = main_path_parts(2)
    losses = []
    for _ in range(steps):
        state, m = step(state, data)
        losses.append(float(m["loss"]))
    del state
    free_device_memory()
    return losses


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
    full width and 2 layers, 1 + 5 steps: this process (the reference), a
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

            ref = depth2_losses(6)
            pair, secs2 = fit({"n_layer": 2, "steps": 6}, storage, "world2",
                              workers=2, resources={"CPU": 1, "GPU": 0.5})
            pair = [h["metrics"] for h in pair.metrics_history]
            gap2 = abs(pair[0]["loss"] - ref[0])
            print(f"  depth 2: this process {ref}")
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


# bench.py --data-pipeline's dataset: 8 blocks of 40 rows of 1025 tokens
# (np.random.default_rng(1000 + i)), batches of 16: 20 steps an epoch.
DATA = dict(blocks=8, rows=40, batch=16, seed=1000)


def token_source(i: int, vocab: int, seq: int):
    """Block ``i`` of the [data] dataset (a block task's source)."""
    def src():
        import numpy as np

        rng = np.random.default_rng(DATA["seed"] + i)
        return {"tokens": rng.integers(0, vocab, (DATA["rows"], seq + 1),
                                       dtype=np.int64).astype(np.int32)}
    return src


def token_dataset():
    """The [data] dataset (lazy: its blocks are made by block tasks on
    each pass) and the rows it holds, built directly from the seeds."""
    import numpy as np

    from ray_tpu_torch import data as rt_data

    vocab, seq = GPT2_124M["vocab_size"], GPT2_124M["max_seq"]
    sources = [token_source(i, vocab, seq) for i in range(DATA["blocks"])]
    rows = np.concatenate([src()["tokens"] for src in sources])
    return rt_data.Dataset(sources), rows


def control_plane_torch() -> list:
    """Whether the runtime's controller and node agent map libtorch."""
    from ray_tpu_torch.core import runtime as runtime_mod

    out = []
    for proc in runtime_mod.get_runtime()._procs:
        with open(f"/proc/{proc.pid}/maps") as f:
            out.append("libtorch" in f.read())
    return out


def data_epoch(batches, state, step, *, inline_copy: bool):
    """One pass of [data]: a step per batch; returns (tokens/s, the
    data_stall share of the wall time, the losses, the batches as the
    step saw them).  ``inline_copy``: the loop waits for each host batch
    under ``train.data_wait()`` and copies it to the card itself;
    otherwise ``batches`` yields batches already placed on the card."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.util import goodput

    seq = GPT2_124M["max_seq"]
    ledger = goodput.reset()
    seen, losses = [], []
    it = iter(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        try:
            if inline_copy:
                with train.data_wait():
                    host = next(it)
                b = {"tokens": torch.as_tensor(host["tokens"],
                                               device="cuda")}
            else:
                b = next(it)
        except StopIteration:
            break
        with ledger.phase("compute"):
            state, m = step(state, b)
        seen.append(b["tokens"])
        losses.append(m["loss"])
    with ledger.phase("compute"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stall = ledger.snapshot()["seconds"].get("data_stall", 0.0)
    return (len(seen) * DATA["batch"] * seq / wall, stall / wall,
            [float(x) for x in losses], seen)


def check_batches(seen, rows, what: str) -> None:
    """Every batch on the card and equal, in order, to the rows built
    directly from the seeds."""
    import torch

    b = DATA["batch"]
    want = len(rows) // b
    if len(seen) != want:
        raise RuntimeError(f"{what}: {len(seen)} batches, expected {want}")
    for i, t in enumerate(seen):
        if t.device != torch.device("cuda", 0):
            raise RuntimeError(f"{what}: batch {i} on {t.device}")
        if not torch.equal(t.cpu(), torch.from_numpy(rows[i * b:(i + 1) * b])):
            raise RuntimeError(f"{what}: batch {i} differs from the rows "
                               f"made from its seeds")


def data_phase(card: str) -> dict:
    """[data] ``bench.py --data-pipeline``'s configuration on the port:
    GPT-2 124M (full depth, B16 T1024, bf16 flash, seed-0 weights) fed
    from a ``ray_tpu_torch.data`` Dataset of 8 block tasks (each
    ``{"tokens": int32 [40, 1025]}`` from ``default_rng(1000 + i)``) on
    ``init(mode="cluster", num_cpus=2)``.  After an untimed pass (the
    block tasks' workers start) and a warm step, two epochs of 20 steps
    from fresh seed-0 states: unpipelined (``prefetch_blocks=0``, the
    loop waits under ``train.data_wait()`` and copies each batch to the
    card itself) and pipelined (``prefetch_blocks=2`` into
    ``train.iter_device_batches(depth=2)``).  Checks: 20 batches each,
    every batch on ``cuda:0`` and bit-equal, in order, to the rows made
    directly from the seeds; the pipelined losses within 1e-3 of 20
    steps fed those rows straight from host numpy (bit-equal expected);
    flash launches 24/12/12 a step in the pipelined epoch.  Prints both
    epochs' tokens/s, their ratio and their ``data_stall`` shares.
    Returns the numbers, the pipelined losses and the dataset."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _kernels

    t_phase = time.perf_counter()
    b = DATA["batch"]
    rt.init(mode="cluster", num_cpus=2)
    try:
        ds, rows = token_dataset()
        t0 = time.perf_counter()
        n = sum(1 for _ in ds.iter_batches(batch_size=b, drop_last=True,
                                           prefetch_blocks=0))
        print(f"  untimed pass: {n} batches in "
              f"{time.perf_counter() - t0:.3f} s (block tasks' workers "
              f"start)")
        _cfg, state, step, data = main_path_parts()
        state, _m = step(state, data)            # warm the card
        del state, data
        free_device_memory()

        _cfg, state, step, _d = main_path_parts()
        base_tok_s, base_stall, base_losses, seen = data_epoch(
            ds.iter_batches(batch_size=b, batch_format="numpy",
                            drop_last=True, prefetch_blocks=0),
            state, step, inline_copy=True)
        check_batches(seen, rows, "unpipelined epoch")
        del state, seen
        free_device_memory()

        _cfg, state, step, _d = main_path_parts()
        _kernels.reset_launches()
        pipe_tok_s, pipe_stall, losses, seen = data_epoch(
            train.iter_device_batches(
                ds.iter_batches(batch_size=b, batch_format="numpy",
                                drop_last=True, prefetch_blocks=2),
                depth=2),
            state, step, inline_copy=False)
        launches = dict(_kernels.launches)
        check_batches(seen, rows, "pipelined epoch")
        del state, seen
        free_device_memory()
        steps = len(rows) // b
        want = {"flash_fwd": 24 * steps, "flash_dkv": 12 * steps,
                "flash_dq": 12 * steps}
        if launches != want:
            raise RuntimeError(f"pipelined epoch's launches {launches}, "
                               f"expected {want}")

        _cfg, state, step, _d = main_path_parts()
        direct = []
        for i in range(steps):
            state, m = step(state, {"tokens": torch.as_tensor(
                rows[i * b:(i + 1) * b], device="cuda")})
            direct.append(m["loss"])
        direct = [float(x) for x in direct]
        del state
        free_device_memory()
        gap = max(abs(x - y) for x, y in zip(losses, direct))
        base_gap = max(abs(x - y) for x, y in zip(base_losses, direct))
        print(f"  losses (pipelined) {losses}")
        print(f"  largest loss difference from the steps fed straight "
              f"from host numpy: pipelined {gap:.3e}, unpipelined "
              f"{base_gap:.3e} (limit 1e-3); launches {launches}")
        if not gap <= 1e-3 or not base_gap <= 1e-3:
            raise RuntimeError("the dataset-fed losses differ from the "
                               "directly fed ones")
        seconds = time.perf_counter() - t_phase
        print(f"  unpipelined {base_tok_s:.1f} tokens/s, data_stall share "
              f"{base_stall:.4f}; pipelined {pipe_tok_s:.1f} tokens/s, "
              f"data_stall share {pipe_stall:.4f}; ratio "
              f"{pipe_tok_s / base_tok_s:.4f} (card: {card}); phase "
              f"{seconds:.1f} s")
    finally:
        rt.shutdown()
    return {"tokens_per_s": pipe_tok_s, "unpipelined_tokens_per_s":
            base_tok_s, "ratio": pipe_tok_s / base_tok_s,
            "data_stall_share": pipe_stall,
            "data_stall_share_unpipelined": base_stall, "loss_gap": gap,
            "seconds": seconds}, losses, ds


def data_trainer_loop(config):
    """A TorchTrainer worker fed from its dataset shard: the [main path]
    configuration at depth ``config["n_layer"]`` (peak rate
    ``config["lr"]``), ``config["steps"]`` steps on the shard's batches
    (``prefetch_blocks=2`` into ``train.iter_device_batches``) with
    ``train.report`` after each.  Each report carries the loss, the
    worker's ``CUDA_VISIBLE_DEVICES``, its pid and the step's wall
    interval; the last one the flash launches counted here."""
    import os
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _kernels

    if config["dtype"] is not torch.bfloat16:
        raise RuntimeError(f"the loop's config arrived with dtype "
                           f"{config['dtype']!r}")
    _cfg, state, step, _d = main_path_parts(config["n_layer"],
                                            learning_rate=config["lr"])
    shard = train.get_dataset_shard("train")
    batches = train.iter_device_batches(
        shard.iter_batches(batch_size=config["batch"],
                           batch_format="numpy", drop_last=True,
                           prefetch_blocks=2), depth=2)
    _kernels.reset_launches()
    begin = time.time()
    for i, b in enumerate(batches):
        if b["tokens"].device != torch.device("cuda", 0):
            raise RuntimeError(f"batch on {b['tokens'].device}")
        state, m = step(state, b)
        metrics = {"step": i + 1, "loss": float(m["loss"]),
                   "gpu": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "pid": os.getpid(), "begin": begin, "end": time.time()}
        if i + 1 == config["steps"]:
            metrics["launches"] = dict(_kernels.launches)
        train.report(metrics)
        if i + 1 == config["steps"]:
            break
    batches.close()
    return True


def trainer_data_phase(card: str, ds, losses) -> dict:
    """[trainer data] ``TorchTrainer(ScalingConfig(num_workers=1,
    use_gpu=True), datasets={"train": ds})`` over [data]'s dataset: the
    worker reads ``train.get_dataset_shard("train")`` and runs the full
    depth step 1 + 5 times.  Checks: 6 reports, losses within 1e-3 of
    [data]'s pipelined first 6, the worker's launches 24/12/12 a
    step."""
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    t_phase = time.perf_counter()
    rt.init(mode="cluster", num_cpus=2)
    try:
        with tempfile.TemporaryDirectory() as storage:
            result = TorchTrainer(
                data_trainer_loop,
                train_loop_config={"n_layer": 12, "steps": 6, "lr": 3e-4,
                                   "batch": DATA["batch"],
                                   "dtype": torch.bfloat16},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(name="trainer_data",
                                     storage_path=storage),
                datasets={"train": ds}).fit()
        if result.error is not None:
            raise RuntimeError(f"fit failed: {result.error!r}")
        hist = [h["metrics"] for h in result.metrics_history]
        got = [h["loss"] for h in hist]
        launches = hist[-1].get("launches") if hist else None
        gap = max((abs(a - b) for a, b in zip(got, losses)), default=0.0)
        print(f"  {len(hist)} reports; losses {got}; largest difference "
              f"from [data]'s first 6 {gap:.3e} (limit 1e-3); worker "
              f"launches {launches}; GPU {hist[0]['gpu'] if hist else None}")
        if len(hist) != 6 or not gap <= 1e-3:
            raise RuntimeError("the trainer's dataset-fed losses differ "
                               "from [data]'s")
        if launches != {"flash_fwd": 144, "flash_dkv": 72, "flash_dq": 72}:
            raise RuntimeError(f"worker launches {launches}")
        seconds = time.perf_counter() - t_phase
        print(f"  phase {seconds:.1f} s (card: {card})")
    finally:
        rt.shutdown()
    return {"loss_gap": gap, "seconds": seconds}


TUNE = dict(n_layer=2, steps=8, lrs=[1e-4, 3e-4, 1e-3, 3e-3], concurrent=4)


def tune_phase(card: str, ds) -> dict:
    """[tune] a ``Tuner`` over a ``TorchTrainer`` at GPT-2 124M widths
    with 2 layers: ``grid_search`` over four peak rates, all four trials
    at once under ``ASHAScheduler(max_t=8, grace_period=2)``, each trial
    a one-worker trainer (``{"CPU": 1, "GPU": 0.25}``, so four share the
    card; 12 logical CPUs hold the trial actors, the workers and the
    dataset's block tasks) running 8 steps on [data]'s dataset and reporting the loss
    each step; the trainer's loop config holds a ``torch.bfloat16``.
    Checks: every trial ends TERMINATED or STOPPED, none ERROR;
    ``get_best_result()`` is the trial with the lowest last loss; every
    trial's worker saw GPU id 0; two trials ran at the same time; the
    runtime's controller and node agent mapped no libtorch."""
    import itertools
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    t_phase = time.perf_counter()
    rt.init(mode="cluster", num_cpus=12)
    try:
        with tempfile.TemporaryDirectory() as storage:
            trainer = TorchTrainer(
                data_trainer_loop,
                train_loop_config={"n_layer": TUNE["n_layer"],
                                   "steps": TUNE["steps"],
                                   "batch": DATA["batch"],
                                   "dtype": torch.bfloat16},
                scaling_config=ScalingConfig(
                    num_workers=1,
                    resources_per_worker={
                        "CPU": 1, "GPU": 1 / TUNE["concurrent"]}),
                run_config=RunConfig(name="tuned", storage_path=storage),
                datasets={"train": ds})
            grid = tune.Tuner(
                trainer,
                param_space={"lr": tune.grid_search(TUNE["lrs"])},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min",
                    max_concurrent_trials=TUNE["concurrent"],
                    scheduler=tune.ASHAScheduler(
                        max_t=TUNE["steps"], grace_period=2))).fit()
        plane = control_plane_torch()
        trials = grid.trials
        for t in trials:
            last = t.last_metrics()
            print(f"  lr {t.config['lr']:g}: {t.status}, "
                  f"{len(t.history)} reports, last loss "
                  f"{last.get('loss')}, GPU "
                  f"{sorted({h.get('gpu') for h in t.history})}"
                  + (f", error {t.error!r}" if t.error else ""))
        bad = [t for t in trials if t.status not in ("TERMINATED",
                                                     "STOPPED")]
        if len(trials) != 4 or bad:
            raise RuntimeError(f"trials {[t.status for t in trials]}")
        best = grid.get_best_result()
        lowest = min(t.last_metrics()["loss"] for t in trials)
        gpus = {h.get("gpu") for t in trials for h in t.history}
        spans = [(min(h["begin"] for h in t.history),
                  max(h["end"] for h in t.history)) for t in trials]
        overlap = any(a[0] < b[1] and b[0] < a[1]
                      for a, b in itertools.combinations(spans, 2))
        print(f"  best lr {grid.best_config.get('lr')}: loss "
              f"{best.metrics['loss']} (lowest last loss {lowest}); GPU "
              f"ids seen {sorted(gpus, key=str)}; two trials overlapped "
              f"{overlap}; controller/agent map libtorch {plane}")
        if best.metrics["loss"] != lowest:
            raise RuntimeError("get_best_result is not the lowest loss")
        if gpus != {"0"}:
            raise RuntimeError(f"trial workers saw GPU ids {gpus}")
        if not overlap:
            raise RuntimeError("no two trials ran at the same time")
        if plane != [False, False]:
            raise RuntimeError(f"control plane maps libtorch: {plane}")
        seconds = time.perf_counter() - t_phase
        print(f"  Tuner wall time {seconds:.1f} s, 4 trials of "
              f"{TUNE['steps']} steps at 2 layers (card: {card})")
    finally:
        rt.shutdown()
    return {"seconds": seconds, "best_lr": grid.best_config.get("lr"),
            "statuses": [t.status for t in trials]}


RL = dict(hidden=(64, 64), updates=20, tol=1e-4, seed=2024)


def rl_batches():
    """[rl] (a)'s seeded numpy batches at the JAX tests' default widths:
    a PPO rollout [T128, N4] (CartPole's 4 observations, 2 actions), an
    IMPALA batch of two [T64, N4] rollouts ([64, 8]), DQN's replay batch
    of 64, SAC's of 256 (Pendulum's 3 observations, 1 action), BC's of
    256."""
    import numpy as np

    rng = np.random.default_rng(RL["seed"])

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    t, n = 128, 4
    ppo = {"obs": normal(t, n, 4), "actions": rng.integers(0, 2, (t, n)),
           "rewards": normal(t, n),
           "dones": (rng.random((t, n)) < 0.05).astype(np.float32),
           "logp": rng.uniform(-1.2, -0.3, (t, n)).astype(np.float32),
           "values": normal(t, n), "last_values": normal(n)}
    t, n = 64, 8
    impala = {"obs": normal(t, n, 4), "actions": rng.integers(0, 2, (t, n)),
              "rewards": normal(t, n),
              "dones": (rng.random((t, n)) < 0.05).astype(np.float32),
              "logp": rng.uniform(-1.2, -0.3, (t, n)).astype(np.float32),
              "last_obs": normal(n, 4)}

    def transitions(b, obs_dim, actions):
        return {"obs": normal(b, obs_dim), "actions": actions,
                "rewards": normal(b),
                "dones": (rng.random(b) < 0.1).astype(np.float32),
                "next_obs": normal(b, obs_dim)}

    dqn = transitions(64, 4, rng.integers(0, 2, 64).astype(np.int32))
    sac = transitions(256, 3, rng.uniform(-1, 1, (256, 1)).astype(
        np.float32))
    bc = {"obs": normal(256, 4), "action": rng.integers(0, 2, 256)}
    return {"PPO": ppo, "IMPALA": impala, "DQN": dqn, "SAC": sac, "BC": bc}


def rl_learner(name: str, device: str):
    """The learner ``name`` at the JAX tests' default widths, hidden
    (64, 64), seed 0 (its initial weights come from a CPU generator, so
    they are the same on every device)."""
    from ray_tpu_torch import rl

    spec = rl.RLModuleSpec(4, 2, RL["hidden"])
    if name == "PPO":
        return rl.PPOTorchLearner(
            spec, rl.PPOConfig(minibatch_size=128, num_epochs=4),
            device=device)
    if name == "IMPALA":
        return rl.ImpalaTorchLearner(spec, device=device)
    if name == "DQN":
        return rl.DQNTorchLearner(
            spec, rl.DQNTrainConfig(target_sync_every=10), device=device)
    if name == "SAC":
        return rl.SACTorchLearner(
            rl.ContinuousModuleSpec(3, 1, RL["hidden"]), device=device)
    return rl.BCTorchLearner(spec, device=device)


def rl_learner_state(learner) -> dict:
    """Every tensor an update changes: the module, DQN's target network,
    SAC's target critics and temperature; as float32 on the host."""
    sd = {f"module.{k}": v for k, v in learner.module.state_dict().items()}
    for part in ("target", "target_params"):
        if hasattr(learner, part):
            sd.update({f"{part}.{k}": v for k, v in
                       getattr(learner, part).state_dict().items()})
    if hasattr(learner, "log_alpha"):
        sd["log_alpha"] = learner.log_alpha
    return {k: v.detach().float().cpu() for k, v in sd.items()}


def rl_learner_updates(card: str) -> dict:
    """[rl] (a): each learner built on the card and on the CPU from the
    same weights takes one update on the same batch (PPO: 4 epochs of 4
    minibatches of 128, permutations from the learner's CPU generator);
    every parameter must agree within ``RL["tol"]``.  Then 20 more
    updates on the card, every loss finite, each timed by CUDA events
    and the host clock (medians), and 5 under ``torch.profiler`` for the
    kernels' busy time and launches an update."""
    import torch

    batches = rl_batches()
    out = {}
    for name, batch in batches.items():
        learners = {d: rl_learner(name, d) for d in ("cuda", "cpu")}
        learners["cpu"].module.load_state_dict(
            learners["cuda"].module.state_dict())
        first = {d: ln.update_from_batch(batch)
                 for d, ln in learners.items()}
        a, b = (rl_learner_state(ln) for ln in learners.values())
        err = max(float((a[k] - b[k]).abs().max()) for k in a)
        learner = learners["cuda"]
        if next(learner.module.parameters()).device.type != "cuda":
            raise RuntimeError(f"[rl] {name}: learner is not on the card")
        host_ms, event_ms, losses = [], [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(RL["updates"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            m = learner.update_from_batch(batch)
            end.record()
            end.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            event_ms.append(start.elapsed_time(end))
            losses.append(m.get("loss", m.get("critic_loss")))
        prof = device_profile(lambda: learner.update_from_batch(batch), 5)
        busy_ms = launches = None
        if prof is not None:
            by_name, busy, _wall = prof
            busy_ms = busy / 5 / 1e3
            launches = sum(c for _us, c in by_name.values()) // 5
        row = {"max_abs_err": err, "first_metrics_cuda": first["cuda"],
               "first_metrics_cpu": first["cpu"],
               "host_ms": median(host_ms), "cuda_event_ms": median(event_ms),
               "kernel_busy_ms": busy_ms, "launches": launches,
               "losses_finite": all(math.isfinite(x) for x in losses)}
        out[name] = row
        print(f"  {name}: card vs CPU after one update, max |diff| "
              f"{err:.3e} (tolerance {RL['tol']:g}); {RL['updates']} "
              f"updates on the card: host {row['host_ms']:.3f} ms, CUDA "
              f"events {row['cuda_event_ms']:.3f} ms (medians), kernels "
              + (f"busy {busy_ms:.3f} ms, {launches} launches an update"
                 if busy_ms is not None else "not measured (the profiler "
                 "traced no device time)")
              + f"; card: {card}")
        if err > RL["tol"]:
            raise RuntimeError(f"[rl] {name}: card and CPU updates differ "
                               f"by {err}")
        if not row["losses_finite"]:
            raise RuntimeError(f"[rl] {name}: non-finite loss {losses}")
    return out


def card_impala_learner_class():
    """``ImpalaTorchLearner`` with a probe of where it runs."""
    from ray_tpu_torch.rl import ImpalaTorchLearner

    class CardImpalaLearner(ImpalaTorchLearner):
        def where(self) -> dict:
            import os

            import torch

            return {"CUDA_VISIBLE_DEVICES":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(next(self.module.parameters()).device),
                    "name": torch.cuda.get_device_name(0)}

    return CardImpalaLearner


def rl_impala_sync(card: str) -> dict:
    """[rl] (b): two IMPALA learner actors leased ``GPU: 0.5`` each
    (``learner_actor_class``), declared a ``cpu`` (gloo) collective
    group, update on different batches, then ``sync_weights_collective``:
    both must hold the same parameters, the host mean of what each held
    before, within 1e-6."""
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import collective as col
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl.learner import learner_actor_class, tree_mean

    cls, dev = learner_actor_class(card_impala_learner_class(), 2,
                                   torch.device("cuda"))
    t0 = time.perf_counter()
    learners = [cls.remote(rl.RLModuleSpec(4, 2, RL["hidden"]),
                           rl.VTraceConfig(), seed=0, device=dev)
                for _ in range(2)]
    wheres = rt.get([ln.where.remote() for ln in learners], timeout=300)
    start_s = time.perf_counter() - t0
    group = "rl/impala-sync"
    col.create_collective_group(learners, 2, [0, 1], backend="cpu",
                                group_name=group)
    try:
        batch = rl_batches()["IMPALA"]
        other = {k: (v[::-1].copy() if k != "last_obs" else v + 1.0)
                 for k, v in batch.items()}
        rt.get([ln.update_from_batch.remote(b)
                for ln, b in zip(learners, (batch, other))], timeout=120)
        before = rt.get([ln.get_weights.remote() for ln in learners])
        mean = tree_mean(before)
        t1 = time.perf_counter()
        rt.get([ln.sync_weights_collective.remote(group)
                for ln in learners], timeout=120)
        sync_ms = 1e3 * (time.perf_counter() - t1)
        after = rt.get([ln.get_weights.remote() for ln in learners])
    finally:
        for ln in learners:
            rt.kill(ln)
    leaves = [(layer, leaf) for layer in mean["params"]
              for leaf in mean["params"][layer]]

    def diff(x, y):
        return max(float(np.abs(x["params"][a][b] - y["params"][a][b]).max())
                   for a, b in leaves)

    spread, between, to_mean = (diff(*before), diff(*after),
                                max(diff(w, mean) for w in after))
    print(f"  learners {wheres}, GPU lease {cls._options['num_gpus']} "
          f"each, started in {start_s:.1f} s; before the sync they "
          f"differ by {spread:.3e}; after it by {between:.3e}, and from "
          f"the host mean by {to_mean:.3e}; sync {sync_ms:.1f} ms "
          f"(card: {card})")
    if cls._options["num_gpus"] != 0.5 or any(
            not w["device"].startswith("cuda") for w in wheres):
        raise RuntimeError(f"[rl] IMPALA learners not on the card: {wheres}")
    if spread == 0.0 or between != 0.0 or to_mean > 1e-6:
        raise RuntimeError("[rl] IMPALA collective sync did not average")
    return {"where": wheres, "num_gpus_each": cls._options["num_gpus"],
            "start_s": start_s, "spread_before": spread,
            "spread_after": between, "err_vs_host_mean": to_mean,
            "sync_ms": sync_ms}


def bandit_env_class():
    """tests/test_rl_multi_agent.py's ``TwoAgentBandit`` (numpy only):
    each agent sees a one-hot context of 4 and earns 1 for acting on
    it, plus 0.5 each when both do; episodes of 8 steps."""
    import numpy as np

    from ray_tpu_torch.rl import MultiAgentEnv

    class TwoAgentBandit(MultiAgentEnv):
        possible_agents = ["a0", "a1"]
        CONTEXTS = 4
        EP_LEN = 8

        def __init__(self, seed=0):
            self._rng = np.random.default_rng(seed)
            self._t = 0
            self._ctx = {}

        def _draw(self):
            self._ctx = {aid: int(self._rng.integers(self.CONTEXTS))
                         for aid in self.possible_agents}
            return {aid: np.eye(self.CONTEXTS, dtype=np.float32)[c]
                    for aid, c in self._ctx.items()}

        def reset(self, *, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            return self._draw(), {}

        def step(self, actions):
            hits = {aid: float(int(actions[aid]) == self._ctx[aid])
                    for aid in self.possible_agents}
            bonus = 0.5 if all(hits.values()) else 0.0
            rewards = {aid: h + bonus for aid, h in hits.items()}
            self._t += 1
            done = self._t >= self.EP_LEN
            return (self._draw(), rewards, {"__all__": done},
                    {"__all__": False}, {})

    return TwoAgentBandit


def timed_calls(fn, spent: list):
    """``fn``, appending each call's host seconds to ``spent``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        spent.append(time.perf_counter() - t0)
        return out
    return call


def rl_multi_agent(card: str) -> dict:
    """[rl] (c): ``MultiAgentPPO`` self-play on the two-agent bandit,
    tests/test_rl_multi_agent.py's configuration (1 runner of 4 envs,
    rollouts of 64, lr 3e-3, no entropy bonus, minibatch 128, 4 epochs)
    with both policies' learners on the card, 12 iterations.  JAX's bar:
    each policy's return ends above 5.0 and at least 1.0 over its first
    iteration.  Prints env steps/s and the share of each iteration spent
    sampling (the runner) and learning (the two updates on the card)."""
    from ray_tpu_torch import rl

    env = bandit_env_class()
    spec = rl.RLModuleSpec(env.CONTEXTS, env.CONTEXTS, (32,))
    algo = (rl.MultiAgentConfig()
            .environment(env)
            .multi_agent(policies={"p0": spec, "p1": spec},
                         policy_mapping_fn=lambda aid:
                         "p0" if aid == "a0" else "p1")
            .env_runners(num_env_runners=1, num_envs_per_runner=4,
                         rollout_length=64)
            .learners(device="cuda")
            .training(lr=3e-3, entropy_coeff=0.0, minibatch_size=128,
                      num_epochs=4)
            .build())
    sample_s, learn_s = [], []
    algo.env_runner_group.sample = timed_calls(algo.env_runner_group.sample,
                                               sample_s)
    for lg in algo.learners.values():
        if lg.local.device.type != "cuda":
            raise RuntimeError("[rl] multi-agent learner is not on the card")
        lg.update = timed_calls(lg.update, learn_s)
    results = []
    try:
        for _ in range(12):
            results.append(algo.train())
    finally:
        algo.stop()
    first, last = results[0], results[-1]
    iters = [r["time_this_iter_s"] for r in results]
    learn = [a + b for a, b in zip(learn_s[::2], learn_s[1::2])]
    steps = 64 * 4
    for aid in ("a0", "a1"):
        key = f"episode_return_mean/{aid}"
        print(f"  {aid}: return {first[key]:.3f} -> {last[key]:.3f}")
    out = {"first": {k: v for k, v in first.items() if "return" in k},
           "last": {k: v for k, v in last.items() if "return" in k},
           "env_steps_per_s": steps * len(iters) / sum(iters),
           "iteration_s_median": median(iters),
           "sample_share": sum(sample_s) / sum(iters),
           "learn_share": sum(learn) / sum(iters),
           "learn_ms_median": 1e3 * median(learn)}
    print(f"  {out['env_steps_per_s']:.1f} env steps/s ({steps} a "
          f"iteration, 2 agents each); iteration {out['iteration_s_median']:.4f}"
          f" s (median): sampling {out['sample_share']:.4f}, learning "
          f"{out['learn_share']:.4f} (two updates, "
          f"{out['learn_ms_median']:.3f} ms median; card: {card})")
    for aid in ("a0", "a1"):
        key = f"episode_return_mean/{aid}"
        if not (last[key] > 5.0 and last[key] > first[key] + 1.0):
            raise RuntimeError(f"[rl] multi-agent {aid} did not learn: "
                               f"{first[key]} -> {last[key]}")
    return out


def rl_cartpole(card: str) -> dict:
    """[rl] (d): where gymnasium is installed, PPO on CartPole-v1 as
    tests/test_rl.py runs it (2 runners of 4 envs, rollouts of 128, lr
    3e-3, minibatch 256, 4 epochs, 20 iterations) with the learner on
    the card; JAX's bar: a mean return above 50 after iteration 5 and
    above 2.5x the first iteration's."""
    import importlib.util

    if importlib.util.find_spec("gymnasium") is None:
        print("  gymnasium is not installed here: PPO on CartPole-v1 "
              "is not run")
        return {"ran": False, "reason": "gymnasium is not installed"}
    from ray_tpu_torch import rl

    def make_env():
        import gymnasium as gym

        return gym.make("CartPole-v1")

    algo = (rl.AlgorithmConfig()
            .environment(make_env, observation_dim=4, action_dim=2)
            .env_runners(num_env_runners=2, num_envs_per_runner=4,
                         rollout_length=128)
            .learners(device="cuda")
            .training(lr=3e-3, minibatch_size=256, num_epochs=4)
            .build())
    try:
        results = [algo.train() for _ in range(20)]
    finally:
        algo.stop()
    returns = [r["episode_return_mean"] for r in results]
    rate = median([r["env_steps_per_sec"] for r in results])
    print(f"  PPO CartPole-v1 returns {[round(x, 1) for x in returns]}; "
          f"{rate:.1f} env steps/s (median; card: {card})")
    if not (max(returns[5:]) > 50 and max(returns) > 2.5 * returns[0]):
        raise RuntimeError(f"[rl] PPO CartPole did not learn: {returns}")
    return {"ran": True, "returns": returns, "env_steps_per_s": rate}


def rl_phase(card: str) -> dict:
    """[rl]: (a) the five learners' updates on the card against the CPU,
    then on one cluster runtime (b) two IMPALA learners sharing the card
    syncing over gloo, (c) multi-agent PPO self-play with its learners
    on the card, (d) PPO on CartPole-v1 where gymnasium is installed."""
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    out = {"learners": rl_learner_updates(card)}
    rt.init(mode="cluster", num_cpus=8)
    try:
        print("  (b) two IMPALA learners, GPU: 0.5 each, gloo weight sync")
        out["impala_sync"] = rl_impala_sync(card)
        print("  (c) MultiAgentPPO self-play, learners on the card")
        out["multi_agent"] = rl_multi_agent(card)
        print("  (d) PPO on CartPole-v1, learner on the card")
        out["cartpole"] = rl_cartpole(card)
    finally:
        rt.shutdown()
    out["seconds"] = time.perf_counter() - t0
    print(f"  [rl] took {out['seconds']:.1f} s")
    return out


def entry_phase(card: str) -> dict:
    """[entry]: ``ray_tpu_torch.entry.entry()`` (the counterpart of
    ``__graft_entry__.entry``, GPT-2 at vocab 8192, 4 layers, d_model
    512, bf16, tokens [2, 128]) on the card: logits of the expected
    shape, finite, and within the bf16 bound of
    tests/test_torch_gpt2.py (max 0.05, mean 0.01) of the same weights'
    forward on the CPU, for the entry's tokens and random ones; the
    forward's CUDA-event time."""
    import torch

    from ray_tpu_torch.entry import entry

    fn, (tokens,) = entry()
    ref, _ = entry(device="cpu")
    ref.load_state_dict(fn.state_dict())
    rand = torch.randint(0, fn.cfg.vocab_size, tokens.shape,
                         generator=torch.Generator().manual_seed(0))
    errs = []
    with torch.no_grad():
        for toks in (tokens.cpu(), rand):
            got = fn(toks.to(tokens.device)).float().cpu()
            want = ref(toks).float()
            if got.shape != (2, 128, 8192) or not torch.isfinite(got).all():
                raise RuntimeError(f"[entry] logits {got.shape}")
            err = (got - want).abs()
            errs.append((float(err.max()), float(err.mean())))
        ms = cuda_ms(lambda: fn(tokens), 20)
    print(f"  logits [2, 128, 8192] finite; card vs CPU max/mean |diff| "
          f"{errs}; forward {ms:.3f} ms (CUDA events, mean of 20; card: "
          f"{card})")
    if any(mx >= 0.05 or mean >= 0.01 for mx, mean in errs):
        raise RuntimeError(f"[entry] card and CPU logits differ: {errs}")
    return {"max_mean_abs_err": errs, "forward_ms": ms}


CLUSTER = dict(dag_calls=50, batch=(8, 128), seed=12)


def rt_cli(env: dict, *args, timeout: float = 120):
    """``python -m ray_tpu_torch <args>`` with the phase's session root;
    the caller reads the exit code."""
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


class PoolStepper:
    """A ``num_gpus=1`` actor: one [main path] step from parameters that
    come through the object store."""

    def step(self, refs):
        import os
        import time

        import numpy as np
        import torch

        import ray_tpu_torch as rt
        from ray_tpu_torch.core import runtime as runtime_mod
        from ray_tpu_torch.ops import _kernels

        t0 = time.perf_counter()
        params = rt.get(refs[0], timeout=300)
        get_s = time.perf_counter() - t0
        cfg, state, step, data = main_path_parts()
        model = state.model.state_dict()
        seeded = all(np.array_equal(params[k], v.cpu().numpy())
                     for k, v in model.items())
        with torch.no_grad():
            for k, v in model.items():
                v.copy_(torch.from_numpy(params[k]))
        torch.cuda.synchronize()
        _kernels.reset_launches()
        state, m = step(state, data)
        torch.cuda.synchronize()
        return {"loss": float(m["loss"]), "launches": dict(_kernels.launches),
                "seeded": seeded, "get_s": get_s,
                "store": type(runtime_mod.get_runtime().store).__name__,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def on_the_card_in_env(module: str):
    """A ``num_gpus=1`` task in a pip/uv env: the env's package value,
    its lease's ``CUDA_VISIBLE_DEVICES``, and a sum computed on the
    card."""
    import importlib
    import os
    import sys

    import torch

    x = torch.arange(1, 1001, device="cuda", dtype=torch.float64)
    return {"value": importlib.import_module(module).VALUE,
            "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "sum_sq": float((x * x).sum()), "python": sys.executable,
            "torch": torch.__version__,
            "device": torch.cuda.get_device_name(0)}


def local_package(root, name: str, value: int) -> list:
    """A package the cluster python lacks, installable with no index."""
    import os

    pkg = os.path.join(root, name)
    os.makedirs(os.path.join(pkg, name))
    with open(os.path.join(pkg, name, "__init__.py"), "w") as f:
        f.write(f"VALUE = {value}\n")
    with open(os.path.join(pkg, "pyproject.toml"), "w") as f:
        f.write('[build-system]\nrequires = ["setuptools"]\n'
                'build-backend = "setuptools.build_meta"\n'
                f'[project]\nname = "{name}"\nversion = "0.1.0"\n'
                f'[tool.setuptools]\npackages = ["{name}"]\n')
    return ["--no-index", "--no-build-isolation", pkg]


class TokenSource:
    """The DAG's CPU stage: seeded GPT-2 token batches."""

    def make(self, i):
        import numpy as np

        b, t = CLUSTER["batch"]
        return np.random.default_rng(CLUSTER["seed"] + i).integers(
            0, GPT2_124M["vocab_size"], (b, t), dtype=np.int64)


class Gpt2Argmax:
    """The DAG's card stage: GPT-2 124M at full width, float32, on the
    card; returns the host argmax of the logits."""

    def __init__(self):
        import torch

        from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

        gen = torch.Generator(device="cuda").manual_seed(0)
        self.model = gpt2_init(GPT2Config(**GPT2_124M), gen, device="cuda")

    def argmax(self, tokens):
        import torch

        with torch.no_grad():
            logits = self.model(torch.from_numpy(tokens).cuda())
        return logits.argmax(-1).cpu().numpy()


def cluster_phase(card: str, unsharded: dict) -> dict:
    """[cluster] The operator's path, through the entry points a user
    calls: (1) ``python -m ray_tpu_torch start --head --port 0 --num-gpus
    1`` starts a head on the pool store, a driver attaches with
    ``init(address="auto")``, and ``rt status`` / ``rt list nodes`` show
    ``GPU: 1``; (2) GPT-2 124M's float32 parameters (seed 0, ~0.50 GB of
    numpy) and [runtime]'s 25.2 MB bf16 tensor go through the pool (put
    and get GB/s), and a ``num_gpus=1`` actor loads the parameters on
    the card and takes one [main path] step: launches 24/12/12 and the
    loss equal to [main path]'s first loss bit for bit; (3) a
    ``num_gpus=1`` task in a pip env holding a local package (and in a
    uv env where ``uv`` is on PATH) returns the package's value, its
    ``CUDA_VISIBLE_DEVICES`` and a sum computed on the card; (4) a
    compiled DAG of a CPU actor making token batches [8, 128] and a
    ``num_gpus=1`` actor holding GPT-2 124M that returns the host argmax
    of the logits: 50 compiled calls equal 50 interpreted ones, median
    ms per call of each; (5) ``rt doctor`` finds nothing critical, ``rt
    timeline --summary`` runs, ``rt stop`` leaves no process of the
    session and no pool region.  Every step raises on a fault."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import runtime as runtime_mod
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from ray_tpu_torch.util import state as rt_state

    out = {}
    t_phase = time.perf_counter()
    shm = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    print("  df -B1 /dev/shm:\n    " + shm.replace("\n", "\n    "))
    root = tempfile.mkdtemp(prefix="rt_cluster_")
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        rt.__file__)))
    env = dict(os.environ, RT_SESSION_DIR_ROOT=root,
               RT_OBJECT_STORE_BACKEND="pool",
               PYTHONPATH=os.pathsep.join(
                   [checkout] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("RT_ADDRESS", None)
    saved = {k: os.environ.get(k) for k in ("RT_SESSION_DIR_ROOT",
                                            "RT_OBJECT_STORE_BACKEND")}
    os.environ.update(RT_SESSION_DIR_ROOT=root,
                      RT_OBJECT_STORE_BACKEND="pool")
    pids, session, connected = [], None, False
    try:
        # (1) head through the CLI, a driver through address="auto".
        t0 = time.perf_counter()
        r = rt_cli(env, "start", "--head", "--port", "0", "--num-gpus", "1")
        if r.returncode != 0:
            raise RuntimeError(f"[cluster] rt start: {r.stderr}{r.stdout}")
        trailer = dict(ln.split("=", 1) for ln in r.stdout.splitlines()
                       if ln.startswith("RT_"))
        pids = [int(p) for p in trailer["RT_PIDS"].split(",")]
        session = trailer["RT_SESSION"]
        out["start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt.init(address="auto")
        connected = True
        out["connect_s"] = time.perf_counter() - t0
        status = rt_cli(env, "status")
        nodes = json.loads(rt_cli(env, "list", "nodes", "--format",
                                  "json").stdout)
        gpus = [n["resources"].get("GPU") for n in nodes]
        print(f"  rt start --head {out['start_s']:.3f} s, init(address="
              f"'auto') {out['connect_s']:.3f} s; rt status:\n    "
              + status.stdout.strip().replace("\n", "\n    "))
        print(f"  rt list nodes: GPU {gpus}")
        if status.returncode != 0 or "GPU=1" not in status.stdout \
                or gpus != [1.0]:
            raise RuntimeError(f"[cluster] the head does not show GPU: 1 "
                               f"({status.stdout!r}, {gpus})")

        # (2) the pool: GPT-2 124M's parameters and the bf16 tensor.
        store = type(runtime_mod.get_runtime().store).__name__
        if store != "PoolObjectStore":
            raise RuntimeError(f"[cluster] the driver's store is {store}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = gpt2_init(GPT2Config(**GPT2_124M, remat=True,
                                     attn_impl="flash"), gen, device="cuda")
        params = {k: v.detach().cpu().numpy()
                  for k, v in model.state_dict().items()}
        del model
        nbytes = sum(a.nbytes for a in params.values())
        t0 = time.perf_counter()
        ref = rt.put(params)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = rt.get(ref, timeout=300)
        get_s = time.perf_counter() - t0
        if not all(np.array_equal(back[k], v) for k, v in params.items()):
            raise RuntimeError("[cluster] parameters changed in the pool")
        del back
        host = seeded_bf16(11).cpu()
        t0 = time.perf_counter()
        tref = rt.put(host)
        tput_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tback = rt.get(tref, timeout=300)
        tget_s = time.perf_counter() - t0
        if not torch.equal(tback.view(torch.int16), host.view(torch.int16)):
            raise RuntimeError("[cluster] the bf16 tensor changed in the "
                               "pool")
        tbytes = host.numel() * host.element_size()
        out["pool"] = {"params_bytes": nbytes,
                       "params_put_gb_s": nbytes / put_s / 1e9,
                       "params_get_gb_s": nbytes / get_s / 1e9,
                       "tensor_bytes": tbytes,
                       "tensor_put_gb_s": tbytes / tput_s / 1e9,
                       "tensor_get_gb_s": tbytes / tget_s / 1e9}
        print(f"  store {store}: GPT-2 124M float32 parameters "
              f"{nbytes / 1e9:.4f} GB put {put_s:.3f} s "
              f"({out['pool']['params_put_gb_s']:.3f} GB/s), get "
              f"{get_s:.3f} s ({out['pool']['params_get_gb_s']:.3f} GB/s);"
              f" bf16 tensor {tbytes / 1e6:.1f} MB put "
              f"{out['pool']['tensor_put_gb_s']:.3f} GB/s, get "
              f"{out['pool']['tensor_get_gb_s']:.3f} GB/s (host clock; "
              f"card: {card})")
        stepper = rt.remote(num_gpus=1)(PoolStepper).remote()
        t0 = time.perf_counter()
        got = rt.get(stepper.step.remote([ref]), timeout=600)
        out["actor_step_s"] = time.perf_counter() - t0
        print(f"  num_gpus=1 actor: store {got['store']}, "
              f"CUDA_VISIBLE_DEVICES={got['visible']}, parameters from the "
              f"pool in {got['get_s']:.3f} s (equal to its own seed-0 "
              f"init: {got['seeded']}), one step loss {got['loss']!r} "
              f"([main path] first loss {unsharded['first_loss']!r}), "
              f"launches {got['launches']}; {out['actor_step_s']:.3f} s "
              f"with the actor's start")
        if got["store"] != "PoolObjectStore" or not got["seeded"]:
            raise RuntimeError(f"[cluster] the actor's parameters {got}")
        if got["launches"] != {"flash_fwd": 24, "flash_dkv": 12,
                               "flash_dq": 12}:
            raise RuntimeError(f"[cluster] launches {got['launches']}")
        if got["loss"] != unsharded["first_loss"]:
            raise RuntimeError(f"[cluster] loss {got['loss']!r} is not "
                               f"[main path]'s {unsharded['first_loss']!r}")
        out["step_loss"] = got["loss"]
        rt.kill(stepper)
        del params, ref, tref, tback

        # (3) pip / uv envs holding a local package, on the card.
        tools = ["pip"] + (["uv"] if shutil.which("uv") else [])
        print(f"  uv on PATH: {shutil.which('uv')}; envs {tools}")
        for tool in tools:
            name = f"rtcluster_{tool}dep"
            reqs = local_package(root, name, 42 if tool == "pip" else 7)
            task = rt.remote(num_gpus=1, runtime_env={tool: reqs})(
                on_the_card_in_env)
            t0 = time.perf_counter()
            first = rt.get(task.remote(name), timeout=600)
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm = rt.get(task.remote(name), timeout=300)
            warm_s = time.perf_counter() - t0
            # Another env hash (an env var more), the same requirements:
            # a new worker that starts in the venv already built.
            other = rt.remote(num_gpus=1, runtime_env={
                tool: reqs, "env_vars": {"CLUSTER_PHASE_REUSE": "1"}})(
                    on_the_card_in_env)
            t0 = time.perf_counter()
            reused = rt.get(other.remote(name), timeout=300)
            reuse_s = time.perf_counter() - t0
            print(f"  {tool} env: {first}; first call (venv build, worker "
                  f"and CUDA start) {build_s:.3f} s; the same worker again "
                  f"{warm_s:.3f} s; a new worker in the built venv (worker "
                  f"and CUDA start) {reuse_s:.3f} s (host clock; card: "
                  f"{card})")
            want = 42 if tool == "pip" else 7
            prefix = "venv-" if tool == "pip" else "uv-"
            for got_ in (first, warm, reused):
                if got_["value"] != want or got_["visible"] != "0" \
                        or got_["sum_sq"] != 333833500.0 \
                        or got_["python"] != first["python"] \
                        or prefix not in got_["python"]:
                    raise RuntimeError(f"[cluster] {tool} env task {got_}")
            if reused["pid"] == first["pid"]:
                raise RuntimeError(f"[cluster] {tool}: no new worker")
            out[tool] = {"build_s": build_s, "warm_s": warm_s,
                         "reuse_s": reuse_s}

        # (4) a compiled DAG: CPU token source -> GPT-2 on the card.
        src = rt.remote(num_cpus=1, max_concurrency=2)(TokenSource).remote()
        gpu = rt.remote(num_gpus=1, max_concurrency=2)(Gpt2Argmax).remote()
        with InputNode() as inp:
            node = gpu.argmax.bind(src.make.bind(inp))
        n = CLUSTER["dag_calls"]
        node.execute(0)   # both actors up, the model's first forward
        eager, eager_s = [], []
        for i in range(n):
            t0 = time.perf_counter()
            eager.append(node.execute(i))
            eager_s.append(time.perf_counter() - t0)
        dag = node.experimental_compile()
        try:
            dag.execute(0).get()
            compiled, compiled_s = [], []
            for i in range(n):
                t0 = time.perf_counter()
                compiled.append(dag.execute(i).get())
                compiled_s.append(time.perf_counter() - t0)
        finally:
            dag.teardown()
        same = all(a.shape == CLUSTER["batch"] and np.array_equal(a, b)
                   for a, b in zip(eager, compiled))
        out["dag"] = {"calls": n, "interpreted_ms": 1e3 * median(eager_s),
                      "compiled_ms": 1e3 * median(compiled_s)}
        print(f"  DAG TokenSource.make -> Gpt2Argmax.argmax [8, 128]: "
              f"{n} compiled outputs equal the interpreted ones: {same}; "
              f"median ms per call interpreted "
              f"{out['dag']['interpreted_ms']:.3f}, compiled "
              f"{out['dag']['compiled_ms']:.3f} (host clock; card: {card})")
        if not same:
            raise RuntimeError("[cluster] compiled DAG outputs differ")
        rt.kill(src)
        rt.kill(gpu)

        # (5) doctor, timeline, then stop with nothing left behind.
        r = rt_cli(env, "doctor", "--format", "json")
        findings = json.loads(r.stdout)["findings"]
        critical = [f for f in findings if f["severity"] == "critical"]
        print(f"  rt doctor: exit {r.returncode}, findings "
              f"{[(f['check'], f['severity']) for f in findings]}")
        if critical or r.returncode != 0:
            raise RuntimeError(f"[cluster] rt doctor: {critical}")
        r = rt_cli(env, "timeline", "--summary")
        print("  rt timeline --summary: exit "
              f"{r.returncode}\n    "
              + r.stdout.strip().replace("\n", "\n    "))
        if r.returncode != 0:
            raise RuntimeError(f"[cluster] rt timeline: {r.stderr}")
        for n_ in rt_state.list_nodes():
            workers = rt_state._agent_call(n_["agent_addr"], "list_workers")
            pids += [w["pid"] for w in workers["workers"] if w.get("pid")]
    finally:
        if connected:
            rt.shutdown()
        stop = rt_cli(env, "stop")
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"  rt stop: {stop.stdout.strip()}")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and [p for p in pids if alive(p)]:
        time.sleep(0.2)
    left = [p for p in pids if alive(p)]
    slab = os.path.exists(f"/dev/shm/rttpool_{session}")
    print(f"  session pids {sorted(set(pids))}: alive after stop {left}; "
          f"pool region left: {slab}")
    if stop.returncode != 0 or left or slab:
        raise RuntimeError(f"[cluster] rt stop left {left}, region {slab}")
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  [cluster] {out['wall_s']:.3f} s (card: {card})")
    return out


# ------------------------------------------------------------------ fleet
FLEET_LAUNCHES = {"flash_fwd": 24, "flash_dkv": 12, "flash_dq": 12}
# The autoscaled node's idle timeout (s): long enough for the head to
# see the finished step's lease return, short enough not to idle.
FLEET_IDLE_S = 5

# The JSON shape of each dashboard route (the JAX package's create_app):
# top-level keys that must be there, or "list" for a list of records.
DASHBOARD_ROUTES = {
    "/": None, "/api/nodes": "list", "/api/actors": "list",
    "/api/tasks": "list", "/api/jobs": {"jobs", "drivers"},
    "/api/objects": "list", "/api/logs": "list",
    "/api/logs?pid={pid}": None, "/api/stack?pid={pid}": None,
    "/api/profile?pid={pid}&duration=0.5": None,
    "/api/doctor": {"healthy", "findings"},
    "/api/perf": {"peaks"}, "/api/hotpath": {"count"},
    "/api/telemetry": {"goodput", "train", "collectives", "serve",
                       "flight"},
    "/api/timeline": "list", "/api/timeline?summary=1": {"steps"},
    "/api/slo": {"objectives"}, "/api/trace": {"exemplars"},
    "/api/timeseries": None, "/metrics": None, "/timeseries": None}


def fleet_step() -> dict:
    """One [main path] step in this process, on the card its lease
    gave it: the loss, the kernels' launches, where the model lives."""
    import os
    import time

    import torch

    from ray_tpu_torch.ops import _kernels

    started = time.time()
    cfg, state, step, data = main_path_parts()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    state, m = step(state, data)
    torch.cuda.synchronize()
    return {"loss": float(m["loss"]), "launches": dict(_kernels.launches),
            "device": str(next(state.model.parameters()).device),
            "name": torch.cuda.get_device_name(0),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "pid": os.getpid(), "started": started, "ended": time.time()}


class FleetStepper:
    """The job's ``num_gpus=1`` actor."""

    def step(self):
        return fleet_step()


def fleet_step_and_bf16():
    """``fleet_step``, and [runtime]'s bf16 tensor made on the same
    card (it leaves the worker as host memory)."""
    return fleet_step(), seeded_bf16(11)


def check_step(got: dict, unsharded: dict, what: str) -> None:
    """A fleet step ran on the card, through the kernels, and its loss
    is [main path]'s first loss bit for bit."""
    print(f"  {what}: loss {got['loss']!r} ([main path] first loss "
          f"{unsharded['first_loss']!r}), launches {got['launches']}, "
          f"model on {got['device']} ({got['name']}), "
          f"CUDA_VISIBLE_DEVICES={got['visible']}, pid {got['pid']}")
    if not got["device"].startswith("cuda"):
        raise RuntimeError(f"[fleet] {what} ran on {got['device']}")
    if got["launches"] != FLEET_LAUNCHES:
        raise RuntimeError(f"[fleet] {what}: launches {got['launches']}")
    if got["loss"] != unsharded["first_loss"]:
        raise RuntimeError(f"[fleet] {what}: loss {got['loss']!r} is not "
                           f"[main path]'s {unsharded['first_loss']!r}")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def maps_libtorch(pid: int) -> bool:
    """Whether a live process has libtorch mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def session_pids(session: str) -> list:
    """Live processes whose command line names ``session``."""
    out = subprocess.run(["pgrep", "-f", f"--session {session}"],
                         capture_output=True, text=True, timeout=30)
    return [int(p) for p in out.stdout.split() if alive(int(p))]


def http_get(port: int, path: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def fleet_jobs(card: str, env: dict, root: str, unsharded: dict,
               out: dict) -> None:
    """(1) a job whose entrypoint drives a ``num_gpus=1`` actor through
    one main-path step, and a second job stopped while it sleeps."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    module = os.path.splitext(os.path.basename(__file__))[0]
    entry = os.path.join(root, "job_entry.py")
    with open(entry, "w") as f:
        f.write(
            "import json, os, sys\n"
            f"sys.path.insert(0, {here!r})\n"
            f"import {module} as smoke\n"
            "import ray_tpu_torch as rt\n"
            "print('entrypoint CUDA_VISIBLE_DEVICES=[%s]' % "
            "os.environ.get('CUDA_VISIBLE_DEVICES'), flush=True)\n"
            "rt.init(address='auto')\n"
            "actor = rt.remote(num_gpus=1)(smoke.FleetStepper).remote()\n"
            "got = rt.get(actor.step.remote(), timeout=600)\n"
            "rt.kill(actor)\n"
            "print('FLEET_JOB ' + json.dumps(got), flush=True)\n")
    t0 = time.perf_counter()
    r = rt_cli(env, "job", "submit", "--wait", "--id", "fleet-step",
               "--timeout", "600", "--", sys.executable, entry,
               timeout=700)
    out["job_succeeded_s"] = time.perf_counter() - t0
    print(f"  rt job submit --wait: exit {r.returncode} in "
          f"{out['job_succeeded_s']:.3f} s (host clock; card: "
          f"{card})\n    "
          + r.stdout.strip().replace("\n", "\n    "))
    if r.returncode != 0 or "Job fleet-step: SUCCEEDED" not in r.stdout:
        raise RuntimeError(f"[fleet] job: {r.stdout}{r.stderr}")
    logs = rt_cli(env, "job", "logs", "fleet-step")
    logs_job = rt_cli(env, "logs", "--job", "fleet-step")
    if logs.returncode or logs.stdout != logs_job.stdout:
        raise RuntimeError(f"[fleet] rt logs --job differs: "
                           f"{logs.stdout!r} {logs_job.stdout!r}")
    if "entrypoint CUDA_VISIBLE_DEVICES=[]" not in logs.stdout:
        raise RuntimeError("[fleet] the job's entrypoint saw a GPU")
    line = [ln for ln in logs.stdout.splitlines()
            if ln.startswith("FLEET_JOB ")]
    got = json.loads(line[0][len("FLEET_JOB "):])
    check_step(got, unsharded, "job's num_gpus=1 actor")

    r = rt_cli(env, "job", "submit", "--id", "fleet-sleep", "--",
               "echo FLEET_PGID=$$; exec sleep 600")
    if r.returncode != 0:
        raise RuntimeError(f"[fleet] submit: {r.stderr}")
    deadline = time.monotonic() + 60
    pgid = None
    while pgid is None:
        text = rt_cli(env, "job", "logs", "fleet-sleep").stdout
        found = [ln for ln in text.splitlines()
                 if ln.startswith("FLEET_PGID=")]
        if found:
            pgid = int(found[0].split("=")[1])
        elif time.monotonic() > deadline:
            raise RuntimeError("[fleet] the sleeping job never ran")
        else:
            time.sleep(0.1)
    t0 = time.perf_counter()
    r = rt_cli(env, "job", "stop", "fleet-sleep")
    while "STOPPED" not in rt_cli(env, "job", "status",
                                  "fleet-sleep").stdout:
        if time.perf_counter() - t0 > 60:
            raise RuntimeError("[fleet] the job never reached STOPPED")
        time.sleep(0.1)
    out["job_stopped_s"] = time.perf_counter() - t0
    try:
        os.killpg(pgid, 0)
        group = "alive"
    except ProcessLookupError:
        group = "gone"
    listed = rt_cli(env, "job", "list").stdout
    print(f"  rt job stop: {r.stdout.strip()}; STOPPED in "
          f"{out['job_stopped_s']:.3f} s; process group {pgid} {group}; "
          f"rt job list:\n    " + listed.strip().replace("\n", "\n    "))
    if group != "gone" or "fleet-step  SUCCEEDED" not in listed \
            or "fleet-sleep  STOPPED" not in listed:
        raise RuntimeError(f"[fleet] stop left group {group}: {listed}")


# [tenant]: two GPT-2 trainers submitted as jobs contend for the card.
# One-worker gangs make no placement group (train/trainer.py
# ``_run_attempt``, as in the JAX package), so nothing could preempt
# them: each trainer is a gang of two half-GPU workers in one PACK group,
# rank 0 takes the [main path] steps on the card and rank 1 holds the
# lease's other half at the gloo gang's barrier.
TENANT = dict(lo_steps=6, hi_steps=6, notice_step=3, lo_priority=0,
              hi_priority=10, worker={"CPU": 1.0, "GPU": 0.5})


def goodput_flushed(job: str, timeout: float = 30.0) -> float:
    """Wait until this process's ``compute`` series, tagged ``job``, has
    reached the controller (one metrics report); returns the wait."""
    import os

    from ray_tpu_torch.util import goodput
    from ray_tpu_torch.util import state as rt_state

    t0 = time.monotonic()
    suffix = f"-{os.getpid()}"
    while True:
        for src, snaps in rt_state.telemetry()["sources"].items():
            if not src.endswith(suffix):
                continue
            for snap in snaps:
                if snap.get("name") == goodput.GAUGE_NAME and any(
                        s["tags"].get("job") == job
                        and s["tags"].get("phase") == "compute"
                        and s["value"] > 0 for s in snap["series"]):
                    return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"[tenant] {job}'s compute never reached "
                               f"the controller")
        time.sleep(0.2)


def tenant_loop(config):
    """[tenant]'s train loop, in each rank of a two-worker gang.  Rank 0
    takes the [main path] configuration's steps (seed-0 weights and
    batch) from its checkpoint, each under the ``compute`` goodput
    phase, reporting the loss, the step's launches and its end time; it
    saves the full train state after step ``save_at``, and in the first
    attempt waits after step ``wait_at`` for the preemption notice
    (``train.interrupted()``), saves the state under
    ``train.checkpoint_on_notice()``, reports it and waits to be killed.
    With ``watch``, before it touches the card it reports which of
    those processes are alive or map libtorch and the card's free
    memory.  Rank 1 holds the lease's other half: it waits at the gang's
    barrier, and so does rank 0 once its steps are done."""
    import glob
    import os
    import time

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.train import distributed
    from ray_tpu_torch.util import goodput

    rank = train.get_world_rank()
    ckpt = train.get_checkpoint()
    attempt = "resumed" if ckpt is not None else "first"
    with open(f"{config['pids']}-{attempt}-{rank}", "w") as f:
        f.write(str(os.getpid()))
    if rank != 0:
        dist.barrier()
        return True
    first = {"t_start": time.time()}
    if config.get("watch"):
        pids = [int(open(p).read()) for p in glob.glob(config["watch"]
                                                       + "-*")]
        first["watched"] = pids
        first["alive"] = [p for p in pids if alive(p)]
        first["still_holding"] = []
        for p in first["alive"]:
            with contextlib.suppress(OSError):
                if maps_libtorch(p):
                    first["still_holding"].append(p)
        free, total = torch.cuda.mem_get_info()
        first["card_free_gb"], first["card_total_gb"] = free / 1e9, \
            total / 1e9
    cfg, state, step, data = main_path_parts()
    start = 0
    if ckpt is not None:
        t0 = time.perf_counter()
        distributed.restore_train_state(state, ckpt.load_pytree("state"))
        start = state.step
        first["restore_s"] = time.perf_counter() - t0
    for i in range(start, config["steps"]):
        _kernels.reset_launches()
        with goodput.ledger().phase("compute"):
            state, m = step(state, data)
            m = distributed.metrics_to_host(m)     # waits for the step
        metrics = {"step": i + 1, "loss": m["loss"], "start": start,
                   "launches": dict(_kernels.launches), "pid": os.getpid(),
                   "t": time.time(), **first}
        first = {}
        checkpoint = None
        if i + 1 == config.get("save_at"):
            with train.checkpoint_dir() as d:
                checkpoint = train.Checkpoint(d)
                checkpoint.save_pytree(
                    "state", distributed.train_state_tree(state))
        train.report(metrics, checkpoint=checkpoint)
        with open(config["progress"], "w") as f:
            json.dump(metrics, f)
        if i + 1 == config.get("wait_at") and start == 0:
            waited = time.time()
            while not train.interrupted():
                if time.time() - waited > 300:
                    raise RuntimeError("no preemption notice in 300 s")
                time.sleep(0.05)
            noticed = time.time()
            deadline = train.interruption()["deadline"]
            with train.checkpoint_on_notice():
                with train.checkpoint_dir() as d:
                    checkpoint = train.Checkpoint(d)
                    checkpoint.save_pytree(
                        "state", distributed.train_state_tree(state))
                    saved = time.time()
                    size = sum(os.path.getsize(os.path.join(r, n))
                               for r, _d, ns in os.walk(d) for n in ns)
                    train.report({
                        "step": i + 1, "loss": m["loss"], "start": start,
                        "notice": True, "noticed": noticed,
                        "saved": saved, "deadline": deadline,
                        "bytes": size}, checkpoint=checkpoint)
            time.sleep(config["grace_s"] + 120)
            raise RuntimeError("not preempted after the grace")
    goodput_flushed(goodput.current_job_id())
    dist.barrier()
    return True


def tenant_job(role: str, config: dict) -> int:
    """A [tenant] job's entrypoint: ``TrainControllerV2`` over a
    ``TorchTrainer`` running ``tenant_loop`` on a two-worker gang, the
    victim elastic (2 to 2 workers), the preemptor fixed, no failure
    budget.  Writes what the fit gave to ``config["results"]``."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (ElasticScalingPolicy, FailurePolicy,
                                     FixedScalingPolicy, RunConfig,
                                     ScalingConfig, TorchTrainer,
                                     TrainControllerV2)

    rt.init(address="auto")
    worker = TENANT["worker"]
    trainer = TorchTrainer(
        tenant_loop, train_loop_config=config,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker=worker,
                                     placement_strategy="PACK"),
        run_config=RunConfig(name=role, storage_path=config["storage"]))
    policy = FixedScalingPolicy(2) if role == "hi" else \
        ElasticScalingPolicy(min_workers=2, max_workers=2,
                             resources_per_worker=worker)
    controller = TrainControllerV2(
        trainer, scaling_policy=policy,
        failure_policy=FailurePolicy(max_failures=0))
    out = {"error": None}
    try:
        result = controller.fit()
        out["error"] = repr(result.error) if result.error else None
        out["history"] = [dict(h["metrics"],
                               preempt_ckpt=bool(h.get("preempt_ckpt")))
                          for h in result.metrics_history]
    except Exception as e:  # noqa: BLE001 — the phase reads the file
        out["error"] = repr(e)
    out["announced"] = controller.announced_failures
    out["attempt_sizes"] = controller.attempt_sizes
    out["backoff_delays"] = controller.backoff_delays
    out["states"] = [s["state"] for s in controller.state_history]
    with open(config["results"], "w") as f:
        json.dump(out, f)
    rt.shutdown()
    return 1 if out["error"] else 0


def tenant_phase(card: str, env: dict, root: str, unsharded: dict) -> dict:
    """[tenant] Priority preemption of one GPT-2 trainer by another on
    the [fleet] head.  ``train-lo`` (priority 0) is submitted with ``rt
    job submit``; once it reports step 3, ``train-hi`` (priority 10),
    whose gang needs the card ``train-lo`` holds.  Holds: (1) ``rt jobs
    --format json`` shows ``train-lo`` preempting during its grace; (2)
    its notice checkpoint is saved within the grace; (3) when
    ``train-hi``'s rank 0 starts, no process of ``train-lo``'s gang is
    alive or maps libtorch; (4) ``train-hi`` SUCCEEDS, its 6 losses
    [main path]'s first 6 at 24/12/12 a step; (5) ``train-lo`` SUCCEEDS
    with an announced failure, a backoff and ``starts == [0, 3]``,
    resuming from its notice checkpoint; (6) its losses over both
    attempts are [main path]'s; (7) ``rt telemetry``'s ``per_job`` has
    compute for both jobs; (8) ``rt doctor`` exits 0.  Prints the
    timings with the card."""
    import os

    from ray_tpu_torch.core.config import RuntimeConfig

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    module = os.path.splitext(os.path.basename(__file__))[0]
    grace = RuntimeConfig.from_env().preemption_grace_s
    entry = os.path.join(root, "tenant_entry.py")
    with open(entry, "w") as f:
        f.write("import json, sys\n"
                f"sys.path.insert(0, {here!r})\n"
                f"import {module} as smoke\n"
                "sys.exit(smoke.tenant_job(sys.argv[1], "
                "json.loads(sys.argv[2])))\n")
    pids = os.path.join(root, "tenant_pids")
    configs = {}
    for role, steps in (("lo", TENANT["lo_steps"]),
                        ("hi", TENANT["hi_steps"])):
        configs[role] = {
            "steps": steps, "grace_s": grace,
            "storage": os.path.join(root, "tenant"),
            "pids": f"{pids}-{role}",
            "progress": os.path.join(root, f"tenant_{role}.progress"),
            "results": os.path.join(root, f"tenant_{role}.json")}
    configs["lo"].update(save_at=1, wait_at=TENANT["notice_step"])
    configs["hi"].update(watch=f"{pids}-lo-first")

    def submit(role: str) -> float:
        t = time.time()
        r = rt_cli(env, "job", "submit", "--id", f"train-{role}",
                   "--priority", str(TENANT[f"{role}_priority"]), "--",
                   sys.executable, entry, role,
                   shlex.quote(json.dumps(configs[role])))
        if r.returncode != 0:
            raise RuntimeError(f"[tenant] submit train-{role}: "
                               f"{r.stdout}{r.stderr}")
        return t

    def jobs() -> dict:
        r = rt_cli(env, "jobs", "--format", "json")
        return {j["job_id"]: j for j in json.loads(r.stdout or "[]")}

    def finished(job: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            state = jobs().get(job, {}).get("state")
            if state in ("SUCCEEDED", "FAILED", "STOPPED"):
                return state
            time.sleep(0.5)
        raise RuntimeError(f"[tenant] {job} did not finish in {timeout} s")

    def per_job() -> dict:
        r = rt_cli(env, "telemetry", "--format", "json")
        return {job: phases.get("compute", 0.0) for job, phases in
                (json.loads(r.stdout)["goodput"].get("per_job")
                 or {}).items()}

    out = {"grace_s": grace}
    t_lo = submit("lo")
    progress = configs["lo"]["progress"]
    while not (os.path.exists(progress) and json.load(open(progress))
               .get("step") == TENANT["notice_step"]):
        if time.time() - t_lo > 300 or jobs().get("train-lo", {}).get(
                "state") not in ("PENDING", "RUNNING"):
            raise RuntimeError("[tenant] train-lo never reached step 3: "
                               + rt_cli(env, "job", "logs",
                                        "train-lo").stdout[-3000:])
        time.sleep(0.2)
    t_hi = submit("hi")
    notice = None
    while notice is None:
        notice = jobs().get("train-lo", {}).get("preempting")
        if notice is None and time.time() - t_hi > 120:
            raise RuntimeError("[tenant] train-lo never showed preempting")
    print(f"  rt jobs: train-lo preempting, {notice['remaining_s']:.3f} s "
          f"of its {grace:.1f} s grace left, by {notice['by']!r} "
          f"({notice['reason']})")
    if notice["by"] != "train-hi":
        raise RuntimeError(f"[tenant] preempted by {notice['by']!r}")
    hi_state = finished("train-hi", 300)
    out["per_job_after_hi"] = per_job()
    lo_state = finished("train-lo", 300)
    out["per_job_after_lo"] = per_job()
    lo = json.load(open(configs["lo"]["results"]))
    hi = json.load(open(configs["hi"]["results"]))
    if hi_state != "SUCCEEDED" or lo_state != "SUCCEEDED" \
            or lo["error"] or hi["error"]:
        raise RuntimeError(
            f"[tenant] train-hi {hi_state} {hi['error']}, train-lo "
            f"{lo_state} {lo['error']}: "
            + rt_cli(env, "job", "logs", "train-lo").stdout[-3000:]
            + rt_cli(env, "job", "logs", "train-hi").stdout[-3000:])

    want = unsharded["losses"]
    steps = [h for h in lo["history"] if not h.get("notice")]
    notes = [h for h in lo["history"] if h.get("notice")]
    starts = sorted({h["start"] for h in lo["history"]})
    lo_losses = {h["step"]: h["loss"] for h in steps}
    hi_losses = [h["loss"] for h in hi["history"]]
    gaps = [abs(lo_losses[s] - want[s - 1]) for s in sorted(lo_losses)]
    hi_gaps = [abs(a - b) for a, b in zip(hi_losses, want)]
    print(f"  train-lo losses by step {lo_losses}; starts {starts}; "
          f"announced {lo['announced']}, backoff {lo['backoff_delays']}, "
          f"attempts {lo['attempt_sizes']}; states {lo['states']}")
    print(f"  train-hi losses {hi_losses}; [main path] {want[:6]}; largest"
          f" gap train-lo {max(gaps):.3e}, train-hi {max(hi_gaps):.3e} "
          f"(bit-equal expected)")
    for h in steps + hi["history"]:
        if h["launches"] != FLEET_LAUNCHES:
            raise RuntimeError(f"[tenant] step {h['step']} launches "
                               f"{h['launches']}")
    if len(notes) != 1 or not notes[0]["preempt_ckpt"]:
        raise RuntimeError(f"[tenant] notice reports {notes}")
    note = notes[0]
    if sorted(lo_losses) != list(range(1, TENANT["lo_steps"] + 1)) \
            or any(gaps) or len(hi_losses) != TENANT["hi_steps"] \
            or any(hi_gaps):
        raise RuntimeError("[tenant] losses differ from [main path]'s")
    if starts != [0, TENANT["notice_step"]] or lo["announced"] < 1 \
            or not lo["backoff_delays"] \
            or note["step"] != TENANT["notice_step"]:
        raise RuntimeError(f"[tenant] train-lo did not resume from its "
                           f"notice checkpoint: {lo}")
    issued = note["deadline"] - grace
    save_s = note["saved"] - note["noticed"]
    margin = note["deadline"] - note["saved"]
    gbps = note["bytes"] / save_s / 1e9
    print(f"  notice checkpoint: seen by rank 0 "
          f"{note['noticed'] - issued:.3f} s after the controller's "
          f"notice, {note['bytes'] / 1e9:.3f} GB saved in {save_s:.3f} s "
          f"({gbps:.3f} GB/s), {margin:.3f} s before the {grace:.1f} s "
          f"grace ended (card: {card})")
    if margin <= 0:
        raise RuntimeError("[tenant] the notice checkpoint outlasted the "
                           "grace")
    hi_first = hi["history"][0]
    print(f"  train-hi's rank 0 starts: train-lo's gang pids "
          f"{hi_first['watched']}, alive {hi_first['alive']}, holding "
          f"libtorch {hi_first['still_holding']}; card free "
          f"{hi_first['card_free_gb']:.3f} of "
          f"{hi_first['card_total_gb']:.3f} GB")
    if len(hi_first["watched"]) != 2 or hi_first["alive"] \
            or hi_first["still_holding"]:
        raise RuntimeError("[tenant] train-lo's gang outlived its grace")
    resumed = [h for h in steps if h["start"] == TENANT["notice_step"]]
    lo_first = steps[0]
    out.update(
        lo_submit_to_first_step_s=lo_first["t"] - t_lo,
        hi_submit_to_first_step_s=hi_first["t"] - t_hi,
        notice_to_seen_s=note["noticed"] - issued,
        notice_to_saved_s=note["saved"] - issued, notice_save_s=save_s,
        notice_save_gb_s=gbps,
        notice_bytes=note["bytes"], notice_margin_s=margin,
        card_free_to_hi_first_step_s=hi_first["t"] - note["deadline"],
        hi_start_card_free_gb=hi_first["card_free_gb"],
        lo_restart_to_resumed_step_s=resumed[0]["t"] - note["deadline"],
        lo_restore_s=resumed[0]["restore_s"],
        loss_gap_lo=max(gaps), loss_gap_hi=max(hi_gaps))
    print(f"  submit to first step: train-lo "
          f"{out['lo_submit_to_first_step_s']:.3f} s, train-hi "
          f"{out['hi_submit_to_first_step_s']:.3f} s; grace end (card "
          f"free) to train-hi's first step "
          f"{out['card_free_to_hi_first_step_s']:.3f} s; to train-lo's "
          f"resumed step {out['lo_restart_to_resumed_step_s']:.3f} s "
          f"(restore {out['lo_restore_s']:.3f} s) (host clock; card: "
          f"{card})")
    print(f"  rt telemetry per_job compute s: after train-hi "
          f"{out['per_job_after_hi']}, after train-lo "
          f"{out['per_job_after_lo']}")
    if not out["per_job_after_hi"].get("train-hi", 0) > 0 \
            or not out["per_job_after_lo"].get("train-lo", 0) > 0:
        raise RuntimeError("[tenant] per-job goodput misses a job")
    deadline = time.monotonic() + 60
    while True:
        doctor = rt_cli(env, "doctor", "--format", "json")
        if doctor.returncode == 0 or time.monotonic() > deadline:
            break
        time.sleep(1.0)
    critical = [f["check"] for f in json.loads(doctor.stdout or "{}")
                .get("findings", []) if f["severity"] == "critical"]
    print(f"  rt doctor: exit {doctor.returncode}, critical {critical}")
    if doctor.returncode != 0 or critical:
        raise RuntimeError(f"[tenant] rt doctor: {doctor.stdout}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  [tenant] {out['wall_s']:.3f} s (card: {card})")
    return out


def fleet_client(card: str, env: dict, client_addr: str, unsharded: dict,
                 out: dict) -> None:
    """(2) a driver in a process that sees no GPU, through rt://."""
    import hashlib
    import os

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    module = os.path.splitext(os.path.basename(__file__))[0]
    code = (
        "import hashlib, json, sys, time\n"
        f"sys.path.insert(0, {here!r})\n"
        f"import {module} as smoke\n"
        "import torch\n"
        "import ray_tpu_torch as rt\n"
        "t0 = time.perf_counter()\n"
        f"rt.init(address={client_addr!r})\n"
        "out = {'connect_s': time.perf_counter() - t0,\n"
        "       'cuda_here': torch.cuda.is_available()}\n"
        "t0 = time.perf_counter()\n"
        "out['step'], host = rt.get(rt.remote(num_gpus=1)(\n"
        "    smoke.fleet_step_and_bf16).remote(), timeout=600)\n"
        "out['task_s'] = time.perf_counter() - t0\n"
        "t0 = time.perf_counter()\n"
        "ref = rt.put(host)\n"
        "out['put_s'] = time.perf_counter() - t0\n"
        "t0 = time.perf_counter()\n"
        "back = rt.get(ref, timeout=600)\n"
        "out['get_s'] = time.perf_counter() - t0\n"
        "out['bytes'] = host.numel() * host.element_size()\n"
        "out['equal'] = torch.equal(back.view(torch.int16),\n"
        "                           host.view(torch.int16))\n"
        "out['dtype'] = str(back.dtype)\n"
        "out['sha256'] = hashlib.sha256(host.view(torch.int16).numpy()"
        ".tobytes()).hexdigest()\n"
        "rt.shutdown()\n"
        "print('FLEET_CLIENT ' + json.dumps(out), flush=True)\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900,
                       env=dict(env, CUDA_VISIBLE_DEVICES=""))
    wall = time.perf_counter() - t0
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("FLEET_CLIENT ")]
    if r.returncode != 0 or not line:
        raise RuntimeError(f"[fleet] rt:// driver: {r.stdout}{r.stderr}")
    got = json.loads(line[0][len("FLEET_CLIENT "):])
    check_step(got["step"], unsharded, "rt:// driver's num_gpus=1 task")
    want = hashlib.sha256(seeded_bf16(11).cpu().view(torch.int16).numpy()
                          .tobytes()).hexdigest()
    put_gb_s = got["bytes"] / got["put_s"] / 1e9
    get_gb_s = got["bytes"] / got["get_s"] / 1e9
    print(f"  rt:// driver (CUDA_VISIBLE_DEVICES='', CUDA available there: "
          f"{got['cuda_here']}): connect {got['connect_s']:.3f} s, the "
          f"task's round trip {got['task_s']:.3f} s (worker and CUDA start, "
          f"the step, the tensor back through the relay), bf16 tensor {got['bytes'] / 1e6:.1f} MB "
          f"({got['dtype']}) equal to [runtime]'s: "
          f"{got['sha256'] == want}, put {put_gb_s:.3f} GB/s, get "
          f"{get_gb_s:.3f} GB/s through the relay, back bit-equal: "
          f"{got['equal']}; the process {wall:.3f} s (host clock; card: "
          f"{card})")
    if got["cuda_here"] or not got["equal"] or got["sha256"] != want:
        raise RuntimeError(f"[fleet] rt:// tensor: {got}")
    out["client"] = {"connect_s": got["connect_s"],
                     "task_s": got["task_s"], "put_gb_s": put_gb_s,
                     "get_gb_s": get_gb_s}


def fleet_dashboard(card: str, env: dict, address: str, pids: list,
                    out: dict) -> None:
    """(3) the dashboard over the head: every route, its JSON shape,
    the GPU, the four jobs' terminal states, the rt_ series."""
    from ray_tpu_torch.util import state as rt_state

    workers = []
    for n in rt_state.list_nodes(address=address):
        listed = rt_state._agent_call(n["agent_addr"], "list_workers")
        workers += [w["pid"] for w in listed["workers"]
                    if w.get("pid") and alive(w["pid"])]
    pids += workers
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "dashboard", "--address",
         address, "--port", str(port)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                if http_get(port, "/")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline or proc.poll() is not None:
                raise RuntimeError("[fleet] the dashboard never answered")
            time.sleep(0.1)
        ms, bodies = [], {}
        for route, shape in DASHBOARD_ROUTES.items():
            path = route.format(pid=workers[0])
            t0 = time.perf_counter()
            code, body = http_get(port, path)
            ms.append(1e3 * (time.perf_counter() - t0))
            bodies[route] = body
            if code != 200:
                raise RuntimeError(f"[fleet] dashboard {path}: {code} "
                                   f"{body[:300]!r}")
            if shape is not None:
                data = json.loads(body)
                ok = isinstance(data, list) if shape == "list" \
                    else isinstance(data, dict) and shape <= set(data)
                if not ok:
                    raise RuntimeError(f"[fleet] dashboard {path}: shape "
                                       f"{str(data)[:300]}")
        if http_get(port, "/api/nope")[0] != 404:
            raise RuntimeError("[fleet] dashboard: no 404")
        torch_mapped = maps_libtorch(proc.pid)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    nodes = json.loads(bodies["/api/nodes"])
    jobs = {j["job_id"]: j["state"]
            for j in json.loads(bodies["/api/jobs"])["jobs"]}
    metrics = bodies["/metrics"].decode()
    series = sorted({ln.split("{")[0].split(" ")[0]
                     for ln in metrics.splitlines()
                     if ln.startswith("rt_")})
    out["dashboard_ms"] = median(ms)
    print(f"  dashboard: {len(DASHBOARD_ROUTES)} routes answer 200 with "
          f"JAX's shape, median {out['dashboard_ms']:.3f} ms a request, "
          f"max {max(ms):.3f} ms (host clock; card: {card}); "
          f"nodes GPU {[n['resources'].get('GPU') for n in nodes]}, jobs "
          f"{jobs}, {len(series)} rt_ series in /metrics; libtorch mapped "
          f"in the dashboard process: {torch_mapped}")
    if [n["resources"].get("GPU") for n in nodes] != [1.0] \
            or jobs != {"fleet-step": "SUCCEEDED",
                        "fleet-sleep": "STOPPED", "train-lo": "SUCCEEDED",
                        "train-hi": "SUCCEEDED"} \
            or not series or torch_mapped:
        raise RuntimeError(f"[fleet] dashboard: {nodes} {jobs} {series}")


def fleet_autoscaler(card: str, unsharded: dict, out: dict) -> None:
    """(4) the autoscaler launches a GPU node for a pending step and
    reaps it once idle."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import AutoscalingCluster, NodeType

    c = AutoscalingCluster(
        node_types=[NodeType("gpu", {"CPU": 2, "GPU": 1}, max_workers=1)],
        head_resources={"CPU": 1, "GPU": 0}, idle_timeout_s=FLEET_IDLE_S)
    pids = [p.pid for p in c._procs]
    try:
        rt.init(address=c.address)
        try:
            head_gpu = rt.cluster_resources().get("GPU", 0.0)
            t0 = time.time()
            ref = rt.remote(num_gpus=1)(fleet_step).remote()
            got = rt.get(ref, timeout=600)
            done = time.time()
            launched = list(c.provider.non_terminated_nodes())
            pids += [c.provider._nodes[p][0].pid for p in launched]
        finally:
            rt.shutdown()
        check_step(got, unsharded, "autoscaled node's num_gpus=1 task")
        pending_s = got["started"] - t0
        while c.provider.non_terminated_nodes():
            if time.time() - done > 120:
                raise RuntimeError("[fleet] the idle node was not reaped")
            time.sleep(0.2)
        reaped_s = time.time() - got["ended"]
    finally:
        c.shutdown()
    decisions = [(d["launched"], d["terminated"])
                 for d in c.autoscaler.decisions]
    out["autoscaler"] = {"pending_to_running_s": pending_s,
                         "idle_to_reaped_s": reaped_s}
    print(f"  autoscaler: head GPU {head_gpu}, launched {launched}; "
          f"pending to running {pending_s:.3f} s (agent start, worker "
          f"and CUDA start), idle to reaped {reaped_s:.3f} s (idle "
          f"timeout {FLEET_IDLE_S} s); decisions {decisions} (host clock; "
          f"card: {card})")
    if head_gpu or len(launched) != 1 or got["visible"] != "0":
        raise RuntimeError(f"[fleet] autoscaler: {head_gpu} {launched} "
                           f"{got['visible']}")
    deadline = time.monotonic() + 30
    while [p for p in pids if alive(p)] and time.monotonic() < deadline:
        time.sleep(0.2)
    if [p for p in pids if alive(p)]:
        raise RuntimeError(f"[fleet] autoscaler left "
                           f"{[p for p in pids if alive(p)]}")
    os.environ.pop("RT_AUTOSCALING_ENABLED", None)


def fleet_up(card: str, env: dict, root: str, unsharded: dict,
             out: dict) -> None:
    """(5) rt up / rt exec / rt down with the subprocess provider."""
    import os

    import ray_tpu_torch as rt

    spec = {
        "cluster_name": "fleet",
        "provider": {"type": "subprocess", "head_port": 0},
        "head_node_type": "head",
        "available_node_types": {
            "head": {"resources": {"CPU": 1, "GPU": 0}},
            "gpu": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 1,
                    "max_workers": 1}},
        "head_start_command": f"{sys.executable} -m ray_tpu_torch."
                              "scripts.cli start --head --port {port} "
                              "--resources {resources}",
        "worker_start_command": f"{sys.executable} -m ray_tpu_torch."
                                "scripts.cli start --address {address} "
                                "--resources {resources}",
        "env": {"PYTHONPATH": env["PYTHONPATH"]}}
    path = os.path.join(root, "fleet.yaml")
    with open(path, "w") as f:
        json.dump(spec, f)     # JSON is YAML
    t0 = time.perf_counter()
    r = rt_cli(env, "up", path, timeout=300)
    up_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"[fleet] rt up: {r.stdout}{r.stderr}")
    trailer = dict(ln.split("=", 1) for ln in r.stdout.splitlines()
                   if ln.startswith("RT_"))
    address = trailer["RT_ADDRESS"]
    session = [ln.split(":", 1)[1].strip() for ln in r.stdout.splitlines()
               if ln.strip().startswith("session:")][0]
    try:
        ex = rt_cli(env, "exec", path, "--all-nodes",
                    f"{sys.executable} -c 'import torch; print(\"DEVICES\", "
                    "torch.cuda.device_count())'", timeout=300)
        devices = [ln for ln in ex.stdout.splitlines()
                   if ln.startswith("DEVICES")]
        rt.init(address=address)
        try:
            gpus = sorted(n["Resources"].get("GPU", 0.0)
                          for n in rt.nodes() if n["Alive"])
            got = rt.get(rt.remote(num_gpus=1)(fleet_step).remote(),
                         timeout=600)
        finally:
            rt.shutdown()
    finally:
        t0 = time.perf_counter()
        down = rt_cli(env, "down", path, timeout=300)
        down_s = time.perf_counter() - t0
    print(f"  rt up {up_s:.3f} s: {r.stdout.splitlines()[0]}; nodes GPU "
          f"{gpus}; rt exec --all-nodes: {devices}; rt down "
          f"{down_s:.3f} s: {down.stdout.strip()} (host clock; card: "
          f"{card})")
    if ex.returncode != 0 or devices[-1:] != ["DEVICES 1"] \
            or gpus != [0.0, 1.0]:
        raise RuntimeError(f"[fleet] rt up cluster: {gpus} {ex.stdout}")
    check_step(got, unsharded, "rt up worker's num_gpus=1 task")
    deadline = time.monotonic() + 30
    while session_pids(session) and time.monotonic() < deadline:
        time.sleep(0.2)
    if down.returncode != 0 or session_pids(session):
        raise RuntimeError(f"[fleet] rt down left {session_pids(session)}")
    out["up"] = {"up_s": up_s, "down_s": down_s}


def fleet_benchmarks(card: str, root: str, out: dict) -> None:
    """(6) the control-plane benchmarks on a fresh cluster, recorded
    into a ledger of their own; a planted half-rate row shows the
    regression gate fires."""
    import os
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import microbenchmark, perf_ledger, scale_bench

    ledger = os.path.join(root, "ledger.jsonl")
    rt.init(mode="cluster", num_cpus=2)
    try:
        micro = microbenchmark.run(quick=True)
        scale = scale_bench.run(quick=True)
    finally:
        rt.shutdown()
    perf_ledger.record([{"benchmark": r["benchmark"], "value": r["per_sec"],
                         "unit": "ops/s"} for r in micro],
                       source="micro_quick", path=ledger)
    perf_ledger.record(scale, source="scale", path=ledger)
    problems = perf_ledger.check_regressions(ledger)
    rows = perf_ledger.load(ledger)
    for r in rows:
        print(f"  {r['source']}/{r['benchmark']}: {r['value']} {r['unit']}")
    print(f"  ledger {len(rows)} rows, floors {perf_ledger.FLOORS}, "
          f"regressions {problems} (host clock; card: {card})")
    if problems or perf_ledger.FLOORS or len(micro) != 6 or not scale:
        raise RuntimeError(f"[fleet] benchmarks: {problems}")
    # With one record a metric and no floor the gate above judges
    # nothing; a copy of the ledger with the first row recorded again at
    # half its rate must be flagged, and only that row.
    planted = os.path.join(root, "planted.jsonl")
    shutil.copyfile(ledger, planted)
    slow = rows[0]
    perf_ledger.record([{"benchmark": slow["benchmark"],
                         "value": slow["value"] / 2, "unit": slow["unit"]}],
                       source=slow["source"], path=planted)
    fired = perf_ledger.check_regressions(planted)
    print(f"  planted half-rate {slow['source']}/{slow['benchmark']}: "
          f"{fired}")
    if len(fired) != 1 or slow["benchmark"] not in fired[0]:
        raise RuntimeError(f"[fleet] the regression gate missed a planted "
                           f"half-rate row: {fired}")
    out["benchmarks"] = {f"{r['source']}/{r['benchmark']}": r["value"]
                         for r in rows}


def fleet_phase(card: str, unsharded: dict, clock=None) -> dict:
    """[fleet] The operator's fleet tools, each driving the main path's
    step on the card: (1) ``rt start --head --client-server-port`` (the
    head detects ``GPU: 1``); ``rt job submit --wait`` of an entrypoint
    that calls ``init(address="auto")`` and takes one [main path] step
    in a ``num_gpus=1`` actor (the entrypoint itself sees no GPU: the
    supervisor's lease holds none); ``rt job logs`` and ``rt logs --job``
    show the same lines; a second job stopped by ``rt job stop`` reaches
    STOPPED with its process group gone; ``rt job list`` shows both;
    then ``[tenant]`` on the same head (``tenant_phase``, timed under its
    own label in ``clock``).
    (2) a driver in a process with ``CUDA_VISIBLE_DEVICES=""`` connects
    with ``init(address="rt://...")``, takes the step in a ``num_gpus=1``
    task and moves [runtime]'s bf16 tensor through the relay bit for
    bit.  (3) ``python -m ray_tpu_torch dashboard``: every route answers
    200 with the JAX package's shape, ``/api/nodes`` shows the GPU,
    ``/api/jobs`` both jobs' terminal states, ``/metrics`` rt_ series;
    no libtorch in the dashboard or the client server; ``rt stop``
    leaves no process.  (4) ``AutoscalingCluster`` with a CPU head
    launches a ``{"CPU": 2, "GPU": 1}`` node for a pending step and
    reaps it after its idle timeout.  (5) ``rt up`` / ``rt exec
    --all-nodes`` / ``rt down`` with ``provider.type: subprocess``: a
    CPU head and one GPU worker take the step, and nothing is left.
    (6) the quick microbenchmark and scale-bench rows on a fresh
    cluster, recorded into a ledger of their own, with no regression
    and no floor.  Every step's loss equals [main path]'s first loss bit
    for bit at 24/12/12 launches.  Every gate raises."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt

    out = {}
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="rt_fleet_")
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        rt.__file__)))
    env = dict(os.environ, RT_SESSION_DIR_ROOT=root,
               PYTHONPATH=os.pathsep.join(
                   [checkout] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    env.pop("RT_ADDRESS", None)
    saved = os.environ.get("RT_SESSION_DIR_ROOT")
    os.environ["RT_SESSION_DIR_ROOT"] = root
    pids, session, stopped = [], None, False
    try:
        # (1) the head with its rt:// listener, then the jobs.
        r = rt_cli(env, "start", "--head", "--port", "0",
                   "--client-server-port", str(free_port()))
        if r.returncode != 0:
            raise RuntimeError(f"[fleet] rt start: {r.stderr}{r.stdout}")
        trailer = dict(ln.split("=", 1) for ln in r.stdout.splitlines()
                       if ln.startswith("RT_"))
        pids = [int(p) for p in trailer["RT_PIDS"].split(",")]
        session, address = trailer["RT_SESSION"], trailer["RT_ADDRESS"]
        client_addr = [ln.split('"')[1] for ln in r.stdout.splitlines()
                       if 'address="rt://' in ln][0]
        status = rt_cli(env, "status").stdout
        print(f"  rt start --head --client-server-port: {address}, "
              f"{client_addr}; GPU=1 in rt status: {'GPU=1' in status}")
        if "GPU=1" not in status or len(pids) != 3:
            raise RuntimeError(f"[fleet] head: {status} {pids}")
        fleet_jobs(card, env, root, unsharded, out)
        # [tenant] on the same head, under its own label in ``clock``.
        if clock is not None:
            clock.start("[tenant] priority preemption on the [fleet] head:"
                        " two GPT-2 124M trainers submitted as jobs, "
                        "train-hi (priority 10) preempts train-lo")
        out["tenant"] = tenant_phase(card, env, root, unsharded)
        if clock is not None:
            clock.start("[fleet] continues: the rt:// driver, the "
                        "dashboard, the autoscaler, rt up, the benchmarks")
        # (2) the rt:// driver; (3) the dashboard; then stop the head.
        fleet_client(card, env, client_addr, unsharded, out)
        client_server_torch = maps_libtorch(pids[2])
        print(f"  libtorch mapped in the client server: "
              f"{client_server_torch}")
        if client_server_torch:
            raise RuntimeError("[fleet] the client server loaded torch")
        fleet_dashboard(card, env, address, pids, out)
        stop = rt_cli(env, "stop")
        stopped = True
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                [p for p in pids if alive(p)] or session_pids(session)):
            time.sleep(0.2)
        left = [p for p in pids if alive(p)] + session_pids(session)
        print(f"  rt stop: {stop.stdout.strip()}; session processes left "
              f"{left}")
        if stop.returncode != 0 or left:
            raise RuntimeError(f"[fleet] rt stop left {left}")
        # (4) the autoscaler; (5) rt up; (6) the benchmarks.
        fleet_autoscaler(card, unsharded, out)
        fleet_up(card, env, root, unsharded, out)
        fleet_benchmarks(card, root, out)
    finally:
        if not stopped and session is not None:
            rt_cli(env, "stop")
        if saved is None:
            os.environ.pop("RT_SESSION_DIR_ROOT", None)
        else:
            os.environ["RT_SESSION_DIR_ROOT"] = saved
        os.environ.pop("RT_AUTOSCALING_ENABLED", None)
    shutil.rmtree(root, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  [fleet] {out['wall_s']:.3f} s, [tenant]'s "
          f"{out['tenant']['wall_s']:.3f} s included (card: {card})")
    return out


def alive(pid: int) -> bool:
    """A process that exists and is no zombie."""
    import os

    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except (ProcessLookupError, OSError):
        return False


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


class PhaseClock:
    """Each phase's wall time.  ``start`` prints a phase's header and
    closes the phase before it; the start also goes to stderr, with the
    seconds since the first phase, so that a run stopped at its time
    limit shows in its stderr where it was."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()
        self.name = None
        self.walls = {}

    def start(self, header: str) -> None:
        self.stop()
        self.name = header[:header.index("]") + 1]
        if self.name == "[serve]":
            self.name = header
        print(header, flush=True)
        print(f"chip_smoke: {self.name} starts at "
              f"{self.last - self.t0:.1f} s", file=sys.stderr, flush=True)

    def stop(self) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.walls[self.name] = self.walls.get(self.name, 0.0) \
                + now - self.last
        self.name, self.last = None, now


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

    clock = PhaseClock()
    clock.start("[build]")
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

    clock.start("[kernels] small cases: partial 128-row tiles (T = 64, 320), "
                "B*H = 6, and a non-causal T = 256")
    for t, causal in ((64, True), (64, False), (320, True), (320, False)):
        check_kernels(2, t, 3, 64, causal=causal, seed=3, timed=False)
    check_kernels(2, 256, 4, 64, causal=False, seed=1, timed=False)
    clock.start("[kernels] B*H = 144 (more items per q block than the 132 "
                "SMs: several persistent rounds), T = 320 (last item half "
                "past T)")
    check_kernels(12, 320, 12, 64, causal=True, seed=4, timed=False)
    clock.start("[kernels] main-path shape B16 T1024 H12 D64 bf16 causal")
    results = check_kernels(16, 1024, 12, 64, causal=True, seed=2,
                            timed=True)

    clock.start("[kernels] lse cotangent: flash_attention_with_lse with "
                "random dO and dlse, B16 T1024 H12 D64 bf16")
    for causal in (True, False):
        check_lse_cotangent(16, 1024, 12, 64, causal=causal, seed=6)

    profile = "--profile" in sys.argv[1:]
    clock.start("[main path] GPT-2 124M, B16 T1024, flash + remat, chunk 256")
    counts, unsharded = main_path(card, profile=profile)
    free_device_memory()

    clock.start("[telemetry] the main path through "
                "make_sharded_train_step(telemetry=True), "
                "TrainSession.iter_device_batches and session.report: "
                "goodput, the xprof harvest, the decomposition")
    telemetry = telemetry_phase(card, unsharded)
    free_device_memory()

    clock.start("[sharded] GPT-2 124M, B16 T1024, world-1 NCCL gang, DTensor "
                "state, ring attention, full-logits loss")
    with world1_gang() as (mesh, group_name):
        _counts, sharded = sharded_path(card, unsharded, mesh,
                                        profile=profile)
        nccl_telemetry(group_name, card)
        clock.start("[checkpoint] the [sharded] state: save_sharded, "
                    "load_sharded onto the mesh and on the host, one more "
                    "step from each")
        checkpoint_phase(card, sharded)
        del sharded
    free_device_memory()

    clock.start("[moe] GPT-2 124M widths, 8 experts (d_ff 3072) in every "
                "other block, top-2, capacity 1.25, bf16, flash + remat, B16 "
                "T1024")
    moe_phase(card, unsharded, profile=profile)
    free_device_memory()

    clock.start("[ring] ring (flash) and Ulysses attention, seq = 2 and 4 "
                "processes on one card, gloo, B4 T4096 H12 D64 bf16 causal")
    ring_phase(card)
    free_device_memory()

    clock.start("[pipeline] GPipe over S = 2 and 4 processes on one card, "
                "gloo: GPT-2 124M blocks, B16 T1024 hidden states, M = 8, "
                "bf16 flash")
    pipeline_phase(card)
    free_device_memory()

    clock.start("[runtime] the port's runtime: GPU detection and leases, "
                "CUDA_VISIBLE_DEVICES, a CUDA tensor through the object "
                "plane, a torch.profiler capture of an actor")
    runtime = runtime_phase(card)
    clock.start("[trainer] TorchTrainer: the [main path] configuration in a "
                "GPU worker, a world-2 gloo gang, a restart from a checkpoint")
    runtime.update(trainer_phase(card, unsharded))
    free_device_memory()

    clock.start("[data] GPT-2 124M fed from a ray_tpu_torch.data Dataset of 8"
                " block tasks: unpipelined against prefetch_blocks=2 + "
                "iter_device_batches(depth=2)")
    data, data_losses, ds = data_phase(card)
    clock.start("[trainer data] TorchTrainer(datasets={'train': ds}): the "
                "worker trains on get_dataset_shard('train')")
    data["trainer"] = trainer_data_phase(card, ds, data_losses[:6])
    free_device_memory()
    clock.start("[tune] Tuner over a TorchTrainer at 2 layers: grid of 4 "
                "rates, ASHA, four trials at once sharing the card")
    data["tune"] = tune_phase(card, ds)
    free_device_memory()
    clock.start("[rl] the RL learners on the card against the CPU, two IMPALA"
                " learners sharing the card over gloo, multi-agent PPO, PPO "
                "on CartPole-v1 where gymnasium is installed")
    rl = rl_phase(card)
    clock.start("[entry] ray_tpu_torch.entry.entry(): GPT-2 vocab 8192, 4 "
                "layers, d_model 512, bf16, tokens [2, 128]")
    rl["entry"] = entry_phase(card)
    free_device_memory()

    clock.start("[cluster] the operator's path: rt start --head, "
                "init(address='auto'), GPT-2 124M parameters through the pool"
                " into a GPU actor, pip/uv envs on the card, a compiled DAG, "
                "rt doctor, rt stop")
    cluster = cluster_phase(card, unsharded)
    free_device_memory()

    clock.start("[fleet] the fleet tools: rt job submit/stop/logs, an rt:// "
                "driver, the dashboard, the autoscaler, rt up/exec/down, the "
                "control-plane benchmarks, each step on the card")
    fleet = fleet_phase(card, unsharded, clock)
    free_device_memory()

    serving = []
    for name, phase in (("GPT-2 124M", serve_gpt2),
                        ("GPT-2 124M float32", serve_gpt2_float32),
                        ("Llama-2-7B widths", serve_llama)):
        clock.start(f"[serve] {name}")
        serving.append({"phase": name, **phase(card)})
        free_device_memory()

    clock.start("[serve plane] GPT-2 124M bf16 through "
                "serve.run(llm_deployment(num_gpus=1)): the handle, the "
                "stdlib HTTP ingress, the cluster read back, two replicas on "
                "one card")
    plane = serve_plane(card, serving[0])
    free_device_memory()

    clock.stop()
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name])
               for name in ("flash_fwd", "flash_dkv", "flash_dq")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"runtime": runtime}))
    print(json.dumps({"data": data}))
    print(json.dumps({"serve_plane": plane}))
    print(json.dumps({"rl": rl}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"tenant": fleet.pop("tenant")}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"phase_walls": clock.walls,
                      "total_s": time.perf_counter() - clock.t0}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
