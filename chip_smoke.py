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
kernels.  Any failure exits non-zero; with
no CUDA device it exits 1 before doing anything.

Output, last lines: the card's name and power limit (``nvidia-smi``),
one JSON line ``{"kernels": [...]}`` with each kernel's launches on the
main path, error against its plain version, times and bound, and last
``{"ok": true, "device": {...}}``.  ``--profile`` adds a device-time
breakdown of two more steps (see ``profile_steps``).
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

# H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

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
    over the HBM rate.  Returns (ms, "operations" | "bytes")."""
    pairs = t * (t + 1) // 2 if causal else t * t    # visible (q, k) pairs
    tile = bh * t * d * 2                            # one bf16 [BH, T, D]
    rows = bh * t * 4                                # one fp32 [BH, T]
    flops, nbytes = {
        "flash_fwd": (4 * d * pairs * bh, 4 * tile + rows),
        "flash_dkv": (8 * d * pairs * bh, 6 * tile + 2 * rows),
        "flash_dq": (6 * d * pairs * bh, 5 * tile + 2 * rows),
    }[kernel]
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


def profile_steps(step, state, data, n: int = 2) -> None:
    """--profile: device time by kernel over ``n`` more steps, from
    ``torch.profiler``, grouped into the attention kernels, matrix
    products, the optimizer's multi-tensor kernels and the rest, and the
    device's busy share of the window (host clock)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, data)
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
        print("  profile: the profiler traced no device time")
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    groups = {"flash attention kernels": ("fwd_kernel", "dkv_kernel",
                                          "dq_kernel"),
              "matrix products (cuBLAS)": ("gemm", "xmma", "nvjet",
                                           "cutlass", "cublas"),
              "optimizer (multi-tensor)": ("multi_tensor_apply",)}
    sums = {g: 0.0 for g in list(groups) + ["elementwise, reductions, "
                                             "copies"]}
    for name, (us, _count) in by_name.items():
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)),
                     "elementwise, reductions, copies")
        sums[group] += us
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

    cfg = GPT2Config(n_layer=12, n_head=12, d_model=768, d_ff=3072,
                     vocab_size=50257, max_seq=1024, remat=True,
                     attn_impl="flash")
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
    if profile:
        profile_steps(step, state, data)
    return counts


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

    print("[main path] GPT-2 124M, B16 T1024, flash + remat, chunk 256")
    counts = main_path(card, profile="--profile" in sys.argv[1:])

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    **results[name])
               for name in ("flash_fwd", "flash_dkv", "flash_dq")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
