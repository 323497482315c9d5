"""Multi-process dry run of the sharded training step: counterpart of
``__graft_entry__.dryrun_multichip``.

``dryrun_multichip(n)`` runs one sharded GPT-2 training step over an
n-rank mesh, DP x FSDP x TP x SP with ring attention on the ``seq`` axis,
at tiny shapes.  The JAX package runs it on n virtual CPU devices in
one process; here each rank is a process (``spawn``) in a gloo group on
the CPU, since a DeviceMesh maps one device to one process.  The
meshes are the JAX dry run's: ``{8: data2 x seq2 x tensor2, 4: data2 x
seq2, 2: data2, 1: ()}``, and at 8 ranks the ``dcn2 x data2 x tensor2``
variant and the expert-parallel ``data2 x expert2 x tensor2`` variant
(GPT-2 with an MoE block of 4 experts in every other layer).

``spawn(fn, world, *args)`` is the launcher: fresh interpreters (the
``spawn`` start method), a ``file://`` rendezvous in a directory of the
caller's, a join timeout that kills every child on overrun, and each
rank's return value (numpy or plain Python) sent back to the parent.
The CPU tests start their ranks through it, so the children import
only this package.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


def _child(fn, rank: int, world: int, rendezvous: str, args, results):
    import torch

    # Ranks share the host's cores; one thread each keeps them from
    # oversubscribing it.
    torch.set_num_threads(1)
    try:
        results.put((rank, True, fn(rank, world, rendezvous, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, *args, timeout: float = 120.0,
          workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world, rendezvous, *args)`` in ``world`` fresh
    processes and return their results in rank order.  ``rendezvous``
    is a directory (``workdir`` or a temporary one) where ``fn`` makes
    its ``file://`` stores, e.g. ``join(rank, world, rendezvous)``.
    Raises the first failure with its traceback, or TimeoutError after
    ``timeout`` seconds; either way no child outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=workdir) as rendezvous:
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, r, world, rendezvous, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{fn.__name__}: ranks {sorted(set(range(world)) - set(got))} "
                        f"did not finish within {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(f"{fn.__name__}: ranks {dead} "
                                           "exited without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"{fn.__name__} failed on rank "
                                       f"{rank}:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


def join(rank: int, world: int, rendezvous: str, *, backend: str = "cpu",
         group_name: str = "gang", store: str = "gang"):
    """Join the collective group ``group_name`` through the file store
    ``rendezvous/store``; returns the group."""
    from . import collective as col

    return col.init_collective_group(
        world, rank, backend=backend, group_name=group_name,
        init_method="file://" + os.path.join(rendezvous, store))


# ------------------------------------------------------------- dry run
DRYRUN_SPECS = {8: dict(data=2, seq=2, tensor=2), 4: dict(data=2, seq=2),
                2: dict(data=2), 1: {}}


def sharded_steps(model_cfg, init_params, mesh_axes: dict, batches,
                  *, model: str = "gpt2", device=None,
                  optimizer_kw: Optional[dict] = None, loss_kw=None):
    """Train ``len(batches)`` sharded steps in this rank's process (its
    gang joined) on ``device`` (default CUDA, or a raise): the mesh
    ``MeshSpec(**mesh_axes)``, the model from
    ``init_params`` (a flax-layout numpy tree, or None for the seed-0
    init), the state placed by the model's logical parameter axes.
    Returns (per-step metrics as floats, the final parameters as a
    flax-layout numpy tree)."""
    import dataclasses

    import numpy as np
    import torch

    from .device import resolve_device
    from .models import convert, gpt2, llama
    from .parallel.mesh import MeshSpec, create_mesh
    from .parallel.sharding import (ShardingRules, distribute,
                                    logical_sharding)
    from .train import distributed, train_step

    device = resolve_device(device)
    mesh = create_mesh(MeshSpec(**mesh_axes), device=device)
    rules = ShardingRules()
    cfg = dataclasses.replace(model_cfg, mesh=mesh, rules=rules)
    family = {"gpt2": (gpt2.GPT2, gpt2.gpt2_init, gpt2.gpt2_loss_fn,
                       gpt2.gpt2_param_axes),
              "llama": (llama.Llama, llama.llama_init, llama.llama_loss_fn,
                        llama.llama_param_axes)}[model]
    cls, init, loss_fn, axes_fn = family
    if init_params is None:
        net = init(cfg, torch.Generator(device=device).manual_seed(0),
                   device=device)
    else:
        net = cls(cfg, device=device)
        net.load_state_dict(convert.gpt2_params_from_numpy(init_params))
    opt = train_step.make_optimizer(**(optimizer_kw or {}))
    state = train_step.shard_state(train_step.TrainState.create(net, opt),
                                   mesh, axes_fn, rules)
    step = train_step.make_sharded_train_step(
        lambda m, b: loss_fn(cfg, m, b, **(loss_kw or {})), opt, mesh)
    tokens_sharding = logical_sharding(mesh, ("batch", None), rules)
    metrics = []
    for toks in batches:
        batch = {"tokens": distribute(
            torch.as_tensor(np.asarray(toks), device=device),
            tokens_sharding)}
        state, m = step(state, batch)
        metrics.append(distributed.metrics_to_host(m))
    return metrics, convert.gpt2_params_to_numpy(dict(net.named_parameters()))


def _dryrun_rank(rank: int, world: int, rendezvous: str):
    import dataclasses

    import numpy as np

    from . import collective as col
    from .models.gpt2 import GPT2Config

    join(rank, world, rendezvous)
    out = []
    try:
        axes = DRYRUN_SPECS.get(world, dict(data=-1, seq=2, tensor=2))
        cfg = GPT2Config(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                         d_ff=256, max_seq=64, remat=True,
                         attn_impl="ring" if axes.get("seq", 1) > 1
                         else "dense")
        opt = dict(total_steps=10, warmup_steps=2)
        metrics, _ = sharded_steps(
            cfg, None, axes, [np.zeros((4, cfg.max_seq + 1), np.int64)],
            device="cpu", optimizer_kw=opt)
        out.append(("main", axes, metrics[0]["loss"]))
        if world >= 8:
            # Multi-slice variant: a dcn axis stacked over the others.
            dcn = dict(dcn=2, data=2, tensor=2)
            dcn_cfg = GPT2Config(vocab_size=256, n_layer=2, n_head=4,
                                 d_model=64, d_ff=128, max_seq=32,
                                 remat=True)
            metrics, _ = sharded_steps(
                dcn_cfg, None, dcn, [np.zeros((8, 33), np.int64)],
                device="cpu", optimizer_kw=opt, loss_kw=dict(loss_chunk=0))
            out.append(("dcn", dcn, metrics[0]["loss"]))
            # Expert-parallel variant: DP x EP x TP with MoE blocks.
            ep = dict(data=2, expert=2, tensor=2)
            ep_cfg = dataclasses.replace(dcn_cfg, moe_num_experts=4,
                                         moe_every=2)
            metrics, _ = sharded_steps(
                ep_cfg, None, ep, [np.zeros((4, 33), np.int64)],
                device="cpu", optimizer_kw=opt, loss_kw=dict(loss_chunk=0))
            out.append(("ep", ep, metrics[0]["loss"]))
    finally:
        col.destroy_collective_group("gang")
    return out


def dryrun_multichip(n_devices: int, timeout: float = 300.0,
                     workdir: Optional[str] = None):
    """One sharded training step over an ``n_devices``-rank gloo gang on
    the CPU; prints and returns each variant's (name, mesh, loss)."""
    import math

    runs = spawn(_dryrun_rank, n_devices, timeout=timeout, workdir=workdir)
    for name, axes, loss in runs[0]:
        if not math.isfinite(loss):
            raise RuntimeError(f"dryrun_multichip({n_devices}) {name}: "
                               f"loss {loss}")
        print(f"dryrun_multichip({n_devices}) {name}: loss={loss:.4f} "
              f"mesh={axes}")
    return runs[0]
