"""ray_tpu_torch.testing — helpers for tests.

The chaos killers of ``chaos.py`` (the JAX package's
``ray_tpu.testing``), and the worker functions the CPU parity tests run
in spawned ranks (``dryrun.spawn``).  Those live in the package so that
a child process imports only the port; each joins its gang, runs its
cases and returns numpy arrays for the parent to hold against the JAX
package."""

from __future__ import annotations

from .chaos import (NodeKiller, PreemptionKiller,  # noqa: F401
                    ReplicaKiller, TornWriteInjector, WorkerKiller,
                    preempt_node_processes)


def _np(x):
    return x.detach().cpu().numpy()


def collective_cases(rank: int, world: int, rendezvous: str):
    """Every op of a gloo group on small float tensors, and a group
    name joined again after destroy; {case: numpy result}."""
    import torch

    from .. import collective as col
    from ..dryrun import join

    out = {}
    join(rank, world, rendezvous, group_name="ops")
    ones = torch.ones(4)
    out["allreduce_sum"] = col.allreduce(ones * (rank + 1), "ops")
    for op in ("prod", "max", "min", "mean"):
        out[f"allreduce_{op}"] = col.allreduce(ones * (rank + 1), "ops", op)
    x = torch.full((2,), 10.0 + rank)
    before = x.clone()
    out["allgather"] = torch.stack(col.allgather(x, "ops"))
    out["input_untouched"] = torch.tensor(float(torch.equal(x, before)))
    out["broadcast"] = col.broadcast(torch.full((3,), 100.0 + rank), 1,
                                     "ops")
    rows = torch.full((world, 3), float(rank + 1))
    out["reducescatter"] = col.reducescatter(rows, "ops")
    out["reducescatter_mean"] = col.reducescatter(rows, "ops", "mean")
    uneven = torch.arange(5 * 2, dtype=torch.float32).reshape(5, 2) + rank
    out["reducescatter_uneven"] = col.reducescatter(uneven, "ops")
    col.barrier("ops")
    out["rank_size"] = torch.tensor([col.get_rank("ops"),
                                     col.get_collective_group_size("ops")])
    # Point to point around the ring: rank r sends to r + 1.  Each
    # rank sends first or receives first by parity, so blocking sends
    # pair up even on an odd ring.
    payload = torch.arange(3, dtype=torch.float64).reshape(1, 3) + rank
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    if rank % 2 == 0:
        col.send(payload, nxt, "ops")
        got = col.recv(prv, "ops", timeout=60.0)
    else:
        got = col.recv(prv, "ops", timeout=60.0)
        col.send(payload, nxt, "ops")
    out["p2p"] = got
    # Two groups of half the gang's size at once, each with its own
    # process group: the halves (ranks 0..n/2-1 and n/2..n-1) and the
    # strided pairs (even and odd ranks).
    half = world // 2
    for name, members in (("halves", [list(range(half)),
                                      list(range(half, world))]),
                          ("strided", [list(range(0, world, 2)),
                                       list(range(1, world, 2))])):
        index = next(i for i, m in enumerate(members) if rank in m)
        sub = members[index].index(rank)
        join(sub, half, rendezvous, group_name=name,
             store=f"{name}{index}")
        out[f"{name}_rank_size"] = torch.tensor(
            [col.get_rank(name), col.get_collective_group_size(name)])
        out[f"{name}_allreduce"] = col.allreduce(ones * (rank + 1), name)
        out[f"{name}_allgather"] = torch.stack(
            col.allgather(torch.full((2,), float(rank)), name))
        out[f"{name}_broadcast"] = col.broadcast(
            torch.full((1,), float(rank)), half - 1, name)
    out["gang_after_halves"] = col.allreduce(ones, "ops")
    for name in ("halves", "strided"):
        col.destroy_collective_group(name)
    # A second group beside the first, then the name joined again after
    # destroy (with a new rendezvous: the old one is gone).
    join(rank, world, rendezvous, group_name="side")
    out["side_sum"] = col.allreduce(ones, "side")
    col.destroy_collective_group("side")
    col.destroy_collective_group("ops")
    out["destroyed_rank"] = torch.tensor(col.get_rank("ops"))
    join(rank, world, rendezvous, group_name="ops", store="again")
    out["reused_sum"] = col.allreduce(ones * 2, "ops")
    col.destroy_collective_group("ops")
    return {k: _np(v) for k, v in out.items()}


def attention_cases(rank: int, world: int, rendezvous: str, cases):
    """Ring and Ulysses attention over the gang's ``seq`` group.  Each
    case (name, kind, impl, causal, checkpoint_steps, q, k, v) gives
    full float32 numpy inputs [B, T, H, D]; this rank takes its sequence
    shard, and returns its output shard and the gradients of
    sum(out ** 2) for q, k, v."""
    import torch

    from .. import collective as col
    from ..dryrun import join
    from ..parallel.ring_attention import ring_attention
    from ..parallel.ulysses import ulysses_attention

    group = join(rank, world, rendezvous)
    out = {}
    try:
        for name, kind, impl, causal, ckpt, *qkv in cases:
            t = qkv[0].shape[1] // world
            q, k, v = (torch.tensor(x[:, rank * t:(rank + 1) * t])
                       .requires_grad_() for x in qkv)
            if kind == "ring":
                o = ring_attention(q, k, v, group=group, causal=causal,
                                   checkpoint_steps=ckpt, impl=impl)
            else:
                o = ulysses_attention(q, k, v, group=group, causal=causal)
            grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
            out[name] = [_np(o)] + [_np(g) for g in grads]
    finally:
        col.destroy_collective_group("gang")
    return out


def sharded_step_cases(rank: int, world: int, rendezvous: str, cases):
    """``dryrun.sharded_steps`` for each case (name, model, config,
    flax numpy params, mesh axes, token batches).  Also, on each mesh:
    this rank's rows of a [8, 1] batch placed by the ("batch", None)
    rule, whether ``put_global_batch`` of its ``global_batch_slice`` rows
    gives the same local rows, and the placements of every parameter
    from the model's logical axes (``shard_state``) and from its regex
    rule set (``shard_train_state``).  Returns {name: (metrics, final
    params, batch rows, rows agree, placements by logical axes,
    placements by rules)}."""
    import torch

    from .. import collective as col
    from ..dryrun import join, sharded_steps
    from ..models import gpt2, llama
    from ..parallel.mesh import MeshSpec, create_mesh
    from ..parallel.sharding import distribute, logical_sharding
    from ..train import distributed, train_step

    join(rank, world, rendezvous)
    out = {}
    try:
        for name, model, cfg, params, axes, batches in cases:
            metrics, final = sharded_steps(
                cfg, params, axes, batches, model=model, device="cpu",
                optimizer_kw=dict(total_steps=10, warmup_steps=2))
            mesh = create_mesh(MeshSpec(**axes), device="cpu")
            full = torch.arange(8).reshape(8, 1)
            rows = distribute(full, logical_sharding(mesh, ("batch", None)))
            sizes = distributed.mesh_axis_sizes(mesh)
            lo, hi = distributed.global_batch_slice(
                8, {"fsdp": sizes["dcn"] * sizes["data"] * sizes["fsdp"],
                    "tensor": world // (sizes["dcn"] * sizes["data"]
                                        * sizes["fsdp"])}, rank, world)
            put = distributed.put_global_batch(
                {"t": full[lo:hi]}, mesh,
                spec=(("dcn", "data", "fsdp"), None))["t"]
            family = {"gpt2": (gpt2.GPT2, gpt2.gpt2_param_axes),
                      "llama": (llama.Llama, llama.llama_param_axes)}
            cls, axes_fn = family[model]
            placements = []
            for place in (
                    lambda s: train_step.shard_state(s, mesh, axes_fn),
                    lambda s: distributed.shard_train_state(
                        s, mesh, distributed.rules_for_model(model))[0]):
                state = place(train_step.TrainState.create(
                    cls(cfg, device="cpu"), train_step.make_optimizer()))
                placements.append({n: repr(p.placements) for n, p in
                                   state.model.named_parameters()})
            out[name] = (metrics, final, _np(rows.to_local())[:, 0],
                         torch.equal(put.to_local(), rows.to_local()),
                         *placements)
    finally:
        col.destroy_collective_group("gang")
    return out


def moe_step_cases(rank: int, world: int, rendezvous: str, cases):
    """``dryrun.sharded_steps`` for each case (name, config, flax numpy
    params, mesh axes, token batches) of a GPT-2 MoE config, and each
    expert weight's placements.  Returns {name: (metrics, final params,
    {parameter: placements})}."""
    from .. import collective as col
    from ..dryrun import join, sharded_steps
    from ..models import gpt2
    from ..parallel.mesh import MeshSpec, create_mesh
    from ..train import train_step

    join(rank, world, rendezvous)
    out = {}
    try:
        for name, cfg, params, axes, batches in cases:
            metrics, final = sharded_steps(
                cfg, params, axes, batches, device="cpu",
                optimizer_kw=dict(total_steps=10, warmup_steps=2),
                loss_kw=dict(loss_chunk=0))
            mesh = create_mesh(MeshSpec(**axes), device="cpu")
            state = train_step.shard_state(train_step.TrainState.create(
                gpt2.GPT2(cfg, device="cpu"), train_step.make_optimizer()),
                mesh, gpt2.gpt2_param_axes)
            placements = {n: repr(p.placements) for n, p in
                          state.model.named_parameters() if "moe" in n}
            out[name] = (metrics, final, placements)
    finally:
        col.destroy_collective_group("gang")
    return out


def pipeline_cases(rank: int, world: int, rendezvous: str, cases):
    """``parallel.pipeline.pipeline_apply`` over the gang, one stage per
    rank, with stage_fn ``tanh(h @ w)``.  Each case (name, stacked stage
    weights [S, d, d], x [B, d], microbatches, checkpoint_stage) gives
    numpy inputs; rank r runs stage ``w[r]``.  Returns {name: (output,
    this stage's gradient of sum(out ** 2), the input's gradient)} and
    whether a batch that does not divide by the microbatches raises."""
    import torch

    from .. import collective as col
    from ..dryrun import join
    from ..parallel.pipeline import pipeline_apply

    group = join(rank, world, rendezvous)
    out = {}
    try:
        for name, ws, x, m, ckpt in cases:
            w = torch.tensor(ws[rank], requires_grad=True)
            xt = torch.tensor(x, requires_grad=True)
            y = pipeline_apply(lambda p, h: torch.tanh(h @ p), w, xt,
                               num_microbatches=m, group=group,
                               checkpoint_stage=ckpt)
            gw, gx = torch.autograd.grad((y ** 2).sum(), (w, xt))
            out[name] = (_np(y), _np(gw), _np(gx))
        try:
            pipeline_apply(lambda p, h: h, None, torch.zeros(7, 2),
                           num_microbatches=2, group=group)
            out["indivisible_raises"] = False
        except ValueError:
            out["indivisible_raises"] = True
    finally:
        col.destroy_collective_group("gang")
    return out


def checkpoint_cases(rank: int, world: int, rendezvous: str, jax_dir: str,
                     out_dir: str, host_tree, cfg, batches):
    """Sharded checkpoints over an ``fsdp`` x world gang on the CPU:

    - ``host_tree`` ({"w", "b"} numpy) placed as DTensors (w over fsdp,
      b replicated) and saved into ``out_dir/port_tree``;
    - ``jax_dir`` (a checkpoint the JAX package wrote) restored onto the
      mesh: each leaf's full value, local shard and placements;
    - the GPT-2 ``cfg`` train state: one step, saved into
      ``out_dir/state``, a second step; then a fresh state restored from
      the checkpoint takes the second step again.

    Returns (restored JAX leaves, the state after step 1 as numpy, the
    second step's loss and parameters, uninterrupted and restored, and
    whether the restored leaves kept their placements)."""
    import dataclasses
    import os

    import torch

    from .. import collective as col
    from ..dryrun import join
    from ..models import convert, gpt2
    from ..parallel.mesh import MeshSpec, create_mesh
    from ..parallel.sharding import PartitionSpec, distribute, spec_placements
    from ..train import distributed, train_step
    from ..train.sharded_checkpoint import load_sharded, save_sharded

    group = join(rank, world, rendezvous)
    try:
        mesh = create_mesh(MeshSpec(fsdp=world), device="cpu")
        tree = {"w": distribute(torch.from_numpy(host_tree["w"]),
                                spec_placements(mesh, PartitionSpec("fsdp"))),
                "b": distribute(torch.from_numpy(host_tree["b"]),
                                spec_placements(mesh, PartitionSpec()))}
        save_sharded(os.path.join(out_dir, "port_tree"), tree, mesh=mesh,
                     save_id="tree")
        got = load_sharded(jax_dir, mesh=mesh)
        restored = {k: (_np(v.full_tensor()), _np(v.to_local()),
                        repr(v.placements)) for k, v in got.items()}

        cfg = dataclasses.replace(cfg, mesh=mesh)
        opt = train_step.make_optimizer(total_steps=10, warmup_steps=2)

        def fresh(seed):
            net = gpt2.gpt2_init(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu")
            return train_step.shard_state(
                train_step.TrainState.create(net, opt), mesh,
                gpt2.gpt2_param_axes)

        step = train_step.make_sharded_train_step(
            lambda m, b: gpt2.gpt2_loss_fn(cfg, m, b), opt, mesh)
        sharding = spec_placements(mesh, PartitionSpec("fsdp"))

        def batch(i):
            return {"tokens": distribute(torch.from_numpy(batches[i]),
                                         sharding)}

        state, _ = step(fresh(0), batch(0))
        after1 = {k: _np(v.full_tensor()).copy() for k, v in
                  state.model.named_parameters()}
        path = os.path.join(out_dir, "state")
        save_sharded(path, distributed.train_state_tree(state), mesh=mesh,
                     save_id="state", meta={"step": state.step})
        group.barrier()     # rank 0 has committed
        _, m2 = step(state, batch(1))
        straight = (float(m2["loss"]), convert.gpt2_params_to_numpy(
            dict(state.model.named_parameters())))
        again = fresh(1)    # other weights, overwritten by the restore
        distributed.restore_train_state(again, load_sharded(path, mesh=mesh))
        kept = all(repr(p.placements) == repr(q.placements) for p, q in zip(
            again.model.parameters(), state.model.parameters()))
        _, m3 = step(again, batch(1))
        resumed = (float(m3["loss"]), convert.gpt2_params_to_numpy(
            dict(again.model.named_parameters())))
    finally:
        col.destroy_collective_group("gang")
    return restored, after1, straight, resumed, kept, again.step


def harvest_case(rank: int, world: int, rendezvous: str, cfg, axes,
                 tokens):
    """One sharded step (``dryrun.sharded_steps``, telemetry on) on the
    mesh ``axes``; returns the program ``train_step`` the step
    registered with xprof and the names of the registry's series."""
    from .. import collective as col
    from ..dryrun import join, sharded_steps
    from ..util import xprof
    from ..util.metrics import registry

    join(rank, world, rendezvous)
    try:
        sharded_steps(cfg, None, axes, [tokens], device="cpu")
    finally:
        col.destroy_collective_group("gang")
    return (xprof.local_programs().get("train_step"),
            sorted(s["name"] for s in registry().snapshot()))
