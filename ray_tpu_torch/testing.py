"""Worker functions the CPU parity tests run in spawned ranks
(``dryrun.spawn``).  They live in the package so that a child process
imports only the port; each joins its gang, runs its cases and returns
numpy arrays for the parent to hold against the JAX package."""

from __future__ import annotations


def _np(x):
    return x.detach().cpu().numpy()


def collective_cases(rank: int, world: int, rendezvous: str):
    """Every op of a gloo group on small float tensors, and a group
    name joined again after destroy; {case: numpy result}."""
    import torch

    from . import collective as col
    from .dryrun import join

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
    case (name, kind, impl, causal, q, k, v) gives full float32 numpy
    inputs [B, T, H, D]; this rank takes its sequence shard, and returns
    its output shard and the gradients of sum(out ** 2) for q, k, v."""
    import torch

    from . import collective as col
    from .dryrun import join
    from .parallel.ring_attention import ring_attention
    from .parallel.ulysses import ulysses_attention

    group = join(rank, world, rendezvous)
    out = {}
    try:
        for name, kind, impl, causal, *qkv in cases:
            t = qkv[0].shape[1] // world
            q, k, v = (torch.tensor(x[:, rank * t:(rank + 1) * t])
                       .requires_grad_() for x in qkv)
            if kind == "ring":
                o = ring_attention(q, k, v, group=group, causal=causal,
                                   impl=impl)
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

    from . import collective as col
    from .dryrun import join, sharded_steps
    from .models import gpt2, llama
    from .parallel.mesh import MeshSpec, create_mesh
    from .parallel.sharding import distribute, logical_sharding
    from .train import distributed, train_step

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
