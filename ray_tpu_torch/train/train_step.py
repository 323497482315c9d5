"""Training step: global-norm clip + AdamW on a warmup-cosine schedule.

Counterpart of ``ray_tpu/train/train_step.py`` (``TrainState``,
``make_optimizer``, ``make_train_step``), with optax's semantics kept:

- the schedule is ``warmup_cosine_decay_schedule(0, peak, warmup,
  max(total, warmup + 1), 0.1 * peak)``: the warmup counts inside the
  decay steps, and the learning rate is read at the count *before* the
  update, so it is 0 on the first step;
- ``clip_by_global_norm`` leaves the gradients alone while their norm is
  below the limit and otherwise scales them by ``limit / norm`` (no
  ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``);
- ``adamw`` decays every parameter, biases and norm scales included.

Unlike the JAX step, which returns a new state, the step here updates
the model's parameters and the optimizer moments in place.  The update
runs as a handful of ``torch._foreach_*`` calls over all parameters.

The sharded step: ``shard_state`` turns the parameters and both AdamW
moments into DTensors placed by the model's logical parameter axes
(``gpt2_param_axes`` / ``llama_param_axes``) through ``ShardingRules``;
``make_sharded_train_step`` runs the same loss, clip and AdamW on them.
The gradients are brought to their parameters' placements (DTensor's
reduce-scatter or all-reduce over the batch axes), the clip uses the
norm of the whole gradient (one all-reduce of the shards' squared sums),
and the update is elementwise on each rank's local shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear warmup from
    ``init_value``, then cosine decay to ``end_value`` at ``decay_steps``
    (a total that includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps=1e-8, weight_decay))`` over a list of parameters."""

    def __init__(self, schedule: Callable[[int], float], *, grad_clip: float,
                 b1: float, b2: float, eps: float, weight_decay: float):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               params: List[torch.Tensor],
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place (``grads``
        are clipped in place too).  Returns the pre-clip global norm,
        ``norm`` when the caller gives it (the sharded step passes the
        norm of the whole gradient and its local shards)."""
        if norm is None:
            norm = global_norm(grads)
        clip = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        lr = self.schedule(state["count"])   # the pre-increment count
        count = state["count"] + 1
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        state["count"] = count
        return norm


def make_optimizer(learning_rate: float = 3e-4,
                   warmup_steps: int = 100,
                   total_steps: int = 10000,
                   weight_decay: float = 0.1,
                   grad_clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.95) -> ClippedAdamW:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=learning_rate * 0.1)
    return ClippedAdamW(schedule, grad_clip=grad_clip, b1=b1, b2=b2,
                        eps=1e-8, weight_decay=weight_decay)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Dict

    @classmethod
    def create(cls, model: nn.Module, optimizer: ClippedAdamW
               ) -> "TrainState":
        return cls(step=0, model=model,
                   opt_state=optimizer.init(list(model.parameters())))


def make_train_step(loss_fn: Callable, optimizer: ClippedAdamW
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """loss_fn(model, batch) -> scalar.  Returns step(state, batch) ->
    (state, {"loss", "grad_norm"}), where grad_norm is the pre-clip
    global norm.  The state is updated in place and returned."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = list(state.model.parameters())
        loss = loss_fn(state.model, batch)
        grads = list(torch.autograd.grad(loss, params))
        grad_norm = optimizer.update(grads, state.opt_state, params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


# ------------------------------------------------------------- sharded
def shard_state(state: TrainState, mesh, param_axes_fn, rules=None
                ) -> TrainState:
    """Place the parameters AND both optimizer moments as DTensors on
    ``mesh``, each with the sharding of ``param_axes_fn(path, leaf)``
    through ``rules`` (moments mirror their parameters).  ``path`` is the
    flax-style name, e.g. ``h_0/c_attn/kernel``.  Every rank holds the
    full values (a deterministic init) and keeps its own slices.  The
    state is updated in place and returned."""
    from ..parallel.sharding import shard_pytree

    return place_state(state, shard_pytree(
        dict(state.model.named_parameters()), mesh, param_axes_fn, rules))


def place_state(state: TrainState, placed, moments=None) -> TrainState:
    """Swap the model's parameters for ``placed`` ({state_dict name:
    DTensor}) and place both moments as their parameters are, or take
    them from ``moments`` ({"mu", "nu": {name: DTensor}}, a restored
    checkpoint's)."""
    model = state.model
    for name, value in placed.items():
        if value.shape != model.get_parameter(name).shape:
            raise ValueError(f"parameter {name} may not be split over the "
                             "replica axes (dcn, data)")
        module_name, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(module_name), leaf,
                nn.Parameter(value.detach()))
    if moments is not None:
        names = [n for n, _p in model.named_parameters()]
        for key in ("mu", "nu"):
            state.opt_state[key] = [moments[key][n] for n in names]
        return state
    params = list(model.parameters())
    for key in ("mu", "nu"):
        state.opt_state[key] = [_like_param(m, p) for m, p in
                                zip(state.opt_state[key], params)]
    return state


def _like_param(tensor: torch.Tensor, param) -> torch.Tensor:
    """``tensor`` (full value) placed as ``param`` is."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor.detach(), param.device_mesh,
                             list(param.placements), src_data_rank=None)


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def sharded_global_norm(grads: List[torch.Tensor],
                        replicas: int = 1) -> torch.Tensor:
    """The norm of the whole gradient from DTensor shards, the same in
    each of ``replicas`` replica groups of the gang: each rank sums its
    shards' squares, a replicated shard counted once per copy (divided
    by its replication), and one all-reduce over the gang adds the
    ranks' sums."""
    import torch.distributed as dist

    sums = []
    for g in grads:
        copies = replicas
        for i, placement in enumerate(g.placements):
            if placement.is_replicate():
                copies *= g.device_mesh.size(i)
        local = g.to_local().float()
        sums.append((local * local).sum() / copies)
    total = torch.stack(sums).sum()
    dist.all_reduce(total)
    return total.sqrt()


def make_sharded_train_step(loss_fn: Callable, optimizer: ClippedAdamW,
                            mesh=None, telemetry: bool = True):
    """``make_train_step`` for a state placed by ``shard_state`` on
    ``mesh``, with the batch a DTensor (``train.distributed.
    put_global_batch`` or ``parallel.sharding.distribute``).  Returns
    step(state, batch) -> (state, {"loss", "grad_norm"}), the metrics
    plain tensors with the same value on every rank.  Each replica group
    (the ``dcn`` x ``data`` axes, outside DTensor) takes the mean loss of
    its own rows; the step averages gradients and loss over the groups.
    With ``mesh=None`` the step is ``make_train_step``'s.

    The JAX step's ``donate`` and ``state_shardings`` have nothing to do
    here: the update is in place, and the DTensors carry their
    placements.

    With ``telemetry`` (default), each call is timed on the host and
    attributed to the goodput ledger (``_step_phase``): the first call
    (lazy initialisation, the allocator's warm-up and one
    ``xprof.harvest_step`` pass, which counts the step's FLOPs, bytes,
    memory and collectives) lands in ``compile``, sets
    ``rt_train_compile_seconds`` and registers the program
    ``train_step`` with xprof, its collectives attributed to the mesh's
    axes; later calls land in ``compute`` and feed
    ``rt_train_step_dispatch_seconds``.  On the card the host returns
    before the device finishes, so those seconds are dispatch times; the
    per-step truth is the session's ``rt_train_step_time_seconds``."""
    if mesh is None:
        step = make_train_step(loss_fn, optimizer)
        return _step_phase(step, None) if telemetry else step
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import replica_axes

    replicas = [] if mesh is None else [
        (mesh.get_group(a), mesh.size(mesh.mesh_dim_names.index(a)))
        for a in replica_axes(mesh)]
    n_replicas = 1
    for _group, size in replicas:
        n_replicas *= size

    def replica_mean(tensors: List[torch.Tensor]) -> None:
        """Average over the replica groups (each computed the mean loss
        of its own batch rows), in place, one all-reduce per axis."""
        if not replicas:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        for group, _size in replicas:
            dist.all_reduce(flat, group=group)
        flat /= n_replicas
        for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(f.view_as(t))

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = list(state.model.parameters())
        loss = loss_fn(state.model, batch)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, params)]
            replica_mean([_local(g) for g in grads])
            norm = sharded_global_norm(grads, n_replicas)
            opt = state.opt_state
            local = {"count": opt["count"],
                     "mu": [_local(m) for m in opt["mu"]],
                     "nu": [_local(v) for v in opt["nu"]]}
            optimizer.update([_local(g) for g in grads], local,
                             [_local(p) for p in params], norm=norm)
            opt["count"] = local["count"]
        state.step += 1
        loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
        loss = loss.detach().reshape(1)
        replica_mean([loss])
        return state, {"loss": loss[0], "grad_norm": norm}

    return _step_phase(step, mesh) if telemetry else step


def _step_phase(step: Callable, mesh) -> Callable:
    """``step`` timed into the goodput ledger: the first call in
    ``compile`` (through ``xprof.harvest_step``, registering the program
    ``train_step``), later ones in ``compute``."""
    import time

    from ..util import goodput, xprof
    from ..util.metrics import Gauge, Histogram

    mesh_axes = None
    if mesh is not None:
        from ..parallel.mesh import mesh_axis_sizes

        mesh_axes = mesh_axis_sizes(mesh)
    harvested = [False]

    def timed_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        first = not harvested[0]
        t0 = time.perf_counter()
        with goodput.ledger().phase("compile" if first else "compute"):
            if first:
                out, info = xprof.harvest_step(step, state, batch,
                                               mesh_axes=mesh_axes)
                harvested[0] = True
            else:
                out = step(state, batch)
        dt = time.perf_counter() - t0
        try:
            if first:
                Gauge("rt_train_compile_seconds",
                      "Host-side duration of the first (tracing + "
                      "XLA compile) step invocation.").set(dt)
                xprof.register_program("train_step", info,
                                       compile_seconds=dt)
            else:
                Histogram("rt_train_step_dispatch_seconds",
                          "Host-side duration of the jitted step call "
                          "(approximate under async dispatch)."
                          ).observe(dt)
        except Exception:
            pass  # telemetry must never fail a training step
        return out

    return timed_step
