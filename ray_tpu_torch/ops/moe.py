"""Mixture-of-Experts feed-forward with expert parallelism: counterpart of
``ray_tpu/ops/moe.py``.

The JAX package's dense design, step for step, so converted weights give
the same output, auxiliary loss and gradients:

- a top-k router with float32 logits and softmax, the chosen
  probabilities renormalised (``+1e-9``), and the Switch load-balancing
  loss ``E * sum_e f_e * p_e`` (``f`` from the top-1 assignments, ``p``
  the mean probability), which the layer returns beside its output (the
  JAX layer sows it);
- each (token, k) assignment's position within its expert: an exclusive
  cumsum over the token-major ``[S*K, E]`` one-hots, k minor within a
  token; an assignment at or past the capacity
  ``max(int(capacity_factor * S / E), top_k)`` gets combine weight 0;
- dispatch and combine as dense ``[S, E, C]`` tensors in the compute
  dtype, and the expert FFNs (GELU, tanh approximation) batched over E.

**Expert parallelism.**  Under GSPMD the JAX layer sees the step's whole
token set: ``S`` is the global ``B*T``, positions count across every
data shard in batch order, ``f`` and ``p`` are global means, and the
``[E, C, D]`` expert input sums the dispatched tokens of every data
shard.  The port keeps the replica axes (``dcn``, ``data``) outside
DTensor, so each replica group holds only its own rows; the sharded
layer (``local_map`` over the placement mesh, JAX's ``shard_map``) makes
the same numbers with collectives over the replica axes: an all-gather
of the per-expert counts (position offsets, the global ``S``), an
all-reduce of ``f`` and ``p`` before their product, and an
autograd-aware all-reduce of the expert input.  Inside a replica group
the routing runs whole on every rank; each rank computes only its own
experts (``expert`` axis) and its slice of ``d_ff`` (``tensor`` axis),
and the partial outputs are summed (``parallel.grad_collectives``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import is_dtensor, resolve_device


def _route(xf: torch.Tensor, router: torch.Tensor, top_k: int,
           capacity_factor: float, replica: Sequence):
    """Routing of the tokens ``xf`` [S, D] (this replica group's) as part
    of the whole token set over the ``replica`` groups.  Returns
    (expert index [S, K], slot [S, K] with ``capacity`` for a dropped
    assignment, gate weights [S, K] (0 when dropped), capacity, aux)."""
    from ..parallel.grad_collectives import all_reduce_sum

    s = xf.shape[0]
    e = router.shape[1]
    probs = torch.softmax(xf.float() @ router, dim=-1)            # [S, E]
    gate, idx = torch.topk(probs, top_k, dim=-1)                 # [S, K]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(idx, e)                                    # [S,K,E]
    flat = onehot.reshape(s * top_k, e)          # k minor within a token
    pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(-1).reshape(s, top_k)
    top1 = onehot[:, 0].sum(0)
    s_all = s
    if replica:
        stats = _gather_groups(torch.cat([
            flat.sum(0), top1, torch.tensor([s], device=xf.device)]),
            replica)                             # [groups, 2E + 1]
        group = _group_index(replica)
        pos = pos + stats[:group, :e].sum(0)[idx]  # earlier groups first
        s_all = int(stats[:, -1].sum())
        top1 = stats[:, e:2 * e].sum(0)
    capacity = max(int(capacity_factor * s_all / e), top_k)
    f = top1.float() / s_all
    p = all_reduce_sum(probs.sum(0), replica) / s_all
    aux = e * torch.sum(f * p)
    keep = pos < capacity
    return (idx, torch.where(keep, pos, capacity), gate * keep, capacity,
            aux)


def _gather_groups(x: torch.Tensor, replica: Sequence) -> torch.Tensor:
    """``x`` of every replica group, stacked in group order (the first
    replica axis slowest)."""
    import torch.distributed as dist

    out = x[None]
    for g in reversed(list(replica)):
        parts = [torch.empty_like(out) for _ in range(g.size())]
        dist.all_gather(parts, out.contiguous(), group=g)
        out = torch.cat(parts)
    return out


def _group_index(replica: Sequence) -> int:
    index = 0
    for g in replica:
        index = index * g.size() + g.rank()
    return index


def _one_hots(idx, slot, capacity: int, values, n_experts: int):
    """[S, E, C] with ``values`` [S, K] at (s, idx, slot); a dropped
    assignment's slot is C, cut off with the spare column."""
    s, k = idx.shape
    rows = torch.arange(s, device=idx.device)[:, None].expand(s, k)
    out = values.new_zeros((s, n_experts, capacity + 1))
    return out.index_put((rows, idx, slot), values)[..., :capacity]


def moe_forward(x: torch.Tensor, router: torch.Tensor, w_in: torch.Tensor,
                w_out: torch.Tensor, *, top_k: int, capacity_factor: float,
                dtype, replica: Sequence = (), inner: Sequence = (),
                expert_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer on local tensors: ``x`` [B, T, D] (all of this replica
    group's tokens), ``router`` [D, E] whole, ``w_in`` [E_local, D,
    F_local] and ``w_out`` [E_local, F_local, D] this rank's experts
    from ``expert_offset`` on.  ``replica``: the process groups of the
    replica axes (token sets that the routing spans); ``inner``: those
    over which this rank's expert compute is a part.  Returns (y [B, T,
    D] in ``dtype``, aux)."""
    from ..parallel.grad_collectives import (all_reduce_sum, copy_to_region,
                                             reduce_from_region)

    b, t, d = x.shape
    e = router.shape[1]
    xf = x.reshape(b * t, d)
    idx, slot, gate, capacity, aux = _route(xf, router, top_k,
                                            capacity_factor, replica)
    local = slice(expert_offset, expert_offset + w_in.shape[0])
    dispatch = _one_hots(idx, slot, capacity,
                         torch.ones_like(gate, dtype=dtype), e)[:, local]
    combine = _one_hots(idx, slot, capacity,
                        copy_to_region(gate, inner).to(dtype), e)[:, local]
    xin = copy_to_region(xf, inner).to(dtype)
    expert_in = all_reduce_sum(torch.einsum("sec,sd->ecd", dispatch, xin),
                               replica)                           # [E,C,D]
    h = torch.einsum("ecd,edf->ecf", expert_in, w_in.to(dtype))
    h = F.gelu(h, approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, w_out.to(dtype))
    y = torch.einsum("sec,ecd->sd", combine, out)
    return reduce_from_region(y, inner).reshape(b, t, d), aux


class MoEMLP(nn.Module):
    """Drop-in replacement for a transformer MLP block; ``forward``
    returns (output, Switch auxiliary loss).  Parameters are float32:
    ``router`` [D, E], ``w_in`` [E, D, F], ``w_out`` [E, F, D].  With
    DTensor parameters (``train_step.shard_state``) the layer runs
    expert-parallel over ``mesh``, the full mesh its replica axes come
    from."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dtype=torch.bfloat16, device=None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.mesh = mesh
        e = num_experts
        self.router = nn.Parameter(torch.empty(d_model, e, device=device))
        self.w_in = nn.Parameter(torch.empty(e, d_model, d_ff,
                                             device=device))
        self.w_out = nn.Parameter(torch.empty(e, d_ff, d_model,
                                              device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX layer's initializers: normal(0.02 / sqrt(D)) for the
        router, normal(0.02) for the experts."""
        d = self.router.shape[0]
        self.router.normal_(0.0, 0.02 / math.sqrt(d), generator=generator)
        self.w_in.normal_(0.0, 0.02, generator=generator)
        self.w_out.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        kw = dict(top_k=self.top_k, capacity_factor=self.capacity_factor,
                  dtype=self.dtype)
        if not is_dtensor(self.w_in):
            return moe_forward(x, self.router, self.w_in, self.w_out, **kw)
        return _sharded(self, x, kw)


def _sharded(layer: MoEMLP, x, kw):
    """``moe_forward`` under ``local_map`` on the parameters' mesh: x and
    the router whole on every rank, each expert weight split over the
    axes that split its expert and ``d_ff`` dims (gathered over the
    others, such as ``fsdp``); y and aux come back replicated."""
    import functools

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..parallel.sharding import replica_axes

    w_in, w_out = layer.w_in, layer.w_out
    sub = w_in.device_mesh
    keep_in, keep_out, inner = [], [], []
    offset = 0
    for i, p in enumerate(w_in.placements):
        if isinstance(p, Shard) and p.dim in (0, 2):
            keep_in.append(p)
            keep_out.append(Shard(1) if p.dim == 2 else p)
            inner.append(sub.get_group(i))
            if p.dim == 0:
                n = sub.size(i)
                if w_in.shape[0] % n:
                    raise ValueError(f"{w_in.shape[0]} experts do not split "
                                     f"over {n} ranks")
                offset += sub.get_local_rank(i) * (w_in.shape[0] // n)
        else:
            keep_in.append(Replicate())
            keep_out.append(Replicate())
    rep = [Replicate()] * sub.ndim
    mesh = layer.mesh
    replica = [] if mesh is None else [mesh.get_group(a)
                                       for a in replica_axes(mesh)]
    fn = functools.partial(moe_forward, replica=replica, inner=inner,
                           expert_offset=offset, **kw)
    return local_map(fn, out_placements=(rep, rep),
                     in_placements=(rep, rep, keep_in, keep_out),
                     device_mesh=sub, redistribute_inputs=True)(
        x, layer.router, w_in, w_out)


def moe_param_axes(path: str, leaf) -> Optional[Tuple]:
    """Logical axes for MoE parameters (None: not a MoE parameter)."""
    if "router" in path:
        return ("embed_fsdp", None)
    if "w_in" in path:
        return ("expert", "embed_fsdp", "mlp")
    if "w_out" in path:
        return ("expert", "mlp", "embed_fsdp")
    return None
