"""Ulysses sequence parallelism: head/sequence all-to-all.  Counterpart of
``ray_tpu/parallel/ulysses.py``.

One ``all_to_all_single`` switches q, k and v from sequence-sharded to
head-sharded (the full sequence on heads/N heads), attention runs
locally, and a second one switches the result back.  ``_AllToAll`` is
the exchange as an autograd function (its backward is the same
exchange in the other direction); on gloo, CUDA tensors are staged
through host memory as in ``ring_attention``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .ring_attention import process_group


def _default_attn(q, k, v, causal: bool):
    """Dense attention with float32 scores, as the JAX package's."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * d ** -0.5
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = torch.arange(t_q, device=q.device)[:, None] >= \
            torch.arange(t_k, device=q.device)[None, :]
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)).to(q.dtype)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over dim 0 (N equal chunks, chunk j to rank j)."""
    staged = dist.get_backend(group) == "gloo" and x.is_cuda
    send = (x.detach().cpu() if staged else x.detach()).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(x.device) if staged else recv


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _exchange(g, ctx.group)


def _to_heads(x, group, n):
    """[B, Tl, H, D] seq-sharded -> [B, Tl*N, H/N, D] head-sharded."""
    b, t, h, d = x.shape
    chunks = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(group, chunks)         # [N (src), B, Tl, H/N, D]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def _to_seq(x, group, n):
    """[B, T, H/N, D] head-sharded -> [B, T/N, H, D] seq-sharded."""
    b, t, hn, d = x.shape
    chunks = x.reshape(b, n, t // n, hn, d).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(group, chunks)         # [N (src), B, T/N, H/N, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hn, d)


def ulysses_attention(q, k, v, *, group=None, causal: bool = True,
                      attn_fn: Optional[Callable] = None):
    """q, k, v: this rank's sequence shard [B, T_local, H, D] on
    ``group`` (the ``seq`` axis); H must divide by the group's size."""
    group = process_group(group)
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads ({h}) must be divisible by the seq axis "
                         f"size ({n}) for Ulysses; use ring attention")
    attn = attn_fn or _default_attn
    qg, kg, vg = (_to_heads(x, group, n) for x in (q, k, v))
    return _to_seq(attn(qg, kg, vg, causal), group, n)
