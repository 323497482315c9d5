"""Ring attention: context parallelism over a process group.  Counterpart
of ``ray_tpu/parallel/ring_attention.py``.

The sequence is sharded over the ``seq`` group; K/V blocks rotate around
the ring while each rank accumulates attention for its resident Q block.
The JAX package writes the ring as a ``lax.scan`` with ``ppermute``
inside ``shard_map`` and gets the backward by autodiff (the transpose of
a ppermute is the reverse rotation).  Here the ring is a Python loop on
local tensors, the rotation is ``_Shift``, an autograd function whose
backward is the reverse rotation, and autograd does the rest:

- on NCCL, ``batch_isend_irecv`` on the device tensors; the rotation is
  issued before the step's kernel and waited for after it, so the
  transfer overlaps the kernel;
- on gloo, CUDA tensors are staged through host memory, the way the
  collective groups' ``CPUGroup`` stages them (how several processes
  that share one card run the ring); CPU tensors go as they are.

Every rank must rotate, forward and backward, in the same order.  A
causal ring skips the blocks after the rank's own; ``_Skip`` keeps such
a block in the graph with a zero gradient (JAX's ``lax.switch`` skip
branch), so each rotation's backward runs on every rank.

``impl="flash"`` runs ``flash_attention_with_lse`` on each (Q_local,
K/V block) pair, the CUDA kernels on the card, and merges normalised
partials by log-sum-exp; its backward carries a nonzero lse cotangent
into the kernels.  ``impl="lax"`` is the plain version: online softmax
in float32 over dense blocks.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

_NEG_INF = -1e30


def process_group(group):
    """A ``torch.distributed`` group from a process group, a collective
    group (``collective.get_group``) or None (the default group)."""
    if group is None:
        return dist.group.WORLD
    return getattr(group, "process_group", group)


def _post_shift(xs, group, shift: int):
    """Send each tensor to rank + shift and receive from rank - shift.
    Returns (received tensors, works to wait on before reading them).
    On gloo a CUDA tensor goes through host memory and the exchange
    completes here; gloo goes through the group's own send/recv (ranks
    of the group), so a standalone gloo group rotates too."""
    from ..collective.collective_group.base import backend_name

    n, rank = group.size(), group.rank()
    dst, src = (rank + shift) % n, (rank - shift) % n
    gloo = backend_name(group) == "gloo"
    staged = gloo and xs[0].is_cuda
    sends = [(x.detach().cpu() if staged else x.detach()).contiguous()
             for x in xs]
    recvs = [torch.empty_like(s) for s in sends]
    if gloo:
        works = [group.send([s], dst, 0) for s in sends] + \
            [group.recv([r], src, 0) for r in recvs]
    else:
        dst = dist.get_global_rank(group, dst)
        src = dist.get_global_rank(group, src)
        works = dist.batch_isend_irecv([op for s, r in zip(sends, recvs)
                                        for op in (
            dist.P2POp(dist.isend, s, dst, group),
            dist.P2POp(dist.irecv, r, src, group))])
    if not staged:
        # The sends must stay alive until the works complete.
        return recvs, [(w, sends) for w in works]
    for w in works:
        w.wait()
    return [r.to(x.device) for r, x in zip(recvs, xs)], []


class _Shift(torch.autograd.Function):
    """Rotate tensors one rank forward; backward rotates their gradients
    one rank back.  The forward's pending works go into ``pending``."""

    @staticmethod
    def forward(ctx, group, pending: List, *xs):
        ctx.group = group
        outs, works = _post_shift(xs, group, 1)
        pending.extend(works)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        outs, works = _post_shift(grads, ctx.group, -1)
        for w, _keep in works:
            w.wait()
        return (None, None, *outs)


def _wait(pending: List) -> None:
    for w, _keep in pending:
        w.wait()
    pending.clear()


class _Skip(torch.autograd.Function):
    """A skipped ring block: the accumulators pass through and the K/V
    block gets a zero gradient, so its rotation stays in the graph."""

    @staticmethod
    def forward(ctx, out, lse, k, v):
        ctx.kv = (k.shape, k.dtype, k.device)
        return out.view_as(out), lse.view_as(lse)

    @staticmethod
    def backward(ctx, d_out, d_lse):
        shape, dtype, device = ctx.kv
        zero = torch.zeros(shape, dtype=dtype, device=device)
        return d_out, d_lse, zero, zero.clone()


def _block_attn(q, k, v, q_off, kv_off, causal, scale):
    """One (Q_local x KV_block) online-softmax partial in float32.
    q: [B, Tq, H, D]; k, v: [B, Tk, H, D] -> (num [B, Tq, H, D],
    den [B, Tq, H], m [B, Tq, H])."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_idx = q_off + torch.arange(tq, device=q.device)[:, None]
        kv_idx = kv_off + torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(q_idx >= kv_idx, scores, _NEG_INF)
    m = scores.amax(-1)                                    # [B, H, Tq]
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= _NEG_INF / 2, 0.0, p)
    den = p.sum(-1)
    num = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return num, den.transpose(1, 2), m.transpose(1, 2)


def _merge(num, den, m, num2, den2, m2):
    m_new = torch.maximum(m, m2)
    a1 = torch.exp(m - m_new)
    a2 = torch.exp(m2 - m_new)
    return (num * a1[..., None] + num2 * a2[..., None],
            den * a1 + den2 * a2, m_new)


def _steps(checkpoint_steps: bool):
    """How a ring step's block compute runs: as it is, or under
    ``torch.utils.checkpoint`` so its backward recomputes it.  Only the
    compute: the rotation stays outside, so the recompute sends
    nothing."""
    if not checkpoint_steps:
        return lambda fn, *args: fn(*args)
    from ..ops.remat import checkpoint

    return checkpoint


def ring_attention(q, k, v, *, group=None, causal: bool = True,
                   scale: Optional[float] = None,
                   checkpoint_steps: Optional[bool] = None,
                   impl: str = "flash",
                   block_q: int = 256, block_k: int = 256):
    """Attention over a sequence sharded on ``group`` (the ``seq`` axis's
    process group; see ``process_group``).

    q, k, v: this rank's shard [B, T_local, H, D], rank r holding
    positions [r * T_local, (r + 1) * T_local).  Returns the local output
    shard, same shape and dtype as q.

    ``checkpoint_steps`` recomputes each step's block compute in the
    backward.  It defaults per impl, as in the JAX package: False for
    flash (the kernels keep only O(T_local) residuals per step) and True
    for lax (whose step holds [Tq, Tk] score blocks)."""
    group = process_group(group)
    if impl == "flash":
        return _ring_flash(q, k, v, group=group, causal=causal, scale=scale,
                           run=_steps(bool(checkpoint_steps)),
                           block_q=block_q, block_k=block_k)
    if impl != "lax":
        raise ValueError(f"unknown ring attention impl {impl!r}")
    run = _steps(checkpoint_steps is None or checkpoint_steps)
    n, rank = group.size(), group.rank()
    b, t_local, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    q32 = q.float()

    def step(k_blk, v_blk, num, den, m, kv_off):
        num2, den2, m2 = _block_attn(
            q32, k_blk.float(), v_blk.float(), q_off=rank * t_local,
            kv_off=kv_off, causal=causal, scale=scale)
        return _merge(num, den, m, num2, den2, m2)

    num = q32.new_zeros((b, t_local, h, d))
    den = q32.new_zeros((b, t_local, h))
    m = q32.new_full((b, t_local, h), _NEG_INF)
    kv, pending = (k, v), []
    for i in range(n):
        k_blk, v_blk = kv
        src = (rank - i) % n      # whose block we currently hold
        num, den, m = run(step, k_blk, v_blk, num, den, m, src * t_local)
        if i < n - 1:
            kv = _Shift.apply(group, pending, k_blk, v_blk)
            _wait(pending)
    den = torch.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).to(q.dtype)


def _ring_flash(q, k, v, *, group, causal: bool, scale: Optional[float],
                run, block_q: int, block_k: int):
    """Each step runs the flash kernel on (Q_local, K/V block) and merges
    the normalised partials by their log-sum-exps:
        lse' = logaddexp(lse_acc, lse_blk)
        out' = out_acc * exp(lse_acc - lse') + out_blk * exp(lse_blk - lse')
    Blocks before the rank's own are dense, its own block is causal, and
    later blocks are skipped."""
    from ..ops.flash_attention import flash_attention_with_lse

    n, rank = group.size(), group.rank()
    b, t_local, h, d = q.shape
    if scale is not None and abs(scale - d ** -0.5) > 1e-9:
        raise ValueError("flash impl uses the standard 1/sqrt(d) scale")

    def step(k_blk, v_blk, out, lse, blk_causal):
        out_blk, lse_blk = flash_attention_with_lse(
            q, k_blk, v_blk, causal=blk_causal,
            block_q=block_q, block_k=block_k)
        lse_new = torch.logaddexp(lse, lse_blk)
        return (out * torch.exp(lse - lse_new)[..., None]
                + out_blk.float() * torch.exp(lse_blk - lse_new)[..., None],
                lse_new)

    out = q.new_zeros((b, t_local, h, d), dtype=torch.float32)
    lse = q.new_full((b, t_local, h), _NEG_INF, dtype=torch.float32)
    kv, pending = (k, v), []
    for i in range(n):
        k_blk, v_blk = kv
        # Issue the rotation first so the transfer of the next K/V block
        # overlaps this step's kernel.
        if i < n - 1:
            kv = _Shift.apply(group, pending, k_blk, v_blk)
        src = (rank - i) % n      # whose block we currently hold
        if causal and src > rank:
            out, lse = _Skip.apply(out, lse, k_blk, v_blk)
        else:
            out, lse = run(step, k_blk, v_blk, out, lse,
                           causal and src == rank)
        _wait(pending)
    return out.to(q.dtype)


def ring_attention_sharded(mesh, q, k, v, *, causal: bool = True):
    """Runs ``ring_attention`` under ``local_map`` on ``mesh`` with batch
    over (data, fsdp), sequence over ``seq`` and heads over ``tensor``;
    q, k, v are DTensors of the global [B, T, H, D]."""
    import functools

    from .sharding import PartitionSpec

    spec = PartitionSpec(("data", "fsdp"), "seq", "tensor", None)
    return local_attention(mesh, spec, functools.partial(
        ring_attention, group=mesh.get_group("seq"), causal=causal),
        q, k, v)


def local_attention(mesh, spec, fn, q, k, v):
    """``shard_map`` for attention: redistribute the DTensors q, k, v to
    ``spec`` on ``mesh``, run ``fn`` on the local shards, and return the
    result as a DTensor with the same spec."""
    from torch.distributed.tensor.experimental import local_map

    from .sharding import spec_placements

    sharding = spec_placements(mesh, spec)
    placements = list(sharding.placements)
    return local_map(fn, out_placements=placements,
                     in_placements=(placements,) * 3,
                     device_mesh=sharding.mesh,
                     redistribute_inputs=True)(q, k, v)
