"""Blockwise (flash) attention: CUDA kernels on the card, plain PyTorch
on the CPU.

Counterpart of ``ray_tpu/ops/flash_attention.py``.  The [B, H, T, T]
score matrix never reaches device memory: the forward keeps a running
max/denominator and an fp32 accumulator per row (online softmax) and
saves only the row log-sum-exp; the backward recomputes P from it.

Public API, as in the JAX package: ``flash_attention`` and
``flash_attention_with_lse`` on [B, T, H, D] tensors, scale
``D ** -0.5``, blocks clamped to T, and a ValueError when T does not
divide by a block.  Both are ``torch.autograd.Function``s (the JAX
package's two ``custom_vjp``s).

Each of the three steps has two versions with one signature:

- a kernel in ``csrc/flash_fwd.cu``, ``csrc/flash_dkv.cu`` or
  ``csrc/flash_dq.cu`` (wrappers in ``_kernels``), taken for every CUDA
  tensor, with no fallback;
- a plain PyTorch version (``flash_fwd_plain``, ``flash_dkv_plain``,
  ``flash_dq_plain``) taken for every CPU tensor.  It loops over the
  same (q-block, kv-block) pairs with the same recurrence and casts as
  the Pallas kernels, and takes the place of Pallas ``interpret=True``.

On the card ``block_q``/``block_k`` only validate T: the CUDA kernels
use their own tiles (work items of 128 rows, ring stages of 128 kv rows
in the forward and dQ kernels and of 64 q rows in the dK/dV kernel) and
take every T that is a multiple of ``_kernels.TILE`` (64).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..util import xprof
from . import _kernels
from .matmul import matmul_f32

_NEG_INF = -1e30


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B, H, T, D] view."""
    return x.transpose(1, 2)


def _causal_mask(qi, ki, bq, bk, device):
    """(bq, bk) bool mask for the (qi, ki) block pair: row >= col."""
    rows = qi * bq + torch.arange(bq, device=device)[:, None]
    cols = ki * bk + torch.arange(bk, device=device)[None, :]
    return rows >= cols


def _visible(qi, ki, bq, bk, causal) -> bool:
    """Causal: skip kv blocks strictly above the diagonal."""
    return not causal or ki * bk <= qi * bq + bq - 1


def _scores(q, k, qi, ki, bq, bk, scale, causal):
    s = matmul_f32(q, k.transpose(-1, -2)) * scale          # (.., bq, bk)
    if causal:
        s = torch.where(_causal_mask(qi, ki, bq, bk, s.device), s, _NEG_INF)
    return s


# ------------------------------------------------------ plain versions
def flash_fwd_plain(q, k, v, *, scale: float, causal: bool,
                    block_q: int, block_k: int):
    """q, k, v [B, T, H, D] -> (out [B, T, H, D], lse fp32 [B, H, T])."""
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    b, h, t, d = qh.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    bq, bk = block_q, block_k
    for qi in range(t // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        m = torch.full((b, h, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for ki in range(t // bk):
            if not _visible(qi, ki, bq, bk, causal):
                continue
            cols = slice(ki * bk, (ki + 1) * bk)
            s = _scores(qh[:, :, rows], kh[:, :, cols], qi, ki, bq, bk,
                        scale, causal)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + matmul_f32(p.to(v.dtype), vh[:, :, cols])
            m = m_new
        inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
        _heads(out)[:, :, rows] = (acc * inv).to(out.dtype)
        lse[:, :, rows] = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0]
    return out, lse


def flash_dkv_plain(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                    block_q: int, block_k: int):
    """-> (dk, dv) [B, T, H, D]: per kv block, scan the q blocks."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    b, h, t, d = qh.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    bq, bk = block_q, block_k
    for ki in range(t // bk):
        cols = slice(ki * bk, (ki + 1) * bk)
        dk_acc = torch.zeros((b, h, bk, d), device=k.device)
        dv_acc = torch.zeros((b, h, bk, d), device=k.device)
        for qi in range(t // bq):
            if not _visible(qi, ki, bq, bk, causal):
                continue
            rows = slice(qi * bq, (qi + 1) * bq)
            s = _scores(qh[:, :, rows], kh[:, :, cols], qi, ki, bq, bk,
                        scale, causal)
            p = torch.exp(s - lse[:, :, rows, None])
            do_b = doh[:, :, rows]
            dv_acc = dv_acc + matmul_f32(p.to(do.dtype).transpose(-1, -2),
                                         do_b)
            dp = matmul_f32(do_b, vh[:, :, cols].transpose(-1, -2))
            ds = p * (dp - delta[:, :, rows, None])
            dk_acc = dk_acc + scale * matmul_f32(
                ds.to(q.dtype).transpose(-1, -2), qh[:, :, rows])
        _heads(dk)[:, :, cols] = dk_acc.to(dk.dtype)
        _heads(dv)[:, :, cols] = dv_acc.to(dv.dtype)
    return dk, dv


def flash_dq_plain(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                   block_q: int, block_k: int):
    """-> dq [B, T, H, D]: per q block, scan the kv blocks."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    b, h, t, d = qh.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    bq, bk = block_q, block_k
    for qi in range(t // bq):
        rows = slice(qi * bq, (qi + 1) * bq)
        dq_acc = torch.zeros((b, h, bq, d), device=q.device)
        for ki in range(t // bk):
            if not _visible(qi, ki, bq, bk, causal):
                continue
            cols = slice(ki * bk, (ki + 1) * bk)
            s = _scores(qh[:, :, rows], kh[:, :, cols], qi, ki, bq, bk,
                        scale, causal)
            p = torch.exp(s - lse[:, :, rows, None])
            dp = matmul_f32(doh[:, :, rows], vh[:, :, cols].transpose(-1, -2))
            ds = p * (dp - delta[:, :, rows, None])
            dq_acc = dq_acc + scale * matmul_f32(ds.to(k.dtype),
                                                 kh[:, :, cols])
        _heads(dq)[:, :, rows] = dq_acc.to(dq.dtype)
    return dq


# ------------------------------------------------------------ cost
def flash_cost(kernel: str, bh: int, t: int, d: int, causal: bool,
               itemsize: int = 2) -> Tuple[float, float]:
    """The work of one call of ``kernel`` ("flash_fwd", "flash_dkv" or
    "flash_dq") on B*H = ``bh`` heads of T = ``t`` rows and width ``d``:
    (FLOPs of its matrix products over the visible (q, k) pairs, bytes
    with each input read once and each output written once, elements
    of ``itemsize`` bytes and fp32 rows).  One formula for the xprof
    harvest (``_cost``) and the kernels' roofline bound in
    ``chip_smoke.py``."""
    pairs = t * (t + 1) // 2 if causal else t * t    # visible (q, k) pairs
    tile = bh * t * d * itemsize                     # one [BH, T, D]
    rows = bh * t * 4                                # one fp32 [BH, T]
    flops, nbytes = {
        "flash_fwd": (4 * d * pairs * bh, 4 * tile + rows),
        "flash_dkv": (8 * d * pairs * bh, 6 * tile + 2 * rows),
        "flash_dq": (6 * d * pairs * bh, 5 * tile + 2 * rows),
    }[kernel]
    return float(flops), float(nbytes)


def _cost(kernel: str, q: torch.Tensor, causal: bool):
    """Count one launch of ``kernel`` on ``q``'s shape in an xprof
    harvest, whichever route runs (the plain version's own ops are not
    counted)."""
    b, t, h, d = q.shape
    return xprof.kernel(kernel, *flash_cost(kernel, b * h, t, d, causal,
                                            q.element_size()))


# ------------------------------------------------ device dispatch
def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _flash_forward(q, k, v, *, scale, bq, bk, causal):
    with _cost("flash_fwd", q, causal):
        if _on_cpu(q):
            return flash_fwd_plain(q, k, v, scale=scale, causal=causal,
                                   block_q=bq, block_k=bk)
        return _kernels.flash_fwd(q, k, v, scale=scale, causal=causal)


def _flash_backward(res, do, *, scale, bq, bk, causal, dlse=None):
    q, k, v, out, lse = res
    # delta_i = rowsum(dO_i * O_i): a plain torch op, as it is an XLA
    # fusion outside the Pallas kernels in the JAX package.
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    if dlse is not None:
        # The lse output's cotangent enters dS = P * (dP - delta + dlse),
        # i.e. exactly like delta with the opposite sign.
        delta = delta - dlse.float()
    delta = delta.contiguous()
    do = do.contiguous()
    if _on_cpu(q):
        kw = dict(scale=scale, causal=causal, block_q=bq, block_k=bk)
        with _cost("flash_dkv", q, causal):
            dk, dv = flash_dkv_plain(q, k, v, do, lse, delta, **kw)
        with _cost("flash_dq", q, causal):
            dq = flash_dq_plain(q, k, v, do, lse, delta, **kw)
    else:
        with _cost("flash_dkv", q, causal):
            dk, dv = _kernels.flash_dkv(q, k, v, do, lse, delta,
                                        scale=scale, causal=causal)
        with _cost("flash_dq", q, causal):
            dq = _kernels.flash_dq(q, k, v, do, lse, delta, scale=scale,
                                   causal=causal)
    return dq, dk, dv


# ---------------------------------------------------------- public op
def _forward_saving(ctx, q, k, v, scale, bq, bk, causal):
    out, lse = _flash_forward(q, k, v, scale=scale, bq=bq, bk=bk,
                              causal=causal)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.opts = dict(scale=scale, bq=bq, bk=bk, causal=causal)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, bq, bk, causal):
        return _forward_saving(ctx, q, k, v, scale, bq, bk, causal)[0]

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_backward(ctx.saved_tensors, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None


class _FlashAttentionLse(torch.autograd.Function):
    """Same kernels; the row log-sum-exp is a differentiable output
    (ring attention merges partial outputs with lse-derived weights)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, bq, bk, causal):
        return _forward_saving(ctx, q, k, v, scale, bq, bk, causal)

    @staticmethod
    def backward(ctx, do, dlse):
        dq, dk, dv = _flash_backward(ctx.saved_tensors, do, dlse=dlse,
                                     **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _blocks(t: int, block_q: int, block_k: int):
    block_q, block_k = min(block_q, t), min(block_k, t)
    if t % block_q or t % block_k:
        raise ValueError(f"seq len {t} must divide block sizes "
                         f"({block_q}, {block_k})")
    return block_q, block_k


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             block_q: int = 256, block_k: int = 256):
    """Flash attention that also returns the row log-sum-exp.

    q, k, v: [B, T, H, D] -> (out [B, T, H, D], lse [B, T, H] fp32).
    The lse output is differentiable (its cotangent folds into the
    backward's delta term)."""
    _b, t, _h, d = q.shape
    bq, bk = _blocks(t, block_q, block_k)
    out, lse = _FlashAttentionLse.apply(q, k, v, d ** -0.5, bq, bk, causal)
    return out, lse.transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: int = 256, block_k: int = 256):
    """Causal flash attention.  q, k, v: [B, T, H, D] -> [B, T, H, D].

    Block sizes must keep T % block == 0."""
    _b, t, _h, d = q.shape
    bq, bk = _blocks(t, block_q, block_k)
    return _FlashAttention.apply(q, k, v, d ** -0.5, bq, bk, causal)
