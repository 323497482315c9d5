"""Llama in PyTorch: counterpart of ``ray_tpu/models/llama.py``.

RMSNorm + RoPE + GQA + SwiGLU decoder with the flax model's parameter
names, layouts and numerics, so converted weights give the same logits
and loss (the conventions of ``gpt2.py`` apply: float32 parameters cast
to ``cfg.dtype`` where they are used, ``Dense`` kernels [in, out], the
float32-result logits through ``matmul_f32``):

- ``embed`` [V, D], per layer ``layer_{i}`` with ``attn_norm``, the
  bias-free ``wq``/``wk``/``wv``/``wo``, ``mlp_norm`` and the bias-free
  ``w_gate``/``w_up``/``w_down``, then ``norm_f`` and an untied
  ``lm_head`` [D, V];
- RMSNorm in float32, eps ``cfg.rms_eps``, no bias, result cast back;
- RoPE rotates the two halves of each head (not interleaved pairs), in
  float32, from cached numpy tables in the full forward and from angles
  computed on the device at the given positions in decode mode;
- the KV heads repeat to the query heads (``repeat_interleave``, the
  order of ``jnp.repeat``) before attention in the full forward and at
  attend time in decode mode, so the paged cache stores n_kv_head heads.

Sharded runs (``mesh``/``rules``, ring and Ulysses attention) work as in
``gpt2.py``: the same ``_constrain`` points as the JAX model, and ring
or Ulysses attention on the repeated K/V heads, as the JAX model feeds
them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.matmul import matmul_f32
from ..parallel.sharding import replicate_like
from .gpt2 import Dense, _attention, _constrain, _embed


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 8
    n_head: int = 8
    n_kv_head: int = 4
    d_model: int = 512
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attn_impl: str = "dense"          # dense | ring | ulysses
    remat: bool = True
    mesh: Any = None                  # DeviceMesh for sharded runs
    rules: Any = None                 # ShardingRules override

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, n_layer=2, n_head=4, n_kv_head=2,
                           d_model=128, d_ff=384, max_seq=128)

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig(vocab_size=32000, n_layer=32, n_head=32,
                           n_kv_head=32, d_model=4096, d_ff=11008,
                           max_seq=4096)

    def flops_per_token(self) -> float:
        head_dim = self.d_model // self.n_head
        n_params = (self.vocab_size * self.d_model * 2
                    + self.n_layer * (
                        self.d_model * self.d_model            # q
                        + 2 * self.d_model * self.n_kv_head * head_dim
                        + self.d_model * self.d_model          # o
                        + 3 * self.d_model * self.d_ff))
        attn = 6 * 2 * self.n_layer * self.d_model * self.max_seq
        return 6.0 * n_params + attn

    def decode_flops_per_token(self,
                               context_len: Optional[int] = None) -> float:
        """FLOPs to decode one token with a KV cache at ``context_len``
        (default max_seq/2): 2 per matmul weight (forward only, lm_head
        but not the embedding lookup) plus reading the cached K/V once
        per layer over all n_head query heads (GQA shrinks the cache,
        not the attention arithmetic)."""
        head_dim = self.d_model // self.n_head
        ctx = self.max_seq // 2 if context_len is None else context_len
        matmul_params = (self.vocab_size * self.d_model   # lm_head only
                         + self.n_layer * (
                             self.d_model * self.d_model
                             + 2 * self.d_model * self.n_kv_head * head_dim
                             + self.d_model * self.d_model
                             + 3 * self.d_model * self.d_ff))
        attn = 4 * self.n_layer * self.d_model * ctx
        return 2.0 * matmul_params + attn


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.attn_impl not in ("dense", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


@functools.lru_cache(maxsize=64)
def _rope_tables(seq_len: int, head_dim: int, theta: float):
    """([T, D/2] cos, [T, D/2] sin) in float32, cached per shape: every
    block of every full forward shares one host table.  numpy, so the
    cached value is never tied to a device."""
    half = head_dim // 2
    freqs = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    angles = np.arange(seq_len, dtype=np.float32)[:, None] * freqs[None, :]
    return np.cos(angles), np.sin(angles)


def _rope(x, theta: float, positions=None):
    """Rotary embedding over [B, T, H, D] (D even), computed in float32
    and cast back to x's dtype.  ``positions`` ([B, T] absolute,
    negative = padding) selects per-token angles, computed on x's device
    (decode path); None means contiguous 0..T-1 from the cached
    tables."""
    b, t, h, d = x.shape
    half = d // 2
    if positions is None:
        cos, sin = (replicate_like(x, torch.from_numpy(a).to(x.device)[
            None, :, None, :]) for a in _rope_tables(t, d, theta))
    else:
        pos = positions.clamp(min=0).float()
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half)
        angles = pos[..., None] * freqs                 # [B, T, half]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """flax-side ``RMSNorm``: float32 ``scale``, statistics in float32,
    no bias, result cast to ``dtype``."""

    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x):
        x32 = x.float()
        norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True)
                                 + self.eps)
        return (norm * self.scale).to(self.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        kv = cfg.n_kv_head * (d // cfg.n_head)
        self.attn_norm = RMSNorm(d, cfg.rms_eps, dt, device)
        self.wq = Dense(d, d, dt, device, use_bias=False)
        self.wk = Dense(d, kv, dt, device, use_bias=False)
        self.wv = Dense(d, kv, dt, device, use_bias=False)
        self.wo = Dense(d, d, dt, device, use_bias=False)
        self.mlp_norm = RMSNorm(d, cfg.rms_eps, dt, device)
        self.w_gate = Dense(d, cfg.d_ff, dt, device, use_bias=False)
        self.w_up = Dense(d, cfg.d_ff, dt, device, use_bias=False)
        self.w_down = Dense(cfg.d_ff, d, dt, device, use_bias=False)

    def forward(self, x, cache=None):
        """x [B, T, D] -> [B, T, D]; in decode mode (``cache``: this
        layer's entry of ``llm.kv_cache.layer_caches``) -> (out,
        (k_pages, v_pages))."""
        cfg = self.cfg
        h, hk = cfg.n_head, cfg.n_kv_head
        d_head = cfg.d_model // h
        b, t = x.shape[0], x.shape[1]
        y = self.attn_norm(x)
        q = self.wq(y).reshape(b, t, h, d_head)
        k = self.wk(y).reshape(b, t, hk, d_head)
        v = self.wv(y).reshape(b, t, hk, d_head)
        positions = None if cache is None else cache["positions"]
        q = _rope(q, cfg.rope_theta, positions)
        k = _rope(k, cfg.rope_theta, positions)
        if cache is not None:
            # The cache stores the hk grouped heads (after RoPE); the
            # repeat to h happens at attend time.
            from ..llm.kv_cache import cached_attention
            att, pages = cached_attention(q, k, v, cache)
        else:
            if hk != h:
                # jnp.repeat's order: each KV head h // hk times in a row.
                k, v = (z.unsqueeze(3).expand(b, t, hk, h // hk, d_head)
                        .reshape(b, t, h, d_head) for z in (k, v))
            q, k, v = (_constrain(z, ("batch", "seq", "heads", None), cfg)
                       for z in (q, k, v))
            att = _attention(cfg, q, k, v)   # gpt2's, same numerics
        x = x + self.wo(att.reshape(b, t, cfg.d_model))
        y = self.mlp_norm(x)
        z = _constrain(F.silu(self.w_gate(y)) * self.w_up(y),
                       ("batch", "seq", "mlp"), cfg)
        out = x + self.w_down(z)
        return out if cache is None else (out, pages)


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=device))
        for i in range(cfg.n_layer):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, device))
        self.norm_f = RMSNorm(cfg.d_model, cfg.rms_eps, cfg.dtype, device)
        self.lm_head = nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device))

    def blocks(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, tokens, kv_cache=None, positions=None):
        """Full forward (tokens [B, T] -> logits [B, T, V] float32) or,
        with ``kv_cache``, one incremental step against the paged pool,
        with ``GPT2.forward``'s contract: (logits, kv_cache)."""
        cfg = self.cfg
        decode = kv_cache is not None
        x = _constrain(_embed(tokens, self.embed).to(cfg.dtype),
                       ("batch", "seq", "embed"), cfg)
        caches = None
        if decode:
            from ..llm.kv_cache import layer_caches
            caches = layer_caches(kv_cache, positions)
        remat = cfg.remat and torch.is_grad_enabled() and not decode
        for i, blk in enumerate(self.blocks()):
            if decode:
                x, _ = blk(x, cache=caches[i])
            elif remat:
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
            x = _constrain(x, ("batch", "seq", "embed"), cfg)
        x = self.norm_f(x)
        logits = _constrain(matmul_f32(x, self.lm_head.to(cfg.dtype)),
                            ("batch", "seq", "vocab"), cfg)
        return (logits, kv_cache) if decode else logits


def llama_init(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Llama:
    """A Llama with the JAX model's initializers: normal(0.02) for
    ``embed``, ``lm_head`` and every projection kernel, unit norm
    scales.  ``generator`` must live on ``device`` (default: seed 0)."""
    device = resolve_device(device)
    model = Llama(cfg, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.02, generator=generator)
        for blk in model.blocks():
            for dense in (blk.wq, blk.wk, blk.wv, blk.wo, blk.w_gate,
                          blk.w_up, blk.w_down):
                dense.kernel.normal_(0.0, 0.02, generator=generator)
        model.lm_head.normal_(0.0, 0.02, generator=generator)
    return model


def llama_loss_fn(cfg: LlamaConfig, model: Llama, batch) -> torch.Tensor:
    """Next-token cross entropy; batch: {"tokens": [B, T+1] ints}."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    logp = torch.log_softmax(model(inputs).float(), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


def llama_partition_rules():
    """Default fsdp+tensor partition rules for Llama parameter trees
    (``match_partition_rules`` form; see ``gpt2_partition_rules``)."""
    from ..parallel.sharding import PartitionSpec as PS

    return (
        ("embed$", PS("tensor", "fsdp")),
        ("lm_head$", PS("fsdp", "tensor")),
        (r"w[qkv]/kernel$", PS("fsdp", "tensor")),
        (r"wo/kernel$", PS("tensor", "fsdp")),
        (r"(w_gate|w_up)/kernel$", PS("fsdp", "tensor")),
        (r"w_down/kernel$", PS("tensor", "fsdp")),
        (r"(scale|bias)$", PS()),
    )


def llama_param_axes(path: str, leaf) -> Tuple[Optional[str], ...]:
    """Logical axes per parameter path (see ``gpt2_param_axes``)."""
    if "embed" in path and leaf.ndim == 2:
        return ("vocab", "embed_fsdp")
    if "lm_head" in path:
        return ("embed_fsdp", "vocab")
    if leaf.ndim == 1:
        return (None,)
    if any(k in path for k in ("wq", "wk", "wv")):
        return ("embed_fsdp", "heads")
    if "wo" in path:
        return ("heads", "embed_fsdp")
    if any(k in path for k in ("w_gate", "w_up")):
        return ("embed_fsdp", "mlp")
    if "w_down" in path:
        return ("mlp", "embed_fsdp")
    return (None,) * leaf.ndim
