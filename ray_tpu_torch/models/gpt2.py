"""GPT-2 in PyTorch — counterpart of ``ray_tpu/models/gpt2.py``.

Same configuration, parameter names and numerics as the flax model, so
converted weights give the same logits and loss:

- parameters are float32 and are cast to ``cfg.dtype`` where they are
  used (``wte``/``wpe`` at the lookup, each ``Dense`` kernel and bias at
  its product), as flax does with ``param_dtype=float32``;
- ``Dense`` kernels are ``[in, out]`` and keep flax's names, so
  ``h_0/c_attn/kernel`` is ``h_0.c_attn.kernel`` here and conversion is
  a flattening of paths (``convert.py``);
- ``LayerNorm`` is flax's: eps 1e-6, float32 statistics with the fast
  variance E[x^2] - E[x]^2 even under a bf16 dtype, result cast back;
- GELU is the tanh approximation (``nn.gelu``'s default);
- the qkv split is q|k|v along the last axis, each reshaped (b, t, h, d);
- the tied logits and the cross-entropy products that JAX runs with
  ``preferred_element_type=float32`` go through ``matmul_f32``: the
  bf16 operands are upcast, so products are exact and sums float32, the
  JAX semantics.  The cost is TF32 tensor-core time on float32 copies
  of the operands instead of bf16 products (``ops/matmul.py``).

Decode mode (``kv_cache``/``positions``) writes each layer's K/V into
the paged pool and attends against it (``llm/kv_cache.py``), as the JAX
model does; the pool is updated in place and returned, not stacked anew.

Sharded runs (``mesh``: a ``DeviceMesh`` from ``parallel.mesh``,
``rules``: ``ShardingRules``) take DTensor parameters placed by
``train_step.shard_state``.  As in the JAX model, activations are
constrained to their logical axes after the embedding, around attention,
in the MLP and after each block (``_constrain``); DTensor's sharding
propagation inserts the collectives that GSPMD inserts in JAX.  Ring and
Ulysses attention run on the local shards under ``local_map`` (JAX's
``shard_map``).

MoE configs (``moe_num_experts > 0``) put an ``ops.moe.MoEMLP`` in
every ``moe_every``-th block in place of its MLP; the loss adds
``moe_aux_weight`` times the blocks' Switch auxiliary losses.  Sharded,
the experts split over the ``expert`` axis (``ops/moe.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.matmul import matmul_f32


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    attn_impl: str = "dense"          # dense | flash | ring | ulysses
    remat: bool = True
    mesh: Any = None                  # DeviceMesh for sharded runs
    rules: Any = None                 # ShardingRules override
    moe_num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                          d_ff=512, max_seq=128)

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config(n_layer=24, n_head=16, d_model=1024, d_ff=4096)

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd ≈ 6N + attn)."""
        n_params = (self.vocab_size * self.d_model
                    + self.max_seq * self.d_model
                    + self.n_layer * (4 * self.d_model ** 2
                                      + 2 * self.d_model * self.d_ff))
        attn = 6 * 2 * self.n_layer * self.d_model * self.max_seq
        return 6.0 * n_params + attn

    def decode_flops_per_token(self,
                               context_len: Optional[int] = None) -> float:
        """FLOPs to decode one token with a KV cache at ``context_len``
        (default max_seq/2): 2 per matmul weight (forward only) plus
        reading the cached K/V once per layer.  Lookups are gathers, so
        only the tied unembedding counts for wte."""
        ctx = self.max_seq // 2 if context_len is None else context_len
        matmul_params = (self.vocab_size * self.d_model
                         + self.n_layer * (4 * self.d_model ** 2
                                           + 2 * self.d_model * self.d_ff))
        attn = 4 * self.n_layer * self.d_model * ctx
        return 2.0 * matmul_params + attn


def _check_supported(cfg: GPT2Config) -> None:
    if cfg.attn_impl not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _uses_moe(cfg: GPT2Config, i: int) -> bool:
    return cfg.moe_num_experts > 0 and i % cfg.moe_every == cfg.moe_every - 1


def _constrain(x, logical, cfg):
    """Redistribute ``x`` to its logical axes under ``cfg.mesh``."""
    if cfg.mesh is None:
        return x
    from ..parallel.sharding import ShardingRules, with_logical_constraint

    return with_logical_constraint(x, logical, cfg.mesh,
                                   cfg.rules or ShardingRules())


def _embed(tokens, table):
    """``table[tokens]``.  A sharded table is gathered first: DTensor's
    lookup into a table sharded on its vocab rows fails when the tokens
    are sharded on another mesh axis (its masked partial result does
    not fit the token shard)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(table, DTensor):
        table = table.redistribute(
            table.device_mesh, [Replicate()] * table.device_mesh.ndim)
    return F.embedding(tokens, table)


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel [in, out] and bias in float32, both cast
    with the input to ``dtype`` for the product (no bias with
    ``use_bias=False``)."""

    def __init__(self, d_in: int, d_out: int, dtype, device,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device)) \
            if use_bias else None

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.kernel.to(dt).t(), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: float32 statistics, fast
    variance clipped at 0, eps 1e-6, result cast to ``dtype``."""

    eps = 1e-6

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def _attention(cfg, q, k, v):
    """q, k, v: [B, T, H, D] -> [B, T, H, D]."""
    if cfg.attn_impl == "flash":
        from ..ops.flash_attention import flash_attention

        # The JAX model asks for whole-sequence blocks; on the card the
        # blocks only validate T (the kernels tile by 64 rows).
        return flash_attention(q, k, v, causal=True,
                               block_q=1024, block_k=1024)
    if cfg.attn_impl == "dense":
        from ..parallel.sharding import replicate_like

        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        scores = matmul_f32(qh, kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
        t = q.shape[1]
        mask = replicate_like(scores, torch.ones(
            t, t, dtype=torch.bool, device=scores.device).tril())
        scores = torch.where(mask, scores, -1e30)
        p = torch.softmax(scores, dim=-1).to(cfg.dtype)
        return torch.matmul(p, vh).transpose(1, 2)
    import functools

    from ..parallel.ring_attention import local_attention, ring_attention
    from ..parallel.sharding import PartitionSpec
    from ..parallel.ulysses import ulysses_attention

    if cfg.mesh is None:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} needs cfg.mesh")
    inner = (ring_attention if cfg.attn_impl == "ring"
             else ulysses_attention)
    spec = PartitionSpec(("data", "fsdp"), "seq", None, None)
    return local_attention(cfg.mesh, spec, functools.partial(
        inner, group=cfg.mesh.get_group("seq"), causal=True), q, k, v)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device, use_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        d, dt = cfg.d_model, cfg.dtype
        self.ln_1 = LayerNorm(d, dt, device)
        self.c_attn = Dense(d, 3 * d, dt, device)
        self.c_proj = Dense(d, d, dt, device)
        self.ln_2 = LayerNorm(d, dt, device)
        if use_moe:
            from ..ops.moe import MoEMLP

            self.moe_mlp = MoEMLP(d, cfg.d_ff, cfg.moe_num_experts,
                                  top_k=cfg.moe_top_k,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  dtype=dt, device=device, mesh=cfg.mesh)
        else:
            self.mlp_in = Dense(d, cfg.d_ff, dt, device)
            self.mlp_out = Dense(cfg.d_ff, d, dt, device)

    def forward(self, x, cache=None):
        """x [B, T, D] -> [B, T, D], or (out, aux) for an MoE block; in
        decode mode (``cache``: this layer's entry of
        ``llm.kv_cache.layer_caches``) -> (out, (k_pages, v_pages))."""
        cfg = self.cfg
        h = cfg.n_head
        d_head = cfg.d_model // h
        b, t = x.shape[0], x.shape[1]
        qkv = self.c_attn(self.ln_1(x))
        q, k, v = (z.unflatten(-1, (h, d_head))
                   for z in qkv.split(cfg.d_model, dim=-1))
        if cache is not None:
            # Prefill and single-token decode take the same path: write
            # this step's K/V into the pool, attend against the history.
            from ..llm.kv_cache import cached_attention
            att, pages = cached_attention(q, k, v, cache)
        else:
            q, k, v = (_constrain(z, ("batch", "seq", "heads", None), cfg)
                       for z in (q, k, v))
            att = _attention(cfg, q, k, v)
        x = x + self.c_proj(att.reshape(b, t, cfg.d_model))
        if self.use_moe:
            y, aux = self.moe_mlp(self.ln_2(x))
            out = x + y
            return (out, aux) if cache is None else (out, pages)
        y = _constrain(self.mlp_in(self.ln_2(x)), ("batch", "seq", "mlp"),
                       cfg)
        out = x + self.mlp_out(F.gelu(y, approximate="tanh"))
        return out if cache is None else (out, pages)


class GPT2(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, device=device))
        self.wpe = nn.Parameter(
            torch.empty(cfg.max_seq, cfg.d_model, device=device))
        for i in range(cfg.n_layer):
            self.add_module(f"h_{i}", Block(cfg, device, _uses_moe(cfg, i)))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, device)

    def blocks(self):
        return [getattr(self, f"h_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, tokens, return_hidden: bool = False,
                kv_cache=None, positions=None, return_aux: bool = False):
        """tokens [B, T] -> logits [B, T, V] float32 (or the final hidden
        state [B, T, D] in ``cfg.dtype`` with ``return_hidden``); with
        ``return_aux``, (that, the MoE blocks' summed auxiliary loss, 0
        without MoE blocks), what the JAX model sows.

        Decode mode attends against the paged KV pool instead of
        recomputing the sequence: ``kv_cache`` is {"k_pages",
        "v_pages": [L, pages, page, h, d], "page_table": [B, P]} and
        ``positions`` [B, T] gives each new token's absolute position
        (negative = padding).  It returns (logits, kv_cache), the pool
        tensors written in place."""
        cfg = self.cfg
        decode = kv_cache is not None
        wte = self.wte.to(cfg.dtype)
        if decode:
            from ..llm.kv_cache import layer_caches
            x = F.embedding(tokens, wte) + \
                self.wpe[positions.clamp(min=0)].to(cfg.dtype)
            caches = layer_caches(kv_cache, positions)
        else:
            x = _embed(tokens, wte) + self.wpe[:tokens.shape[1]].to(cfg.dtype)
        x = _constrain(x, ("batch", "seq", "embed"), cfg)
        # Decode steps are memory-light; remat would only slow them.
        remat = cfg.remat and torch.is_grad_enabled() and not decode
        auxes = []
        for i, blk in enumerate(self.blocks()):
            if decode:
                x, _ = blk(x, cache=caches[i])
            elif remat:
                # The block's forward (flash attention included) runs
                # again in the backward.
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
            if blk.use_moe and not decode:
                x, aux = x
                auxes.append(aux)
            x = _constrain(x, ("batch", "seq", "embed"), cfg)
        x = self.ln_f(x)
        if not return_hidden:
            x = _constrain(matmul_f32(x, wte.t()), ("batch", "seq", "vocab"),
                           cfg)
            if decode:
                return x, kv_cache
        if not return_aux:
            return x
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return x, sum(auxes[1:], auxes[0]) if auxes else aux


def gpt2_init(cfg: GPT2Config, generator: Optional[torch.Generator] = None,
              device=None) -> GPT2:
    """A GPT2 with the JAX model's initializers: normal(0.02) for wte and
    the input projections, normal(0.02 / sqrt(2 L)) for the residual
    output projections, normal(0.01) for wpe, zero biases, unit norm
    scales.  ``generator`` must live on ``device`` (default: seed 0)."""
    device = resolve_device(device)
    model = GPT2(cfg, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    resid = 0.02 / math.sqrt(2 * cfg.n_layer)
    with torch.no_grad():
        model.wte.normal_(0.0, 0.02, generator=generator)
        model.wpe.normal_(0.0, 0.01, generator=generator)
        for blk in model.blocks():
            blk.c_attn.kernel.normal_(0.0, 0.02, generator=generator)
            blk.c_proj.kernel.normal_(0.0, resid, generator=generator)
            if blk.use_moe:
                blk.moe_mlp.reset_parameters(generator)
            else:
                blk.mlp_in.kernel.normal_(0.0, 0.02, generator=generator)
                blk.mlp_out.kernel.normal_(0.0, resid, generator=generator)
    return model


class _ChunkedXent(torch.autograd.Function):
    """Fused chunked cross entropy: never holds the [B, T, V] logits.

    Forward walks sequence chunks and saves only each row's
    log-sum-exp; backward recomputes each chunk's logits once and folds
    softmax-minus-onehot straight into the dX and dWte products."""

    @staticmethod
    def forward(ctx, x, wte, targets, chunk):
        b, t, _d = x.shape
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for c in range(t // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            logits = matmul_f32(x[:, sl], wte.t())             # [b, c, V]
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, targets[:, sl, None])[..., 0]
            total = total + (lse - tgt).sum()
            lses.append(lse)
        ctx.save_for_backward(x, wte, targets, torch.stack(lses))
        ctx.chunk = chunk
        return total / (b * t)

    @staticmethod
    def backward(ctx, g):
        x, wte, targets, lses = ctx.saved_tensors
        chunk = ctx.chunk
        b, t, d = x.shape
        scale = g / (b * t)
        dx = torch.empty_like(x)
        # float32 accumulator: bf16 chunk-wise accumulation would
        # compound rounding across T/chunk steps.
        dw = torch.zeros(wte.shape, dtype=torch.float32, device=x.device)
        for c in range(t // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            xc = x[:, sl]
            p = matmul_f32(xc, wte.t())
            p.sub_(lses[c][..., None]).exp_()                  # softmax
            p.scatter_add_(-1, targets[:, sl, None],
                           torch.full_like(p[..., :1], -1.0))  # - onehot
            dl = (p * scale).to(x.dtype)
            dx[:, sl] = torch.matmul(dl, wte)
            dw += matmul_f32(dl.reshape(-1, dl.shape[-1]).t(),
                             xc.reshape(-1, d))
        return dx, dw.to(wte.dtype), None, None


def chunked_xent(x, wte, targets, chunk: int):
    """Mean next-token cross entropy of ``x @ wte.T`` against
    ``targets``, computed ``chunk`` positions at a time."""
    return _ChunkedXent.apply(x, wte, targets.long(), chunk)


def gpt2_loss_fn(cfg: GPT2Config, model: GPT2, batch,
                 loss_chunk: int = 128) -> torch.Tensor:
    """Next-token cross entropy; batch: {"tokens": [B, T+1] ints}.
    Under a mesh the logits stay whole (the chunked loss is for one
    device), as in the JAX model.  MoE configs add ``moe_aux_weight``
    times the Switch auxiliary loss and keep the logits whole too."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    t = inputs.shape[1]
    moe = cfg.moe_num_experts > 0
    if loss_chunk and t % loss_chunk == 0 and t > loss_chunk \
            and cfg.mesh is None and not moe:
        x = model(inputs, return_hidden=True)
        return chunked_xent(x, model.wte.to(cfg.dtype), targets, loss_chunk)
    logits, aux = model(inputs, return_aux=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, targets[..., None])[..., 0].mean()
    return loss + cfg.moe_aux_weight * aux if moe else loss


def gpt2_partition_rules():
    """Default fsdp+tensor(+expert) partition rules for GPT-2 parameter
    trees, in ``match_partition_rules`` form ((regex, PartitionSpec)
    pairs, first match wins), over flax's slash-joined paths."""
    from ..parallel.sharding import PartitionSpec as PS

    return (
        ("wte$", PS("tensor", "fsdp")),
        ("wpe$", PS()),
        (r"c_attn/kernel$", PS("fsdp", "tensor")),
        (r"c_proj/kernel$", PS("tensor", "fsdp")),
        (r"mlp_in/kernel$", PS("fsdp", "tensor")),
        (r"mlp_out/kernel$", PS("tensor", "fsdp")),
        (r"moe_mlp/w_in$", PS("expert", "fsdp", "tensor")),
        (r"moe_mlp/w_out$", PS("expert", "tensor", "fsdp")),
        (r"moe_mlp/router$", PS("fsdp", None)),
        (r"(bias|scale)$", PS()),
    )


def gpt2_param_axes(path: str, leaf) -> Tuple[Optional[str], ...]:
    """Logical axes per parameter path, for ``shard_pytree`` and
    ``train_step.shard_state`` (DP/FSDP/TP/EP)."""
    from ..ops.moe import moe_param_axes

    moe = moe_param_axes(path, leaf)
    if moe is not None:
        return moe
    if "wte" in path:
        return ("vocab", "embed_fsdp")
    if "wpe" in path:
        return (None, None)
    if leaf.ndim == 1:
        return (None,)
    if "c_attn" in path:
        return ("embed_fsdp", "heads")
    if "c_proj" in path:
        return ("heads", "embed_fsdp")
    if "mlp_in" in path:
        return ("embed_fsdp", "mlp")
    if "mlp_out" in path:
        return ("mlp", "embed_fsdp")
    return (None,) * leaf.ndim
