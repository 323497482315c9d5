"""GPT-2 in plain float32 PyTorch: the reference of the GPT-2 cells.

It follows Radford et al. (2019) and the published ``config.json``
(pre-LayerNorm blocks, learned positions, a fused q|k|v projection,
tanh GELU, tied unembedding), with the LayerNorm epsilon of the
configuration file.  It imports nothing of the program: it takes the
parameters as a dict of tensors under the program's state_dict names
(projection matrices ``[in, out]``) and works everything out from them.

``precision`` selects how the products are computed:

- ``"fp32"``: float32 with TF32 off (``exact_float32``), the reference;
- ``"fp8"``: each product's operands rounded to float8 e4m3 with a
  per-tensor scale, and the gradient entering a product's backward to
  e5m2, then multiplied in float32;
- ``"int8"``: the same with symmetric per-tensor int8 for operands and
  gradients;
- ``"fp8_bf16"``: the float8 products of ``"fp8"`` inside the program's
  own bfloat16: every activation that the program keeps in bfloat16
  (embeddings, LayerNorm outputs, products, attention probabilities,
  GELU, the residual stream) rounded to it, and so is the gradient that
  flows back into each, as the program's autograd keeps it.

All three are below the bfloat16 that the configurations state: the
controls that a cell's comparison has to reject.

Training follows optax's ``clip_by_global_norm`` then ``adamw`` (decay
on every parameter, learning rate read at the count before the update,
warmup-cosine schedule).  Gradients are summed over blocks of rows, so
a batch of any size fits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


def exact_float32() -> None:
    """Products in full float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ----------------------------------------------------------- products
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to an 8-bit format with one scale for the tensor:
    float8 ``e4m3`` or ``e5m2``, or symmetric ``int8``."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    if fmt == "int8":
        scale = 127.0 / amax
        return torch.round(x * scale).clamp(-127, 127) / scale
    dtype, fmax = {"e4m3": (torch.float8_e4m3fn, _E4M3_MAX),
                   "e5m2": (torch.float8_e5m2, _E5M2_MAX)}[fmt]
    scale = fmax / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


# precision -> (format of a product's operands, of the gradient entering
# its backward)
_FORMATS = {"fp8": ("e4m3", "e5m2"), "int8": ("int8", "int8"),
            "fp8_bf16": ("e4m3", "e5m2")}
# precisions whose activations, and the gradients into them, are bfloat16
_BF16_STORED = {"fp8_bf16"}


class _LowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fmts):
        qa, qb = _round(a, fmts[0]), _round(b, fmts[0])
        ctx.save_for_backward(qa, qb)
        ctx.grad_fmt = fmts[1]
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, ctx.grad_fmt)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg, None


class _Bf16(torch.autograd.Function):
    """Identity that rounds the value, and the gradient into it, to
    bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


def store(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as the program keeps an activation under ``precision``."""
    return _Bf16.apply(x) if precision in _BF16_STORED else x


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return a @ b
    if precision in _FORMATS:
        return _LowMatmul.apply(a, b, _FORMATS[precision])
    raise ValueError(f"unknown precision {precision!r}")


# ------------------------------------------------------------ forward
def layer_norm(x, scale, bias, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _block(x, p: Params, i: int, cfg: dict, precision: str):
    pre = f"h_{i}."
    eps = cfg["layer_norm_epsilon"]
    b, t, d = x.shape
    h = cfg["n_head"]
    dh = d // h

    def s(z):
        return store(z, precision)

    y = s(layer_norm(x, p[pre + "ln_1.scale"], p[pre + "ln_1.bias"], eps))
    qkv = s(matmul(y, p[pre + "c_attn.kernel"], precision)
            + p[pre + "c_attn.bias"])
    q, k, v = (z.reshape(b, t, h, dh).transpose(1, 2)
               for z in qkv.split(d, dim=-1))
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    att = s(matmul(s(torch.softmax(scores, dim=-1)), v, precision))
    att = att.transpose(1, 2).reshape(b, t, d)
    x = s(x + s(matmul(att, p[pre + "c_proj.kernel"], precision)
                + p[pre + "c_proj.bias"]))
    y = s(layer_norm(x, p[pre + "ln_2.scale"], p[pre + "ln_2.bias"], eps))
    y = s(gelu(s(matmul(y, p[pre + "mlp_in.kernel"], precision)
                 + p[pre + "mlp_in.bias"])))
    return s(x + s(matmul(y, p[pre + "mlp_out.kernel"], precision)
                   + p[pre + "mlp_out.bias"]))


def hidden(p: Params, tokens: torch.Tensor, cfg: dict,
           precision: str = "fp32") -> torch.Tensor:
    """tokens [B, T] -> the final LayerNorm's output [B, T, D]."""
    t = tokens.shape[1]
    x = store(store(p["wte"][tokens], precision)
              + store(p["wpe"][:t], precision), precision)
    for i in range(cfg["n_layer"]):
        x = _block(x, p, i, cfg, precision)
    return store(layer_norm(x, p["ln_f.scale"], p["ln_f.bias"],
                            cfg["layer_norm_epsilon"]), precision)


def logits_at(p: Params, tokens: torch.Tensor, rows: torch.Tensor,
              cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """The logits [len(rows), V] of one sequence ``tokens`` [T] at the
    positions ``rows``."""
    x = hidden(p, tokens[None], cfg, precision)[0, rows]
    return matmul(x, p["wte"].t(), precision)


def loss_sum(p: Params, tokens: torch.Tensor, cfg: dict,
             precision: str = "fp32") -> torch.Tensor:
    """Summed next-token cross entropy of tokens [B, T+1]."""
    x = hidden(p, tokens[:, :-1], cfg, precision)
    logits = matmul(x, p["wte"].t(), precision)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None]).sum()


def loss_and_grads(p: Params, tokens: torch.Tensor, cfg: dict,
                   rows: int, precision: str = "fp32"
                   ) -> Tuple[float, Params]:
    """The mean loss of tokens [B, T+1] and its gradient, summed over
    blocks of ``rows`` rows."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    n = tokens.shape[0] * (tokens.shape[1] - 1)
    total = 0.0
    for r in range(0, tokens.shape[0], rows):
        loss = loss_sum(leaves, tokens[r:r + rows], cfg, precision) / n
        loss.backward()
        total += float(loss.detach())
        del loss
    return total, {k: v.grad for k, v in leaves.items()}


# ---------------------------------------------------------- optimizer
def warmup_cosine(init: float, peak: float, warmup: int, decay: int,
                  end: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup, then cosine
    to ``end`` at ``decay`` steps, the warmup counted inside."""
    alpha = 0.0 if peak == 0.0 else end / peak

    def lr(count: int) -> float:
        if count < warmup:
            return init + (peak - init) * count / warmup
        c = min(count - warmup, decay - warmup)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / (decay - warmup)))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return lr


class AdamW:
    """Global-norm clip, then AdamW (eps outside the square root)."""

    def __init__(self, opt: dict):
        self.lr = warmup_cosine(
            0.0, opt["learning_rate"], opt["warmup_steps"],
            max(opt["total_steps"], opt["warmup_steps"] + 1),
            0.1 * opt["learning_rate"])
        self.clip = opt["grad_clip"]
        self.b1, self.b2 = opt["b1"], opt["b2"]
        self.eps, self.wd = opt["eps"], opt["weight_decay"]
        self.count = 0
        self.mu: Params = {}
        self.nu: Params = {}

    @torch.no_grad()
    def update(self, p: Params, g: Params,
               on_clipped: Optional[Callable[[str, torch.Tensor], None]]
               = None) -> None:
        """Update ``p`` in place, each gradient clipped first (and handed
        to ``on_clipped`` with its name, where given)."""
        norm = math.sqrt(sum(float((v * v).sum()) for v in g.values()))
        scale = 1.0 if norm < self.clip else self.clip / norm
        lr = self.lr(self.count)
        self.count += 1
        for k in p:
            gk = g[k] * scale
            if on_clipped is not None:
                on_clipped(k, gk)
            mu = self.mu.get(k, torch.zeros_like(gk)) * self.b1 \
                + (1 - self.b1) * gk
            nu = self.nu.get(k, torch.zeros_like(gk)) * self.b2 \
                + (1 - self.b2) * gk * gk
            self.mu[k], self.nu[k] = mu, nu
            mhat = mu / (1 - self.b1 ** self.count)
            vhat = nu / (1 - self.b2 ** self.count)
            p[k] -= lr * (mhat / (torch.sqrt(vhat) + self.eps)
                          + self.wd * p[k])


def train(p: Params, batches: Sequence[torch.Tensor], cfg: dict, opt: dict,
          rows: int, precision: str = "fp32",
          on_first: Optional[Callable[[str, torch.Tensor], None]] = None
          ) -> List[float]:
    """Steps over ``batches`` from the parameters ``p`` (updated in
    place); each step's loss.  ``on_first`` sees every parameter's first
    gradient as the optimizer takes it (clipped)."""
    adam = AdamW(opt)
    losses: List[float] = []
    for i, tokens in enumerate(batches):
        loss, g = loss_and_grads(p, tokens, cfg, rows, precision)
        losses.append(loss)
        adam.update(p, g, on_first if i == 0 else None)
        del g
    return losses
