"""Seeded GPT-2 weights and token batches, made on the device, and the
port's configuration for a configuration file.

The weights follow the published GPT-2 initialisation (Hugging Face's
``GPT2PreTrainedModel._init_weights``): normal(``initializer_range``)
for the embeddings and projections, the residual output projections
(``c_proj`` and ``mlp_out``) divided by sqrt(2 n_layer), zero biases,
unit LayerNorm scales.  They are made in a few large calls into one
float32 buffer, grouped by standard deviation, and handed out as views
under the program's state_dict names (projections ``[in, out]``).  The
same seed gives the same tensors, so the reference regenerates them
instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..costs import d_ff

SEED_MASK = (1 << 64) - 1


def port_config(cfg: dict, **options):
    """The port's ``GPT2Config`` for a configuration file, with
    ``options`` (``attn_impl``, ``remat``)."""
    from ray_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(
        vocab_size=cfg["vocab_size"], n_layer=cfg["n_layer"],
        n_head=cfg["n_head"], d_model=cfg["n_embd"], d_ff=d_ff(cfg),
        max_seq=cfg["n_positions"], dtype=getattr(torch, cfg["dtype"]),
        **options)


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one of a run's streams of random
    numbers (weights 0, batches 1)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) & SEED_MASK)
    return g


def layout(cfg: dict, std: Optional[float] = None
           ) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, std) of every parameter; kind is "normal",
    "ones" or "zeros".  ``std`` defaults to ``initializer_range``."""
    d, L, f = cfg["n_embd"], cfg["n_layer"], d_ff(cfg)
    std = cfg["initializer_range"] if std is None else std
    resid = std / math.sqrt(2 * L)
    out = [("wte", (cfg["vocab_size"], d), "normal", std),
           ("wpe", (cfg["n_positions"], d), "normal", std)]
    for i in range(L):
        h = f"h_{i}."
        out += [(h + "ln_1.scale", (d,), "ones", 0.0),
                (h + "ln_1.bias", (d,), "zeros", 0.0),
                (h + "c_attn.kernel", (d, 3 * d), "normal", std),
                (h + "c_attn.bias", (3 * d,), "zeros", 0.0),
                (h + "c_proj.kernel", (d, d), "normal", resid),
                (h + "c_proj.bias", (d,), "zeros", 0.0),
                (h + "ln_2.scale", (d,), "ones", 0.0),
                (h + "ln_2.bias", (d,), "zeros", 0.0),
                (h + "mlp_in.kernel", (d, f), "normal", std),
                (h + "mlp_in.bias", (f,), "zeros", 0.0),
                (h + "mlp_out.kernel", (f, d), "normal", resid),
                (h + "mlp_out.bias", (d,), "zeros", 0.0)]
    out += [("ln_f.scale", (d,), "ones", 0.0),
            ("ln_f.bias", (d,), "zeros", 0.0)]
    return out


def gpt2_weights(cfg: dict, seed: int, device, std: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
    """{state_dict name: float32 tensor}, views of one buffer; ``std``
    in place of ``initializer_range`` where given."""
    items = layout(cfg, std)
    order = sorted(items, key=lambda it: ({"normal": 0, "ones": 1,
                                           "zeros": 2}[it[2]], -it[3]))
    sizes = [math.prod(shape) for _n, shape, _k, _s in order]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    n_normal = sum(n for n, it in zip(sizes, order) if it[2] == "normal")
    flat[:n_normal].normal_(generator=generator(seed, device))
    out, start = {}, 0
    group_start, group = 0, None
    for size, (name, shape, kind, std) in zip(sizes, order):
        key = (kind, std)
        if key != group:                      # a new group: finish the last
            _fill(flat[group_start:start], group)
            group_start, group = start, key
        out[name] = flat[start:start + size].view(shape)
        start += size
    _fill(flat[group_start:start], group)
    return {name: out[name] for name, *_rest in items}


def _fill(segment: torch.Tensor, group) -> None:
    if group is None or segment.numel() == 0:
        return
    kind, std = group
    if kind == "normal":
        segment.mul_(std)
    elif kind == "ones":
        segment.fill_(1.0)
    else:
        segment.zero_()


def segments(cfg: dict) -> List[Tuple[str, str, slice]]:
    """The pieces in which parameters are compared: every parameter
    whole, but the fused q|k|v projection and bias in their three parts
    (which the published model describes as three).  Each is (piece,
    parameter, slice of the last axis)."""
    d = cfg["n_embd"]
    out = []
    for name, _shape, _kind, _std in layout(cfg):
        if ".c_attn." in name:
            for j, part in enumerate("qkv"):
                out.append((f"{name}.{part}", name,
                            slice(j * d, (j + 1) * d)))
        else:
            out.append((name, name, slice(None)))
    return out


def segment_norms(cfg: dict, tensors: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """The float32 norm of every piece of ``segments``, one tensor."""
    views = [tensors[param][..., sl] for _p, param, sl in segments(cfg)]
    return torch.stack([torch.linalg.vector_norm(v.float()) for v in views])


class TokenFeed:
    """Batches of ``rows`` x ``width`` token ids, uniform over the
    vocabulary, drawn on the device from the seed: every row differs."""

    def __init__(self, seed: int, rows: int, width: int, vocab: int,
                 device):
        self.shape = (rows, width)
        self.vocab = vocab
        self.device = device
        self.gen = generator(seed, device, stream=1)

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)
