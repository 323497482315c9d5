"""Frozen yardsticks: peak rates, and the operations and bytes of the
work a cell does, counted from shapes.

These are copies, kept here so that a change to the program cannot
change what it is measured against:

- the peaks are NVIDIA's data sheet for the H100 SXM (dense bf16
  989 TFLOP/s, HBM3 3.35 TB/s), as ``ray_tpu_torch/util/xprof.py``
  lists them;
- ``flash_cost`` is ``ray_tpu_torch/ops/flash_attention.py``'s;
- ``train_flops_per_token`` and ``decode_flops_per_token`` are
  ``GPT2Config.flops_per_token`` / ``decode_flops_per_token`` of
  ``ray_tpu_torch/models/gpt2.py``, over the keys of a configuration
  file (``n_layer``, ``n_embd``, ``n_inner``, ``vocab_size``,
  ``n_positions``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

PEAK_BF16_FLOPS: Dict[str, float] = {"H100 80GB HBM3": 989e12}
PEAK_HBM_BYTES_PER_S: Dict[str, float] = {"H100 80GB HBM3": 3.35e12}


def _lookup(table: Dict[str, float], device_kind: str) -> Optional[float]:
    return next((v for k, v in table.items() if k in device_kind), None)


def peak_flops(device_kind: str) -> Optional[float]:
    """Dense bf16 FLOP/s of the named card; None for an unknown one."""
    return _lookup(PEAK_BF16_FLOPS, device_kind)


def peak_hbm(device_kind: str) -> Optional[float]:
    """HBM bytes/s of the named card; None for an unknown one."""
    return _lookup(PEAK_HBM_BYTES_PER_S, device_kind)


def d_ff(cfg: dict) -> int:
    """The MLP width: ``n_inner``, or 4 * ``n_embd`` where the published
    configuration leaves it null."""
    return cfg.get("n_inner") or 4 * cfg["n_embd"]


def matmul_params(cfg: dict) -> int:
    """Weights that take part in a product: the blocks' four matrices
    and the tied unembedding (the lookups are gathers)."""
    d, L = cfg["n_embd"], cfg["n_layer"]
    return cfg["vocab_size"] * d + L * (4 * d * d + 2 * d * d_ff(cfg))


def train_flops_per_token(cfg: dict) -> float:
    """Training FLOPs a token, forward and backward, without remat's
    recompute: 6 per parameter plus 12 L d T of attention."""
    d, L, T = cfg["n_embd"], cfg["n_layer"], cfg["n_positions"]
    n_params = (cfg["vocab_size"] * d + T * d
                + L * (4 * d * d + 2 * d * d_ff(cfg)))
    return 6.0 * n_params + 6 * 2 * L * d * T


def decode_flops_per_token(cfg: dict, context: int) -> float:
    """FLOPs to decode one token that attends to ``context`` positions:
    2 per product weight, plus 4 L d context for scores and values."""
    return 2.0 * matmul_params(cfg) + 4 * cfg["n_layer"] * cfg["n_embd"] \
        * context


def prefill_flops(cfg: dict, prompt: int) -> float:
    """FLOPs that a prompt of ``prompt`` tokens needs: each position's
    blocks and causal attention, and the unembedding once, for the last
    position (the one that is sampled)."""
    d, L = cfg["n_embd"], cfg["n_layer"]
    blocks = 2.0 * (matmul_params(cfg) - cfg["vocab_size"] * d) * prompt
    attn = 4.0 * L * d * prompt * (prompt + 1) / 2
    return blocks + attn + 2.0 * cfg["vocab_size"] * d


def decode_step_weight_bytes(cfg: dict, itemsize: int = 2) -> float:
    """Least bytes of one decode forward's weights: every product weight
    read once, in the served type."""
    return float(matmul_params(cfg) * itemsize)


def decode_token_kv_bytes(cfg: dict, context: int, itemsize: int = 2
                          ) -> float:
    """Least K/V bytes of one decoded token: K and V of ``context``
    positions read in every layer, and the token's own K and V written."""
    per_pos = 2 * cfg["n_layer"] * cfg["n_embd"] * itemsize
    return float(per_pos * context + per_pos)


def flash_cost(kernel: str, bh: int, t: int, d: int, causal: bool,
               itemsize: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call of ``kernel`` ("flash_fwd",
    "flash_dkv" or "flash_dq") on ``bh`` heads of ``t`` rows and width
    ``d``: the products over the visible (q, k) pairs, and each input
    read once and each output written once."""
    pairs = t * (t + 1) // 2 if causal else t * t
    tile = bh * t * d * itemsize
    rows = bh * t * 4
    flops, nbytes = {
        "flash_fwd": (4 * d * pairs * bh, 4 * tile + rows),
        "flash_dkv": (8 * d * pairs * bh, 6 * tile + 2 * rows),
        "flash_dq": (6 * d * pairs * bh, 5 * tile + 2 * rows),
    }[kernel]
    return float(flops), float(nbytes)


def roofline_seconds(flops: float, nbytes: float, device_kind: str
                     ) -> Optional[float]:
    """The least time the card could take: the larger of the operations
    over peak FLOP/s and the bytes over peak bandwidth."""
    pf, pb = peak_flops(device_kind), peak_hbm(device_kind)
    if pf is None or pb is None:
        return None
    return max(flops / pf, nbytes / pb)
