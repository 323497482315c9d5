"""Telemetry configuration and the device peak tables: the part of
``ray_tpu/train/config.py`` that the port's training session uses.

The JAX package's tables list TPU generations; the port's list the cards
it runs on, keyed by a fragment of ``torch.cuda.get_device_name``.  The
H100 entry is the data sheet's SXM part (dense bf16 tensor-core rate and
HBM3 bandwidth); its name on the card is "NVIDIA H100 80GB HBM3".  A
device the table does not name, and the CPU, resolve to 0: the MFU
gauge is then not emitted, as without declared FLOPs.  (The JAX package
falls back to its v5e figures; on another card a default would be a
wrong number, not a fallback.)  ``RT_PEAK_FLOPS_PER_DEVICE`` overrides
the table.  ``util/xprof.py`` keeps a mirror of the tables, pinned to
these by ``tests/test_torch_xprof.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

# Dense bf16 FLOP/s per device (NVIDIA H100 SXM data sheet).
PEAK_FLOPS_BY_DEVICE: Dict[str, float] = {
    "H100 80GB HBM3": 989e12,
}

# HBM bytes/s per device: the roofline's memory roof.
PEAK_HBM_BYTES_PER_SEC_BY_DEVICE: Dict[str, float] = {
    "H100 80GB HBM3": 3.35e12,
}


def device_name() -> str:
    """The current CUDA device's name, or "" without one."""
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.cuda.current_device())


def lookup(table: Dict[str, float], name: Optional[str] = None) -> float:
    """The entry of ``table`` whose key ``name`` (default: the current
    device's) contains, else 0."""
    name = device_name() if name is None else name
    return next((v for k, v in table.items() if k in name), 0.0)


@dataclass
class TelemetryConfig:
    """Declared model-cost figures the session needs to turn per-step
    reports into tokens/sec and achieved MFU gauges.

    ``model_flops_per_token`` is the training cost (fwd+bwd) per token,
    e.g. ``GPT2Config.flops_per_token()``.  With it unset (0) the MFU
    gauge is not emitted; step time and goodput work regardless.
    """

    model_flops_per_token: float = 0.0
    tokens_per_step: float = 0.0       # per-worker tokens per report
    peak_flops_per_device: float = 0.0  # 0 = resolve from the device
    devices_per_worker: int = 1

    def resolved_peak_flops(self) -> float:
        if self.peak_flops_per_device > 0:
            return self.peak_flops_per_device
        env = os.environ.get("RT_PEAK_FLOPS_PER_DEVICE", "")
        if env:
            try:
                return float(env)
            except ValueError:
                pass
        return lookup(PEAK_FLOPS_BY_DEVICE)
