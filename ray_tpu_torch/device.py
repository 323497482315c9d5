"""Device resolution for the port's entry points.

``device=None`` means the CUDA card.  With no card and no explicit
device, entry points raise instead of quietly running on the CPU: a
run that believes it measured the card must have used it.
"""

from __future__ import annotations

import sys

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); else the
    device the caller named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor.  A DTensor exists only once
    ``torch.distributed.tensor`` is loaded, so this never imports it:
    that import brings sympy, seconds of a new process's first step on
    a path that holds no DTensor."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)
