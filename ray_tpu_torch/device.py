"""Device resolution for the port's entry points.

``device=None`` means the CUDA card.  With no card and no explicit
device, entry points raise instead of quietly running on the CPU: a
run that believes it measured the card must have used it.
"""

from __future__ import annotations

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
