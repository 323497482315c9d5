"""Host collective group over gloo: counterpart of
``ray_tpu/collective/collective_group/cpu_group.py``.

The JAX package's ``CPUGroup`` is a hand-written TCP star that turns what
it is given into host numpy arrays.  Here the same API runs over a
``torch.distributed`` gloo process group.  Like the JAX group, it takes a
tensor wherever it lies: a CUDA tensor is copied to host memory, the
collective runs there, and the result is copied back to the input's
device.  That staging is how several processes that share one card run
ring and Ulysses attention (``parallel/``); it never switches to another
backend.
"""

from __future__ import annotations

import torch

from ..types import Backend
from .base import TorchGroup


class CPUGroup(TorchGroup):
    backend = Backend.CPU.value

    def _stage(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.detach().to("cpu", copy=True)

    def _device(self) -> torch.device:
        return torch.device("cpu")

    def _unstage(self, result: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
        return result.to(like.device)
