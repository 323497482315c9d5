"""Device collective group over NCCL: counterpart of
``ray_tpu/collective/collective_group/xla_group.py``.

The JAX package's ``XLAGroup`` bootstraps ``jax.distributed`` and runs
eager collectives as compiled programs over the global mesh.  Here the
group is a ``torch.distributed`` NCCL process group: every op takes CUDA
tensors and leaves its result on the device.  A CPU tensor raises; there
is no quiet staging or other backend.  Point-to-point works too (NCCL
has it), where the XLA group raises and points to ``ppermute``.  Each
timed collective synchronises the stream before its telemetry records
the latency, so the number covers the op's completion, not its launch.
"""

from __future__ import annotations

import torch

from ..types import Backend
from .base import TorchGroup


class NCCLGroup(TorchGroup):
    backend = Backend.NCCL.value

    def _stage(self, tensor: torch.Tensor) -> torch.Tensor:
        if not tensor.is_cuda:
            raise ValueError(f"the NCCL group {self.group_name!r} takes "
                             f"CUDA tensors, got one on {tensor.device}")
        return tensor.detach().clone()

    def _device(self) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device())

    def _completed(self) -> None:
        # ``wait()`` on an NCCL op only orders the current stream after
        # it; the telemetry's latency must cover the op itself.
        torch.cuda.current_stream().synchronize()
