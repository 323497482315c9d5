"""Collective types and the backend names the port accepts.

Counterpart of ``ray_tpu/collective/types.py``.  The port ships:

- ``Backend.NCCL``: ``torch.distributed`` NCCL groups over CUDA tensors,
  the counterpart of the JAX package's ``xla`` backend;
- ``Backend.CPU``: ``torch.distributed`` gloo groups, the counterpart of
  its host ``cpu`` backend.

``xla`` is rejected by name with a pointer to ``nccl``, the mirror image
of the JAX package rejecting ``nccl`` with a pointer to ``xla``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Backend(str, enum.Enum):
    NCCL = "nccl"
    CPU = "cpu"

    @classmethod
    def parse(cls, name: str) -> "Backend":
        low = str(name).lower()
        if low in ("nccl", "cuda"):
            return cls.NCCL
        if low in ("cpu", "host", "gloo"):
            return cls.CPU
        if low in ("xla", "tpu", "jax"):
            raise ValueError(
                "XLA collectives need JAX on a TPU; this port runs on "
                "CUDA: use backend='nccl' for device collectives.")
        raise ValueError(f"Unknown collective backend {name!r}")

    @property
    def torch_name(self) -> str:
        """The ``torch.distributed`` backend that implements it."""
        return "nccl" if self is Backend.NCCL else "gloo"


class ReduceOp(str, enum.Enum):
    SUM = "sum"
    PRODUCT = "prod"
    MAX = "max"
    MIN = "min"
    MEAN = "mean"


@dataclass
class GroupInfo:
    group_name: str
    world_size: int
    rank: int
    backend: Backend
