"""Ops with hand-written CUDA kernels (counterpart of ``ray_tpu.ops``)."""

from .flash_attention import flash_attention, flash_attention_with_lse

__all__ = ["flash_attention", "flash_attention_with_lse"]
