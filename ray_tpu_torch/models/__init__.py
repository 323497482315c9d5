"""Models (counterpart of ``ray_tpu.models``)."""

from .gpt2 import GPT2, GPT2Config, gpt2_init, gpt2_loss_fn

__all__ = ["GPT2", "GPT2Config", "gpt2_init", "gpt2_loss_fn"]
