"""Models (counterpart of ``ray_tpu.models``)."""

from .gpt2 import GPT2, GPT2Config, gpt2_init, gpt2_loss_fn
from .llama import Llama, LlamaConfig, llama_init, llama_loss_fn

__all__ = ["GPT2", "GPT2Config", "Llama", "LlamaConfig", "gpt2_init",
           "gpt2_loss_fn", "llama_init", "llama_loss_fn"]
