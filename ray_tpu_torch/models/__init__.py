"""Models (counterpart of ``ray_tpu.models``)."""

from .gpt2 import (GPT2, GPT2Config, gpt2_init, gpt2_loss_fn,
                   gpt2_param_axes, gpt2_partition_rules)
from .llama import (Llama, LlamaConfig, llama_init, llama_loss_fn,
                    llama_param_axes, llama_partition_rules)

# Model-family name -> partition-rule-set factory
# (``train.distributed.rules_for_model``); keys are lowercase, no
# separators.
PARTITION_RULE_SETS = {
    "gpt2": gpt2_partition_rules,
    "llama": llama_partition_rules,
}

__all__ = ["GPT2", "GPT2Config", "Llama", "LlamaConfig",
           "PARTITION_RULE_SETS", "gpt2_init", "gpt2_loss_fn",
           "gpt2_param_axes", "gpt2_partition_rules", "llama_init",
           "llama_loss_fn", "llama_param_axes", "llama_partition_rules"]
