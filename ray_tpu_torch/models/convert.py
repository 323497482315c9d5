"""Weights between the JAX param trees and the port's state_dicts.

The port keeps flax's parameter names and layouts (``Dense`` kernels
[in, out], norms ``scale``/``bias``), so conversion only flattens or
nests the paths: ``{"params": {"h_0": {"c_attn": {"kernel": a}}}}`` <->
``{"h_0.c_attn.kernel": a}``.  The tree side holds numpy arrays, as
``jax.tree_util.tree_map(np.asarray, params)`` gives them.  Llama
flattens the same way as GPT-2, so its pair is GPT-2's, and an MoE
block's ``h_<i>/moe_mlp/{router,w_in,w_out}`` goes the same way.  A
sharded state dict (DTensors) converts to the same tree, gathered
whole.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def gpt2_params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """JAX param tree of numpy arrays -> state_dict of CPU tensors (ready
    for the model's ``load_state_dict``, which copies onto its device)."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            else:
                flat[prefix + key] = torch.from_numpy(np.array(val))

    walk(tree["params"], "")
    return flat


def gpt2_params_to_numpy(state_dict) -> dict:
    """state_dict -> ``{"params": {...}}`` nested dict of numpy arrays.
    Sharded values (DTensors, ``train_step.shard_state``) are gathered
    whole with ``full_tensor()``, a collective every rank must call."""
    from torch.distributed.tensor import DTensor

    params: dict = {}
    for name, val in state_dict.items():
        if isinstance(val, DTensor):
            val = val.full_tensor()
        node = params
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().cpu().numpy()
    return {"params": params}


llama_params_from_numpy = gpt2_params_from_numpy
llama_params_to_numpy = gpt2_params_to_numpy
