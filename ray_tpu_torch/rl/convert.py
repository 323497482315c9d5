"""Weights between the JAX RL param trees and the port's state_dicts.

The JAX modules are flax ``nn.Dense`` stacks: ``{"params": {"fc_0":
{"kernel": [in, out], "bias": [out]}, ..., "pi": ..., "vf": ...}}``.
The port's are ``nn.Linear`` stacks with the same layer names, whose
``weight`` is ``[out, in]``: conversion transposes each kernel and
renames it.  ``SACModule``'s tree nests one such tree under each of
``actor``, ``q1`` and ``q2``.  The tree side holds numpy arrays (as
``jax.tree_util.tree_map(np.asarray, params)`` gives them); it is also
the form the port's learners hand out with ``get_weights``, so weights
cross actors, get averaged and reach runners as numpy trees, as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SAC_PARTS = ("actor", "q1", "q2")


def rl_params_from_numpy(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax ``{"params": {layer: {"kernel", "bias"}}}`` of numpy arrays
    -> state_dict of CPU tensors (for ``load_state_dict``, which copies
    onto the module's device)."""
    flat: Dict[str, torch.Tensor] = {}
    for layer, leaves in tree["params"].items():
        flat[f"{prefix}{layer}.weight"] = torch.from_numpy(
            np.array(leaves["kernel"]).T.copy())
        flat[f"{prefix}{layer}.bias"] = torch.from_numpy(
            np.array(leaves["bias"]))
    return flat


def rl_params_to_numpy(state_dict, prefix: str = "") -> dict:
    """state_dict (any device) -> flax ``{"params": {...}}`` of numpy
    arrays; only the keys under ``prefix``."""
    params: dict = {}
    for name, val in state_dict.items():
        if not name.startswith(prefix):
            continue
        layer, leaf = name[len(prefix):].rsplit(".", 1)
        arr = val.detach().cpu().numpy()
        if leaf == "weight":
            params.setdefault(layer, {})["kernel"] = arr.T.copy()
        else:
            params.setdefault(layer, {})["bias"] = arr
    return {"params": params}


def sac_params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """``{"actor": tree, "q1": tree, "q2": tree}`` -> ``SACModule``
    state_dict."""
    flat: Dict[str, torch.Tensor] = {}
    for part in SAC_PARTS:
        flat.update(rl_params_from_numpy(tree[part], f"{part}."))
    return flat


def sac_params_to_numpy(state_dict) -> dict:
    return {part: rl_params_to_numpy(state_dict, f"{part}.")
            for part in SAC_PARTS}
