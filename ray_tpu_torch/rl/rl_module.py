"""RLModule — the neural policy abstraction, in PyTorch.

Counterpart of ``ray_tpu/rl/rl_module.py`` (``JaxRLModule``), named as
RLlib names its torch modules (ref: rllib/core/rl_module/rl_module.py
with torch impls).  The module is an ``nn.Module`` that owns its
parameters and a ``torch.Generator`` for sampling: ``forward_train``
(logits + values for the learner), ``forward_exploration`` (sampled
actions with their log-probs and values) and ``forward_inference``
(greedy actions).

The layers are the JAX module's: tanh hidden layers ``fc_<i>`` and the
heads ``pi`` and ``vf``, initialised as flax's ``nn.Dense`` is (a
LeCun-normal kernel, a normal truncated at two standard deviations with
``fan_in`` scaling, and a zero bias), not with torch's Kaiming-uniform
default.  The initial weights come from a CPU generator seeded with
``seed``, so they are the same on every device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch
from torch import nn

from ..device import resolve_device

# The standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal initialisers divide by it to keep the variance.
_TRUNC_STD = 0.87962566103423978


@dataclass(frozen=True)
class RLModuleSpec:
    observation_dim: int
    action_dim: int                 # discrete action count
    hidden: Tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


def dense(in_dim: int, out_dim: int, generator: torch.Generator,
          dtype=torch.float32) -> nn.Linear:
    """An ``nn.Linear`` with flax ``nn.Dense``'s initialisation, drawn
    on the CPU from ``generator``."""
    layer = nn.Linear(in_dim, out_dim, dtype=dtype)
    std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std,
                              2.0 * std, generator=generator)
        layer.bias.zero_()
    return layer


class TorchRLModule(nn.Module):
    """Discrete-action policy+value MLP (ref: the default PPO torch
    module rllib/algorithms/ppo/torch/ppo_torch_rl_module.py)."""

    def __init__(self, spec: RLModuleSpec, device=None, seed: int = 0):
        super().__init__()
        self.spec = spec
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        dims = (spec.observation_dim, *spec.hidden)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"fc_{i}", dense(a, b, gen, spec.dtype))
        self.pi = dense(dims[-1], spec.action_dim, gen, spec.dtype)
        self.vf = dense(dims[-1], 1, gen, spec.dtype)
        self.to(device)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs.to(self.spec.dtype)
        for i in range(len(self.spec.hidden)):
            x = torch.tanh(getattr(self, f"fc_{i}")(x))
        return self.pi(x), self.vf(x)[..., 0]

    def forward_train(self, obs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self(obs)

    @torch.no_grad()
    def forward_exploration(self, obs: torch.Tensor):
        """Actions sampled from the logits with the module's generator,
        their log-probs and the values."""
        logits, value = self(obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        action = torch.multinomial(logp_all.exp(), 1,
                                   generator=self.generator)[:, 0]
        logp = logp_all.gather(-1, action[:, None])[:, 0]
        return action, logp, value

    @torch.no_grad()
    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        logits, _ = self(obs)
        return torch.argmax(logits, dim=-1)
