"""Training step: global-norm clip + AdamW on a warmup-cosine schedule.

Counterpart of ``ray_tpu/train/train_step.py`` (``TrainState``,
``make_optimizer``, ``make_train_step``), with optax's semantics kept:

- the schedule is ``warmup_cosine_decay_schedule(0, peak, warmup,
  max(total, warmup + 1), 0.1 * peak)``: the warmup counts inside the
  decay steps, and the learning rate is read at the count *before* the
  update, so it is 0 on the first step;
- ``clip_by_global_norm`` leaves the gradients alone while their norm is
  below the limit and otherwise scales them by ``limit / norm`` (no
  ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``);
- ``adamw`` decays every parameter, biases and norm scales included.

Unlike the JAX step, which returns a new state, the step here updates
the model's parameters and the optimizer moments in place.  The update
runs as a handful of ``torch._foreach_*`` calls over all parameters.
The sharded step (``make_sharded_train_step``, ``shard_state``) arrives
with the distributed slice of the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear warmup from
    ``init_value``, then cosine decay to ``end_value`` at ``decay_steps``
    (a total that includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1,
    b2, eps=1e-8, weight_decay))`` over a list of parameters."""

    def __init__(self, schedule: Callable[[int], float], *, grad_clip: float,
                 b1: float, b2: float, eps: float, weight_decay: float):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               params: List[torch.Tensor]) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place (``grads``
        are clipped in place too).  Returns the pre-clip global norm."""
        norm = global_norm(grads)
        clip = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        lr = self.schedule(state["count"])   # the pre-increment count
        count = state["count"] + 1
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)
        state["count"] = count
        return norm


def make_optimizer(learning_rate: float = 3e-4,
                   warmup_steps: int = 100,
                   total_steps: int = 10000,
                   weight_decay: float = 0.1,
                   grad_clip: float = 1.0,
                   b1: float = 0.9, b2: float = 0.95) -> ClippedAdamW:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1),
        end_value=learning_rate * 0.1)
    return ClippedAdamW(schedule, grad_clip=grad_clip, b1=b1, b2=b2,
                        eps=1e-8, weight_decay=weight_decay)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Dict

    @classmethod
    def create(cls, model: nn.Module, optimizer: ClippedAdamW
               ) -> "TrainState":
        return cls(step=0, model=model,
                   opt_state=optimizer.init(list(model.parameters())))


def make_train_step(loss_fn: Callable, optimizer: ClippedAdamW
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """loss_fn(model, batch) -> scalar.  Returns step(state, batch) ->
    (state, {"loss", "grad_norm"}), where grad_norm is the pre-clip
    global norm.  The state is updated in place and returned."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = list(state.model.parameters())
        loss = loss_fn(state.model, batch)
        grads = list(torch.autograd.grad(loss, params))
        grad_norm = optimizer.update(grads, state.opt_state, params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
