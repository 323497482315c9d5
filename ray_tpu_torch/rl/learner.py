"""Learner — gradient updates on rollout batches, in PyTorch.

Counterpart of ``ray_tpu/rl/learner.py`` (ref:
rllib/core/learner/learner.py:109 with update_from_batch:967; torch DDP
wrapping at torch_learner.py:500).  ``PPOTorchLearner`` owns a
``TorchRLModule`` and the update rule of the JAX learner,
``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``, written as
the port's ``ClippedAdamW`` (no weight decay, a constant rate): the
gradients stay as they are while their global norm is under the limit
and are scaled by ``limit / norm`` above it.  The minibatch order of
each epoch is a permutation drawn from the learner's CPU
``torch.Generator`` (seeded with ``seed``), so it is the same on every
device; no torch generator reproduces ``jax.random.permutation``.

A learner runs on ``device`` (``None``: the card, through
``resolve_device``).  ``LearnerGroup`` holds one in the driver
(``num_learners=0``) or creates learner actors; a learner actor on the
card leases ``GPU: 1 / num_learners``, so the learners share one card
and each sees it through its lease's ``CUDA_VISIBLE_DEVICES``.
Batches shard across the learners and the updated weights are averaged
(the multi-learner data-parallel shape); weights travel as numpy trees
in flax's layout (``rl/convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch

from ..device import resolve_device
from ..train.train_step import ClippedAdamW
from .actor_manager import cpu_actor_class
from .convert import rl_params_from_numpy, rl_params_to_numpy
from .rl_module import TorchRLModule


@dataclass
class PPOConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    grad_clip: float = 0.5


def compute_gae(batch: Dict[str, np.ndarray], gamma: float,
                lam: float) -> Tuple[np.ndarray, np.ndarray]:
    """GAE advantages + value targets from a [T, N] rollout."""
    rewards, dones = batch["rewards"], batch["dones"]
    values, last_values = batch["values"], batch["last_values"]
    t_len, n = rewards.shape
    adv = np.zeros((t_len, n), np.float32)
    last_gae = np.zeros(n, np.float32)
    next_value = last_values
    for t in range(t_len - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    targets = adv + values
    return adv, targets


def adam(lr: float, grad_clip: float = math.inf) -> ClippedAdamW:
    """``optax.adam(lr)`` behind ``clip_by_global_norm(grad_clip)``;
    with no clip a norm under infinity leaves the gradients as they
    are."""
    return ClippedAdamW(lambda _count: lr, grad_clip=grad_clip, b1=0.9,
                        b2=0.999, eps=1e-8, weight_decay=0.0)


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """d loss / d params; zeros for parameters the loss does not use
    (``jax.grad`` gives zeros where torch gives ``None``)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def as_tensors(batch: Dict[str, np.ndarray], keys, device
               ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: integer arrays as int64
    (torch's index type), the rest as float32."""
    out = {}
    for k in keys:
        v = np.asarray(batch[k])
        dtype = torch.int64 if v.dtype.kind in "iu" else torch.float32
        out[k] = torch.tensor(v, dtype=dtype, device=device)
    return out


def metrics_of(names, values: List[torch.Tensor]) -> Dict[str, float]:
    """One host copy for all the metrics of an update."""
    return dict(zip(names, torch.stack(values).tolist()))


def ppo_loss(module: TorchRLModule, mb: Dict[str, torch.Tensor],
             cfg: PPOConfig):
    logits, values = module(mb["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, mb["actions"][:, None])[:, 0]
    ratio = torch.exp(logp - mb["logp_old"])
    adv = mb["adv"]
    surrogate = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv)
    pi_loss = -torch.mean(surrogate)
    vf_loss = torch.mean((values - mb["targets"]) ** 2)
    entropy = -torch.mean(
        torch.sum(torch.softmax(logits, dim=-1) * logp_all, dim=-1))
    total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
    return total, (pi_loss, vf_loss, entropy)


_PPO_METRICS = ("pi_loss", "vf_loss", "entropy", "loss")


class PPOTorchLearner:
    """Owns the module + optimizer; ``update_from_batch`` runs the PPO
    epochs over shuffled minibatches."""

    def __init__(self, module_spec, config: Optional[PPOConfig] = None,
                 seed: int = 0, device=None):
        self.cfg = config or PPOConfig()
        self.device = resolve_device(device)
        self.module = TorchRLModule(module_spec, self.device, seed)
        self.params = list(self.module.parameters())
        self.optimizer = adam(self.cfg.lr, self.cfg.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        self.generator = torch.Generator().manual_seed(seed)

    def get_weights(self):
        return rl_params_to_numpy(self.module.state_dict())

    def set_weights(self, params) -> bool:
        self.module.load_state_dict(rl_params_from_numpy(params))
        self.opt_state = self.optimizer.init(self.params)
        return True

    def update_from_batch(self, rollout: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        cfg = self.cfg
        adv, targets = compute_gae(rollout, cfg.gamma, cfg.gae_lambda)
        adv_flat = adv.reshape(-1)
        adv_flat = (adv_flat - adv_flat.mean()) / (adv_flat.std() + 1e-8)
        batch = as_tensors({
            "obs": rollout["obs"].reshape(-1, rollout["obs"].shape[-1]),
            "actions": rollout["actions"].reshape(-1).astype(np.int64),
            "logp_old": rollout["logp"].reshape(-1),
            "adv": adv_flat,
            "targets": targets.reshape(-1),
        }, ("obs", "actions", "logp_old", "adv", "targets"), self.device)
        n = batch["obs"].shape[0]
        mb_size = min(cfg.minibatch_size, n)
        n_mb = max(n // mb_size, 1)
        sums = torch.zeros(4, device=self.device)
        for _ in range(cfg.num_epochs):
            perm = torch.randperm(n, generator=self.generator).to(
                self.device)
            for i in range(n_mb):
                take = perm[i * mb_size:(i + 1) * mb_size]
                mb = {k: v[take] for k, v in batch.items()}
                loss, aux = ppo_loss(self.module, mb, cfg)
                self.optimizer.update(grads_of(loss, self.params),
                                      self.opt_state, self.params)
                sums += torch.stack([*aux, loss]).detach()
        return metrics_of(_PPO_METRICS,
                          list(sums / (cfg.num_epochs * n_mb)))


def tree_mean(trees: List[Any]):
    """Leafwise mean of nested dicts of numpy arrays."""
    if isinstance(trees[0], dict):
        return {k: tree_mean([t[k] for t in trees]) for k in trees[0]}
    return np.mean(np.stack(trees), axis=0)


def learner_actor_class(learner_cls, num_learners: int,
                        device: torch.device):
    """``learner_cls`` as an actor class and the device its instances
    are given: on the card each leases ``GPU: 1 / num_learners`` (and
    finds the card as ``cuda`` through its lease), on the CPU no GPU
    (``cpu_actor_class``)."""
    if device.type == "cuda":
        return ray_tpu_torch.remote(learner_cls).options(
            num_gpus=1.0 / num_learners), "cuda"
    return cpu_actor_class(learner_cls), str(device)


class LearnerGroup:
    """1..N learner actors; batches shard across learners and updated
    params average (data-parallel update, the reference's multi-learner
    DDP shape at learner_group.py:80)."""

    def __init__(self, module_spec, config: Optional[PPOConfig] = None,
                 num_learners: int = 0, device=None):
        device = resolve_device(device)
        self.local: Optional[PPOTorchLearner] = None
        self.actors: List[Any] = []
        if num_learners <= 0:
            self.local = PPOTorchLearner(module_spec, config, device=device)
        else:
            cls, dev = learner_actor_class(PPOTorchLearner, num_learners,
                                           device)
            self.actors = [cls.remote(module_spec, config, seed=0,
                                      device=dev)
                           for _ in range(num_learners)]

    def get_weights(self):
        if self.local is not None:
            return self.local.get_weights()
        return ray_tpu_torch.get(self.actors[0].get_weights.remote())

    def update(self, rollouts: List[Dict]) -> Dict[str, float]:
        if self.local is not None:
            merged = _merge_rollouts(rollouts)
            return self.local.update_from_batch(merged)
        # Shard rollouts across learners; average refreshed params.
        shards = np.array_split(np.arange(len(rollouts)),
                                len(self.actors))
        refs = []
        for actor, idx in zip(self.actors, shards):
            sub = [rollouts[i] for i in idx] or rollouts[:1]
            refs.append(actor.update_from_batch.remote(
                _merge_rollouts(sub)))
        metrics = ray_tpu_torch.get(refs)
        weights = ray_tpu_torch.get([a.get_weights.remote()
                                     for a in self.actors])
        mean_w = tree_mean(weights)
        ray_tpu_torch.get([a.set_weights.remote(mean_w)
                           for a in self.actors])
        out: Dict[str, float] = {}
        for k in metrics[0]:
            out[k] = float(np.mean([m[k] for m in metrics]))
        return out

    def shutdown(self) -> None:
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


def _merge_rollouts(rollouts: List[Dict]) -> Dict[str, np.ndarray]:
    if len(rollouts) == 1:
        return rollouts[0]
    out = {}
    for k in rollouts[0]:
        # [N]-shaped bootstrap entries concat on axis 0; [T, N] on 1.
        axis = 0 if k in ("last_values", "last_obs") else 1
        out[k] = np.concatenate([r[k] for r in rollouts], axis=axis)
    return out
