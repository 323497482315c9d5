"""Offline RL data path: record rollouts, read them back as a Dataset,
train from them (behavior cloning).

Counterpart of ``ray_tpu/rl/offline.py`` (ref:
rllib/offline/offline_data.py — OfflineData wraps a ray.data Dataset
and hands the learner an iterator of train batches;
offline/offline_env_runner.py records sampled experience to Parquet).
Transitions flow through ``ray_tpu_torch.data`` (Parquet blocks,
streaming iteration; ``pyarrow`` loads inside the data library's
Parquet reader and writer only), and the learner's update_from_batch
consumes numpy batch dicts on ``device`` (``None``: the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .convert import rl_params_to_numpy
from .learner import adam, grads_of, metrics_of
from .rl_module import RLModuleSpec, TorchRLModule


def record_rollouts(env_fn: Callable, policy_fn: Callable,
                    path: str, *, num_steps: int = 2000,
                    seed: int = 0) -> int:
    """Roll a (behavior) policy and write transitions to Parquet via
    ray_tpu_torch.data (ref: offline_env_runner.py output writing).
    ``policy_fn(obs) -> action`` is any callable — a scripted expert, a
    trained module, or random.  Returns rows written."""
    import gymnasium as gym  # noqa: F401 — envs come from env_fn

    from .. import data as rt_data

    env = env_fn()
    obs, _ = env.reset(seed=seed)
    rows: List[Dict[str, Any]] = []
    for _ in range(num_steps):
        action = policy_fn(np.asarray(obs, np.float32))
        next_obs, reward, term, trunc, _ = env.step(action)
        rows.append({
            "obs": np.asarray(obs, np.float32),
            "action": action,
            "reward": float(reward),
            "done": float(term),
        })
        obs = next_obs
        if term or trunc:
            obs, _ = env.reset()
    ds = rt_data.from_items(rows, parallelism=max(1, len(rows) // 500))
    ds.write_parquet(path)
    return len(rows)


class OfflineData:
    """Streaming batch source over recorded experience (ref:
    offline_data.py OfflineData.sample — returns batch iterators over
    the underlying Dataset, repeating across epochs)."""

    def __init__(self, path_or_dataset, *, shuffle_seed: int = 0):
        from .. import data as rt_data
        from ..data.dataset import Dataset

        if isinstance(path_or_dataset, Dataset):
            self.dataset = path_or_dataset
        else:
            self.dataset = rt_data.read_parquet(path_or_dataset)
        self._seed = shuffle_seed

    def count(self) -> int:
        return self.dataset.count()

    def iter_batches(self, *, batch_size: int = 256,
                     epochs: Optional[int] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch-shuffled numpy batches, forever when epochs=None."""
        epoch = 0
        while epochs is None or epoch < epochs:
            shuffled = self.dataset.random_shuffle(
                seed=self._seed + epoch)
            yielded = 0
            for batch in shuffled.iter_batches(batch_size=batch_size,
                                               batch_format="numpy",
                                               drop_last=True):
                yield batch
                yielded += 1
            if yielded == 0:
                # drop_last with a dataset smaller than one batch
                # would otherwise spin forever yielding nothing.
                raise ValueError(
                    f"offline dataset has fewer rows than "
                    f"batch_size={batch_size}; record more data or "
                    f"shrink the batch")
            epoch += 1


def bc_loss(module: TorchRLModule, obs: torch.Tensor,
            actions: torch.Tensor):
    logits, _ = module(obs)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, actions[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == actions).float())
    return torch.mean(nll), acc


class BCTorchLearner:
    """Behavior cloning: maximize log pi(a_behavior | s) (ref:
    rllib/algorithms/bc/bc.py — BC is marl's simplest offline
    algorithm, a supervised cross-entropy on the recorded actions)."""

    def __init__(self, module_spec: RLModuleSpec, lr: float = 1e-3,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.module = TorchRLModule(module_spec, self.device, seed)
        self.params = list(self.module.parameters())
        self.optimizer = adam(lr)
        self.opt_state = self.optimizer.init(self.params)
        self.num_updates = 0

    def get_weights(self):
        return rl_params_to_numpy(self.module.state_dict())

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        obs = (np.stack(batch["obs"]) if batch["obs"].dtype == object
               else batch["obs"])
        obs = torch.as_tensor(np.asarray(obs, np.float32)).to(self.device)
        actions = torch.as_tensor(
            np.asarray(batch["action"], np.int64)).to(self.device)
        loss, acc = bc_loss(self.module, obs, actions)
        self.optimizer.update(grads_of(loss, self.params), self.opt_state,
                              self.params)
        self.num_updates += 1
        return metrics_of(("loss", "accuracy"), [loss.detach(), acc])


@dataclass
class BCConfig:
    input_path: Optional[str] = None
    observation_dim: int = 0
    action_dim: int = 0
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    train_batch_size: int = 256
    updates_per_iteration: int = 50
    device: Optional[str] = None     # the learner's device; None = card

    def offline_data(self, input_path: str, *, observation_dim: int,
                     action_dim: int):
        return replace(self, input_path=input_path,
                       observation_dim=observation_dim,
                       action_dim=action_dim)

    def learners(self, *, device: Optional[str] = None):
        return replace(self, device=device)

    def training(self, **kw):
        return replace(self, **kw)

    def build(self) -> "BC":
        return BC(self)


class BC:
    """Offline training loop over OfflineData (ref: bc.py training_step
    — sample from offline data, update, report)."""

    def __init__(self, config: BCConfig):
        assert config.input_path is not None, "offline_data(...) first"
        self.config = config
        spec = RLModuleSpec(config.observation_dim, config.action_dim,
                            config.hidden)
        self.learner = BCTorchLearner(spec, lr=config.lr,
                                      device=config.device)
        self.data = OfflineData(config.input_path)
        self._batches = self.data.iter_batches(
            batch_size=config.train_batch_size)
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        metrics: Dict[str, float] = {}
        for _ in range(self.config.updates_per_iteration):
            metrics = self.learner.update_from_batch(
                next(self._batches))
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "time_this_iter_s": time.perf_counter() - t0,
                **metrics}

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        pass
