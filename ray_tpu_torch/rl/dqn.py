"""DQN — off-policy Q-learning with replay and a target network.

Counterpart of ``ray_tpu/rl/dqn.py`` (ref: rllib/algorithms/dqn/ —
new-API stack: EnvRunner epsilon-greedy collection, replay buffer,
double-DQN TD targets, periodic target sync).  The learner runs the
double-DQN update (gather, TD target under the target network, Huber
loss as ``optax.huber_loss`` with delta 1, Adam step) on ``device``
(``None``: the card); the replay buffer is flat numpy rings on the
driver (host memory is the right place for replay — device memory
stays for the update batch).  Runners keep their module on the CPU,
the device of their lease.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch

from ..device import resolve_device
from .convert import rl_params_from_numpy, rl_params_to_numpy
from .env_runner import obs_tensor
from .learner import adam, as_tensors, grads_of, metrics_of
from .rl_module import RLModuleSpec, TorchRLModule


class DQNEnvRunner:
    """Vector-env epsilon-greedy collector (transitions, not GAE
    rollouts)."""

    def __init__(self, env_fn: Callable, module_spec: RLModuleSpec,
                 num_envs: int = 1, seed: int = 0):
        import gymnasium as gym

        # SAME_STEP autoreset: no bogus ignored-action rows; the real
        # successor of a done step arrives in info["final_obs"].
        self.envs = gym.vector.SyncVectorEnv(
            [lambda: env_fn() for _ in range(num_envs)],
            autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
        self.num_envs = num_envs
        self.module = TorchRLModule(module_spec, "cpu", seed)
        self._armed = False
        self._rng = np.random.default_rng(seed)
        self._obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs)
        self._completed: List[float] = []

    def set_weights(self, params) -> bool:
        self.module.load_state_dict(rl_params_from_numpy(params))
        self._armed = True
        return True

    def sample(self, num_steps: int, epsilon: float
               ) -> Dict[str, np.ndarray]:
        assert self._armed, "set_weights first"
        obs_b, act_b, rew_b, done_b, next_b = [], [], [], [], []
        for _ in range(num_steps):
            with torch.no_grad():
                q = self.module(obs_tensor(self._obs))[0].numpy()
            greedy = q.argmax(axis=-1)
            explore = self._rng.random(self.num_envs) < epsilon
            action = np.where(
                explore,
                self._rng.integers(0, q.shape[-1], self.num_envs),
                greedy)
            next_obs, reward, term, trunc, info = self.envs.step(action)
            done = np.logical_or(term, trunc)
            # The stored successor must be the REAL one: at done steps
            # SAME_STEP autoreset returns the reset obs in next_obs and
            # the pre-reset terminal obs in info["final_obs"].
            stored_next = next_obs
            if done.any() and info.get("final_obs") is not None:
                stored_next = np.array(next_obs, copy=True)
                for i in np.nonzero(done)[0]:
                    fo = info["final_obs"][i]
                    if fo is not None:
                        stored_next[i] = np.asarray(fo)
            obs_b.append(self._obs)
            act_b.append(action)
            rew_b.append(reward)
            # Truncation is not termination: bootstrap through it.
            done_b.append(term)
            next_b.append(stored_next)
            self._episode_returns += reward
            for i, d in enumerate(done):
                if d:
                    self._completed.append(
                        float(self._episode_returns[i]))
                    self._episode_returns[i] = 0.0
            self._obs = next_obs
        return {
            "obs": np.concatenate(obs_b).astype(np.float32),
            "actions": np.concatenate(act_b).astype(np.int32),
            "rewards": np.concatenate(rew_b).astype(np.float32),
            "dones": np.concatenate(done_b).astype(np.float32),
            "next_obs": np.concatenate(next_b).astype(np.float32),
        }

    def episode_stats(self, window: int = 20) -> Dict[str, float]:
        recent = self._completed[-window:]
        return {"episodes_total": len(self._completed),
                "episode_return_mean":
                    float(np.mean(recent)) if recent else 0.0}


class ReplayBuffer:
    """Flat numpy ring over transition fields."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self._pos = 0
        self._size = 0

    def add_batch(self, tr: Dict[str, np.ndarray]) -> None:
        n = len(tr["actions"])
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = tr["obs"]
        self.next_obs[idx] = tr["next_obs"]
        self.actions[idx] = tr["actions"]
        self.rewards[idx] = tr["rewards"]
        self.dones[idx] = tr["dones"]
        self._pos = (self._pos + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def __len__(self) -> int:
        return self._size

    def sample(self, rng: np.random.Generator, batch_size: int
               ) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self._size, batch_size)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx],
                "rewards": self.rewards[idx], "dones": self.dones[idx]}


@dataclass
class DQNTrainConfig:
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 100_000
    learning_starts: int = 1000
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    target_sync_every: int = 200      # updates between target syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_steps: int = 10_000
    double_q: bool = True


def huber_loss(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``optax.huber_loss``: quadratic inside ``delta``, linear outside."""
    abs_x = torch.abs(x)
    quadratic = torch.clamp(abs_x, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_x - quadratic)


def dqn_loss(module: TorchRLModule, target: TorchRLModule,
             batch: Dict[str, torch.Tensor], cfg: DQNTrainConfig):
    q = module(batch["obs"])[0]
    q_sa = q.gather(-1, batch["actions"][:, None])[:, 0]
    with torch.no_grad():
        q_next_target = target(batch["next_obs"])[0]
        if cfg.double_q:
            sel = torch.argmax(module(batch["next_obs"])[0], dim=-1)
            q_next = q_next_target.gather(-1, sel[:, None])[:, 0]
        else:
            q_next = q_next_target.max(dim=-1).values
        target_q = batch["rewards"] + cfg.gamma * \
            (1.0 - batch["dones"]) * q_next
    td = q_sa - target_q
    return torch.mean(huber_loss(td)), torch.mean(torch.abs(td)).detach()


_DQN_BATCH = ("obs", "actions", "rewards", "dones", "next_obs")


class DQNTorchLearner:
    def __init__(self, module_spec: RLModuleSpec,
                 config: Optional[DQNTrainConfig] = None, seed: int = 0,
                 device=None):
        self.cfg = config or DQNTrainConfig()
        self.device = resolve_device(device)
        self.module = TorchRLModule(module_spec, self.device, seed)
        self.target = TorchRLModule(module_spec, self.device, seed)
        self.params = list(self.module.parameters())
        self.optimizer = adam(self.cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.num_updates = 0

    def get_weights(self):
        return rl_params_to_numpy(self.module.state_dict())

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        dev = as_tensors(batch, _DQN_BATCH, self.device)
        loss, td_abs = dqn_loss(self.module, self.target, dev, self.cfg)
        self.optimizer.update(grads_of(loss, self.params), self.opt_state,
                              self.params)
        self.num_updates += 1
        if self.num_updates % self.cfg.target_sync_every == 0:
            self.target.load_state_dict(self.module.state_dict())
        return metrics_of(("td_abs", "loss"), [td_abs, loss.detach()])


@dataclass
class DQNConfig:
    env_fn: Optional[Callable] = None
    observation_dim: int = 0
    action_dim: int = 0
    hidden: tuple = (64, 64)
    num_env_runners: int = 1
    num_envs_per_runner: int = 4
    rollout_length: int = 64
    device: Optional[str] = None     # the learner's device; None = card
    train: DQNTrainConfig = field(default_factory=DQNTrainConfig)

    def environment(self, env_fn, *, observation_dim, action_dim):
        return replace(self, env_fn=env_fn,
                       observation_dim=observation_dim,
                       action_dim=action_dim)

    def env_runners(self, **kw):
        return replace(self, **kw)

    def learners(self, *, device: Optional[str] = None):
        return replace(self, device=device)

    def training(self, **kw):
        return replace(self, train=replace(self.train, **kw))

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    def __init__(self, config: DQNConfig):
        assert config.env_fn is not None
        self.config = config
        spec = RLModuleSpec(config.observation_dim, config.action_dim,
                            config.hidden)
        from ..core import serialization

        from .actor_manager import (FaultTolerantActorManager,
                                    cpu_actor_class)

        serialization.ensure_code_portable(config.env_fn)
        self.learner = DQNTorchLearner(spec, config.train,
                                       device=config.device)
        runner_cls = cpu_actor_class(DQNEnvRunner)

        def factory(i):
            return runner_cls.remote(config.env_fn, spec,
                                     config.num_envs_per_runner,
                                     seed=2000 + 31 * i)

        def on_restore(actor):
            ray_tpu_torch.get(actor.set_weights.remote(
                self.learner.get_weights()), timeout=120)

        self._runners = FaultTolerantActorManager(
            factory, config.num_env_runners, on_restore=on_restore)
        self._runners.foreach("set_weights", self.learner.get_weights())
        self.buffer = ReplayBuffer(config.train.buffer_capacity,
                                   config.observation_dim)
        self._rng = np.random.default_rng(7)
        self.env_steps_total = 0
        self.iteration = 0

    def _epsilon(self) -> float:
        cfg = self.config.train
        frac = min(self.env_steps_total / cfg.epsilon_decay_steps, 1.0)
        return cfg.epsilon_start + frac * (cfg.epsilon_end
                                           - cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        eps = self._epsilon()
        results = self._runners.foreach("sample", cfg.rollout_length,
                                        eps)
        self._runners.restore_unhealthy()
        for r in results:
            if r.ok:
                self.buffer.add_batch(r.value)
                self.env_steps_total += len(r.value["actions"])
        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.train.learning_starts:
            for _ in range(cfg.train.updates_per_iteration):
                batch = self.buffer.sample(self._rng,
                                           cfg.train.train_batch_size)
                metrics = self.learner.update_from_batch(batch)
            self._runners.foreach("set_weights",
                                  self.learner.get_weights())
            self._runners.restore_unhealthy()
        self.iteration += 1
        stats = [r.value for r in
                 self._runners.foreach("episode_stats", 20) if r.ok]
        return {
            "training_iteration": self.iteration,
            "epsilon": eps,
            "env_steps_total": self.env_steps_total,
            "episode_return_mean": float(np.mean(
                [s["episode_return_mean"] for s in stats]))
            if stats else 0.0,
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        self._runners.shutdown()
