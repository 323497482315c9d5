"""EnvRunner — rollout collection actors.

Counterpart of ``ray_tpu/rl/env_runner.py`` (ref:
rllib/env/single_agent_env_runner.py:139 sample(): gym vector envs +
RLModule inference; rllib/env/env_runner_group.py:71).  Runners hold
the env and a ``TorchRLModule`` on the CPU, the device of their lease
(a runner leases no GPU, as the JAX runners lease no chip); ``sample``
steps the vector env with exploration forwards and returns numpy
batches ready for the learner.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

import ray_tpu_torch

from .convert import rl_params_from_numpy


def obs_tensor(obs) -> torch.Tensor:
    return torch.from_numpy(np.asarray(obs, np.float32))


class SingleAgentEnvRunner:
    """Plain class; wrapped as an actor by EnvRunnerGroup."""

    def __init__(self, env_fn: Callable, module_spec, num_envs: int = 1,
                 seed: int = 0, gamma: float = 0.99):
        import gymnasium as gym

        from .rl_module import TorchRLModule

        # SAME_STEP autoreset: every recorded row is a REAL transition
        # (NEXT_STEP mode would interleave one bogus ignored-action row
        # per episode); the pre-reset terminal observation arrives in
        # info["final_obs"] for time-limit bootstrapping.
        self.envs = gym.vector.SyncVectorEnv(
            [lambda i=i: env_fn() for i in range(num_envs)],
            autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
        self.num_envs = num_envs
        self._gamma = gamma
        self.module = TorchRLModule(module_spec, "cpu", seed)
        self._armed = False
        self._obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs)
        self._completed_returns: List[float] = []

    def set_weights(self, params) -> bool:
        self.module.load_state_dict(rl_params_from_numpy(params))
        self._armed = True
        return True

    def _values(self, obs) -> np.ndarray:
        with torch.no_grad():
            return self.module(obs_tensor(obs))[1].numpy()

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps vector steps; returns [T, N, ...] batches
        with bootstrap values for GAE."""
        assert self._armed, "set_weights first"
        obs_b, act_b, rew_b, done_b, logp_b, val_b = [], [], [], [], [], []
        for _ in range(num_steps):
            action, logp, value = self.module.forward_exploration(
                obs_tensor(self._obs))
            action = action.numpy()
            next_obs, reward, term, trunc, info = self.envs.step(action)
            done = np.logical_or(term, trunc)
            reward = np.asarray(reward, np.float32)
            if trunc.any():
                # Time-limit truncation is NOT termination: fold the
                # bootstrap value of the pre-reset observation into the
                # reward (r' = r + gamma*V(final_obs)), then cut the
                # recursion like a terminal — unbiased targets without
                # leaking across the episode boundary.
                fo = info.get("final_obs")
                if fo is not None:
                    idx = np.nonzero(trunc)[0]
                    fobs = np.stack([np.asarray(fo[i], np.float32)
                                     for i in idx])
                    reward = reward.copy()
                    reward[idx] += self._gamma * self._values(fobs)
            obs_b.append(self._obs)
            act_b.append(action)
            rew_b.append(reward)
            done_b.append(done)
            logp_b.append(logp.numpy())
            val_b.append(value.numpy())
            self._episode_returns += reward
            for i, d in enumerate(done):
                if d:
                    self._completed_returns.append(
                        float(self._episode_returns[i]))
                    self._episode_returns[i] = 0.0
            self._obs = next_obs
        return {
            "obs": np.stack(obs_b),          # [T, N, obs_dim]
            "actions": np.stack(act_b),      # [T, N]
            "rewards": np.stack(rew_b).astype(np.float32),
            "dones": np.stack(done_b).astype(np.float32),
            "logp": np.stack(logp_b).astype(np.float32),
            "values": np.stack(val_b).astype(np.float32),
            "last_values": self._values(self._obs).astype(np.float32),
            "last_obs": np.asarray(self._obs, np.float32),      # [N, D]
        }

    def episode_stats(self, window: int = 100) -> Dict[str, float]:
        recent = self._completed_returns[-window:]
        return {
            "episodes_total": len(self._completed_returns),
            "episode_return_mean": float(np.mean(recent)) if recent
            else 0.0,
        }


class EnvRunnerGroup:
    """N runner actors with weight broadcast + parallel sampling over a
    fault-tolerant fleet: a runner killed mid-iteration is absorbed (its
    rollout is skipped) and restored with current weights before the
    next one (ref: env_runner_group.py:71 built on
    FaultTolerantActorManager, actor_manager.py:198)."""

    def __init__(self, env_fn: Callable, module_spec,
                 num_runners: int = 1, num_envs_per_runner: int = 1,
                 gamma: float = 0.99):
        from ..core import serialization

        from .actor_manager import (FaultTolerantActorManager,
                                    cpu_actor_class)

        serialization.ensure_code_portable(env_fn)
        actor_cls = cpu_actor_class(SingleAgentEnvRunner)
        self._weights = None

        def factory(i: int):
            return actor_cls.remote(env_fn, module_spec,
                                    num_envs_per_runner,
                                    seed=1000 + 17 * i, gamma=gamma)

        def on_restore(actor):
            if self._weights is not None:
                ray_tpu_torch.get(actor.set_weights.remote(self._weights),
                                  timeout=120)

        self._mgr = FaultTolerantActorManager(
            factory, num_runners, on_restore=on_restore)

    @property
    def runners(self) -> List[Any]:
        return self._mgr.actors

    @property
    def num_restarts(self) -> int:
        return self._mgr.num_restarts

    def set_weights(self, params) -> None:
        self._weights = params
        self._mgr.foreach("set_weights", params)
        self._mgr.restore_unhealthy()

    def sample(self, num_steps_per_runner: int) -> List[Dict]:
        results = self._mgr.foreach("sample", num_steps_per_runner)
        rollouts = [r.value for r in results if r.ok]
        self._mgr.restore_unhealthy()  # on_restore re-arms weights
        if not rollouts:
            raise RuntimeError(
                "every env runner failed this iteration")
        return rollouts

    def stats(self, window: int = 100) -> List[Dict]:
        return [r.value for r in
                self._mgr.foreach("episode_stats", window) if r.ok]

    def shutdown(self) -> None:
        self._mgr.shutdown()
