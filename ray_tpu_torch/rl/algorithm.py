"""Algorithm — the RL training driver (config -> build -> train()).

Counterpart of ``ray_tpu/rl/algorithm.py``; ``train()`` returns the
same keys.  ``device`` is the learners' device (``None``: the card).
Role-equivalent to the reference's Algorithm + AlgorithmConfig (ref:
rllib/algorithms/algorithm.py:973 step/training_step:1780,
algorithm_config.py fluent builder): an iteration samples the
EnvRunnerGroup, updates through the LearnerGroup, and broadcasts fresh
weights back to the runners.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional

from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup, PPOConfig
from .rl_module import RLModuleSpec


@dataclass
class AlgorithmConfig:
    env_fn: Optional[Callable] = None
    observation_dim: int = 0
    action_dim: int = 0
    hidden: tuple = (64, 64)
    num_env_runners: int = 1
    num_envs_per_runner: int = 4
    rollout_length: int = 128
    num_learners: int = 0           # 0 = learner in the driver process
    device: Optional[str] = None    # the learners' device; None = card
    ppo: PPOConfig = field(default_factory=PPOConfig)

    # Fluent builder (ref: AlgorithmConfig.environment/env_runners/...).
    def environment(self, env_fn: Callable, *, observation_dim: int,
                    action_dim: int) -> "AlgorithmConfig":
        return replace(self, env_fn=env_fn,
                       observation_dim=observation_dim,
                       action_dim=action_dim)

    def env_runners(self, *, num_env_runners: int = 1,
                    num_envs_per_runner: int = 4,
                    rollout_length: int = 128) -> "AlgorithmConfig":
        return replace(self, num_env_runners=num_env_runners,
                       num_envs_per_runner=num_envs_per_runner,
                       rollout_length=rollout_length)

    def learners(self, *, num_learners: int = 0,
                 device: Optional[str] = None) -> "AlgorithmConfig":
        return replace(self, num_learners=num_learners, device=device)

    def training(self, **ppo_kwargs) -> "AlgorithmConfig":
        return replace(self, ppo=replace(self.ppo, **ppo_kwargs))

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    def __init__(self, config: AlgorithmConfig):
        assert config.env_fn is not None, "config.environment(...) first"
        self.config = config
        spec = RLModuleSpec(config.observation_dim, config.action_dim,
                            config.hidden)
        self.learner_group = LearnerGroup(spec, config.ppo,
                                          config.num_learners,
                                          device=config.device)
        self.env_runner_group = EnvRunnerGroup(
            config.env_fn, spec, config.num_env_runners,
            config.num_envs_per_runner, gamma=config.ppo.gamma)
        self.iteration = 0
        self._weights = self.learner_group.get_weights()
        self.env_runner_group.set_weights(self._weights)

    def train(self) -> Dict[str, Any]:
        """One training iteration (ref: Algorithm.step)."""
        t0 = time.perf_counter()
        rollouts = self.env_runner_group.sample(
            self.config.rollout_length)
        sample_time = time.perf_counter() - t0
        t1 = time.perf_counter()
        metrics = self.learner_group.update(rollouts)
        learn_time = time.perf_counter() - t1
        self._weights = self.learner_group.get_weights()
        self.env_runner_group.set_weights(self._weights)
        self.iteration += 1
        stats = self.env_runner_group.stats()
        steps = (self.config.rollout_length
                 * self.config.num_envs_per_runner
                 * self.config.num_env_runners)
        return {
            "training_iteration": self.iteration,
            "env_steps_this_iter": steps,
            "env_steps_per_sec": steps / max(sample_time + learn_time,
                                             1e-9),
            "episode_return_mean": float(
                sum(s["episode_return_mean"] for s in stats)
                / max(len(stats), 1)),
            "episodes_total": sum(s["episodes_total"] for s in stats),
            **metrics,
        }

    def get_weights(self):
        return self._weights

    def stop(self) -> None:
        self.env_runner_group.shutdown()
        self.learner_group.shutdown()
