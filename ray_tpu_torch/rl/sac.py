"""SAC — soft actor-critic for continuous action spaces.

Counterpart of ``ray_tpu/rl/sac.py`` (ref:
rllib/algorithms/sac/sac.py + sac_learner.py/default_sac_rl_module.py —
squashed-Gaussian actor, twin Q critics, polyak-averaged targets, and
automatic entropy-temperature tuning toward -|A| target entropy; the
public algorithm is Haarnoja et al. 2018).  The learner's step runs the
JAX step's parts in its order: the critic update, the actor update
against the updated critics, the alpha update and the polyak update of
the targets, with three Adams.  The Gaussian noise of a step comes
from the module's CPU generator (``SACModule.noise``), the same on
every device; ``sample_action`` also takes the noise as an argument.
The env runner feeds through ConnectorV2 pipelines (obs
normalization in, action rescaling out), so the module always sees
normalized obs and emits [-1, 1] actions; it runs on the CPU, the
device of its lease.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

import ray_tpu_torch

from ..device import resolve_device
from .connectors import (ClipActions, ConnectorPipelineV2, FlattenObs,
                         RescaleActions)
from .convert import sac_params_from_numpy, sac_params_to_numpy
from .env_runner import obs_tensor
from .learner import adam, as_tensors, grads_of, metrics_of
from .rl_module import dense


@dataclass(frozen=True)
class ContinuousModuleSpec:
    """Actor-critic spec for Box action spaces (ref: the SACModule's
    (pi, qf, qf_twin) catalog in default_sac_rl_module.py)."""

    observation_dim: int
    action_dim: int
    hidden: Tuple[int, ...] = (256, 256)
    log_std_bounds: Tuple[float, float] = (-10.0, 2.0)


class _Actor(nn.Module):
    def __init__(self, spec: ContinuousModuleSpec, gen: torch.Generator):
        super().__init__()
        dims = (spec.observation_dim, *spec.hidden)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"fc_{i}", dense(a, b, gen))
        self.mean = dense(dims[-1], spec.action_dim, gen)
        self.log_std = dense(dims[-1], spec.action_dim, gen)
        self.depth = len(spec.hidden)

    def forward(self, obs):
        x = obs
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.mean(x), self.log_std(x)


class _Critic(nn.Module):
    def __init__(self, spec: ContinuousModuleSpec, gen: torch.Generator):
        super().__init__()
        dims = (spec.observation_dim + spec.action_dim, *spec.hidden)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            setattr(self, f"fc_{i}", dense(a, b, gen))
        self.q = dense(dims[-1], 1, gen)
        self.depth = len(spec.hidden)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        for i in range(self.depth):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.q(x)[..., 0]


class SACModule(nn.Module):
    """Squashed-Gaussian policy ``actor`` + twin Q functions ``q1``,
    ``q2`` (relu MLPs, flax ``nn.Dense`` initialisation from a CPU
    generator seeded with ``seed``)."""

    def __init__(self, spec: ContinuousModuleSpec, device=None,
                 seed: int = 0):
        super().__init__()
        self.spec = spec
        gen = torch.Generator().manual_seed(seed)
        self.actor = _Actor(spec, gen)
        self.q1 = _Critic(spec, gen)
        self.q2 = _Critic(spec, gen)
        self.device = resolve_device(device)
        self.to(self.device)
        self.generator = torch.Generator().manual_seed(seed + 1)

    def noise(self, batch: int) -> torch.Tensor:
        """Standard normal ``[batch, action_dim]`` from the module's CPU
        generator, on the module's device."""
        return torch.randn(batch, self.spec.action_dim,
                           generator=self.generator).to(self.device)

    def sample_action(self, obs: torch.Tensor,
                      eps: Optional[torch.Tensor] = None):
        """Reparameterized tanh-squashed sample with its log-prob
        (change-of-variables correction; ref: SAC appendix C); ``eps``
        is the standard normal noise (drawn with ``noise`` if None)."""
        mean, log_std = self.actor(obs)
        lo, hi = self.spec.log_std_bounds
        log_std = torch.clamp(log_std, lo, hi)
        std = torch.exp(log_std)
        if eps is None:
            eps = self.noise(mean.shape[0])
        pre_tanh = mean + std * eps
        action = torch.tanh(pre_tanh)
        gauss_logp = (-0.5 * ((eps) ** 2 + 2 * log_std
                              + math.log(2 * math.pi))).sum(-1)
        # d tanh(x)/dx = 1 - tanh^2(x); stable form via softplus.
        squash = (2.0 * (math.log(2.0) - pre_tanh
                         - nn.functional.softplus(-2.0 * pre_tanh))).sum(-1)
        return action, gauss_logp - squash

    def deterministic_action(self, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self.actor(obs)
        return torch.tanh(mean)

    def q_values(self, obs: torch.Tensor, act: torch.Tensor):
        return self.q1(obs, act), self.q2(obs, act)


@dataclass
class SACTrainConfig:
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005                 # polyak target rate
    initial_alpha: float = 1.0
    target_entropy: Optional[float] = None   # default: -action_dim
    buffer_capacity: int = 100_000
    learning_starts: int = 1000
    train_batch_size: int = 256
    updates_per_iteration: int = 32


def critic_loss(module: SACModule, targets: nn.ModuleDict,
                log_alpha: torch.Tensor, batch: Dict[str, torch.Tensor],
                eps: torch.Tensor, cfg: SACTrainConfig) -> torch.Tensor:
    q1, q2 = module.q_values(batch["obs"], batch["actions"])
    with torch.no_grad():
        next_a, next_logp = module.sample_action(batch["next_obs"], eps)
        tq1 = targets["q1"](batch["next_obs"], next_a)
        tq2 = targets["q2"](batch["next_obs"], next_a)
        soft_q = torch.minimum(tq1, tq2) - torch.exp(log_alpha) * next_logp
        target = batch["rewards"] + cfg.gamma * \
            (1.0 - batch["dones"]) * soft_q
    return 0.5 * (torch.mean((q1 - target) ** 2)
                  + torch.mean((q2 - target) ** 2))


def actor_loss(module: SACModule, log_alpha: torch.Tensor,
               obs: torch.Tensor, eps: torch.Tensor):
    a, logp = module.sample_action(obs, eps)
    q1, q2 = module.q_values(obs, a)
    alpha = torch.exp(log_alpha).detach()
    return torch.mean(alpha * logp - torch.minimum(q1, q2)), logp.detach()


_SAC_BATCH = ("obs", "actions", "rewards", "dones", "next_obs")
_SAC_METRICS = ("critic_loss", "actor_loss", "alpha", "entropy")


class SACTorchLearner:
    """One step = critic + actor + alpha updates + polyak sync, in the
    JAX step's order (ref: sac_learner.py compute_loss_for_module with
    three optimizers), on ``device`` (``None``: the card)."""

    def __init__(self, module_spec: ContinuousModuleSpec,
                 config: Optional[SACTrainConfig] = None,
                 seed: int = 0, device=None):
        self.cfg = config or SACTrainConfig()
        self.device = resolve_device(device)
        self.module = SACModule(module_spec, self.device, seed)
        self.target_params = nn.ModuleDict(
            {"q1": _Critic(module_spec, torch.Generator()),
             "q2": _Critic(module_spec, torch.Generator())}).to(self.device)
        self._sync_targets()
        self.log_alpha = torch.tensor(
            float(np.log(self.cfg.initial_alpha)), dtype=torch.float32,
            device=self.device, requires_grad=True)
        self.target_entropy = (self.cfg.target_entropy
                               if self.cfg.target_entropy is not None
                               else -float(module_spec.action_dim))
        self.actor_params = list(self.module.actor.parameters())
        self.critic_params = [*self.module.q1.parameters(),
                              *self.module.q2.parameters()]
        self.actor_opt = adam(self.cfg.actor_lr)
        self.critic_opt = adam(self.cfg.critic_lr)
        self.alpha_opt = adam(self.cfg.alpha_lr)
        self.opt_state = {
            "actor": self.actor_opt.init(self.actor_params),
            "critic": self.critic_opt.init(self.critic_params),
            "alpha": self.alpha_opt.init([self.log_alpha]),
        }
        self.num_updates = 0

    def _sync_targets(self) -> None:
        for part in ("q1", "q2"):
            self.target_params[part].load_state_dict(
                getattr(self.module, part).state_dict())

    def get_weights(self):
        return sac_params_to_numpy(self.module.state_dict())

    def set_weights(self, params) -> bool:
        self.module.load_state_dict(sac_params_from_numpy(params))
        return True

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        """One step; the critic step's and then the actor step's noise
        are drawn with ``self.module.noise``."""
        cfg = self.cfg
        dev = as_tensors(batch, _SAC_BATCH, self.device)
        n = dev["obs"].shape[0]
        closs = critic_loss(self.module, self.target_params,
                            self.log_alpha.detach(), dev,
                            self.module.noise(n), cfg)
        self.critic_opt.update(grads_of(closs, self.critic_params),
                               self.opt_state["critic"], self.critic_params)
        aloss, logp = actor_loss(self.module, self.log_alpha.detach(),
                                 dev["obs"], self.module.noise(n))
        self.actor_opt.update(grads_of(aloss, self.actor_params),
                              self.opt_state["actor"], self.actor_params)
        # Alpha toward target entropy (ref: sac_learner.py alpha loss
        # -log_alpha * (logp + target_entropy)).
        lloss = -torch.mean(self.log_alpha * (logp + self.target_entropy))
        self.alpha_opt.update(grads_of(lloss, [self.log_alpha]),
                              self.opt_state["alpha"], [self.log_alpha])
        with torch.no_grad():
            for part in ("q1", "q2"):
                torch._foreach_lerp_(
                    list(self.target_params[part].parameters()),
                    list(getattr(self.module, part).parameters()), cfg.tau)
        self.num_updates += 1
        return metrics_of(_SAC_METRICS, [
            closs.detach(), aloss.detach(), torch.exp(self.log_alpha.detach()),
            -torch.mean(logp)])


class SACEnvRunner:
    """Continuous-action collector over a vector env, with ConnectorV2
    pipelines on both paths (ref: single_agent_env_runner.py driving
    env_to_module / module_to_env pipelines)."""

    def __init__(self, env_fn: Callable,
                 module_spec: ContinuousModuleSpec,
                 num_envs: int = 1, seed: int = 0,
                 env_to_module: Optional[ConnectorPipelineV2] = None,
                 module_to_env: Optional[ConnectorPipelineV2] = None):
        import gymnasium as gym

        self.envs = gym.vector.SyncVectorEnv(
            [lambda: env_fn() for _ in range(num_envs)],
            autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
        self.num_envs = num_envs
        self.module = SACModule(module_spec, "cpu", seed)
        self._armed = False
        low = self.envs.single_action_space.low
        high = self.envs.single_action_space.high
        self.env_to_module = env_to_module or ConnectorPipelineV2(
            [FlattenObs()])
        self.module_to_env = module_to_env or ConnectorPipelineV2(
            [RescaleActions(low, high), ClipActions(low, high)])
        self._obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs)
        self._completed: List[float] = []

    def set_weights(self, params) -> bool:
        self.module.load_state_dict(sac_params_from_numpy(params))
        self._armed = True
        return True

    def connector_states(self) -> Dict[str, Any]:
        return {"env_to_module": self.env_to_module.get_state(),
                "module_to_env": self.module_to_env.get_state()}

    def sample(self, num_steps: int, random_actions: bool = False
               ) -> Dict[str, np.ndarray]:
        """Returns transitions with MODULE-frame actions in [-1, 1]
        (what the learner trains on); env-frame actions exist only
        transiently on the module_to_env path."""
        assert self._armed or random_actions
        obs_b, act_b, rew_b, done_b, next_b = [], [], [], [], []
        for _ in range(num_steps):
            mod_obs = self.env_to_module({"obs": self._obs})["obs"]
            if random_actions:
                action = np.random.uniform(
                    -1.0, 1.0, (self.num_envs,
                                self.module.spec.action_dim)
                ).astype(np.float32)
            else:
                with torch.no_grad():
                    a, _ = self.module.sample_action(obs_tensor(mod_obs))
                action = a.numpy()
            env_action = self.module_to_env(
                {"actions": action})["actions"]
            next_obs, reward, term, trunc, info = self.envs.step(
                env_action)
            done = np.logical_or(term, trunc)
            stored_next = next_obs
            if done.any() and info.get("final_obs") is not None:
                stored_next = np.array(next_obs, copy=True)
                for i in np.nonzero(done)[0]:
                    fo = info["final_obs"][i]
                    if fo is not None:
                        stored_next[i] = np.asarray(fo)
            # Store the MODULE-frame view of both obs and action.
            next_mod = self.env_to_module({"obs": stored_next})["obs"]
            obs_b.append(mod_obs)
            act_b.append(action)
            rew_b.append(reward)
            done_b.append(term)      # bootstrap through truncation
            next_b.append(next_mod)
            self._episode_returns += reward
            for i, d in enumerate(done):
                if d:
                    self._completed.append(
                        float(self._episode_returns[i]))
                    self._episode_returns[i] = 0.0
            self._obs = next_obs
        return {
            "obs": np.concatenate(obs_b).astype(np.float32),
            "actions": np.concatenate(act_b).astype(np.float32),
            "rewards": np.concatenate(rew_b).astype(np.float32),
            "dones": np.concatenate(done_b).astype(np.float32),
            "next_obs": np.concatenate(next_b).astype(np.float32),
        }

    def episode_stats(self, window: int = 20) -> Dict[str, float]:
        recent = self._completed[-window:]
        return {"episodes_total": len(self._completed),
                "episode_return_mean":
                    float(np.mean(recent)) if recent else 0.0}


class ContinuousReplayBuffer:
    """Ring buffer with float action vectors (the DQN buffer stores
    int action scalars)."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, act_dim), np.float32)
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
                "rewards": self.rewards[idx],
                "dones": self.dones[idx]}


@dataclass
class SACConfig:
    env_fn: Optional[Callable] = None
    observation_dim: int = 0
    action_dim: int = 0
    hidden: tuple = (256, 256)
    num_env_runners: int = 1
    num_envs_per_runner: int = 1
    rollout_length: int = 64
    reward_scale: float = 1.0
    device: Optional[str] = None     # the learner's device; None = card
    train: SACTrainConfig = field(default_factory=SACTrainConfig)

    def environment(self, env_fn, *, observation_dim, action_dim,
                    reward_scale: float = 1.0):
        return replace(self, env_fn=env_fn,
                       observation_dim=observation_dim,
                       action_dim=action_dim,
                       reward_scale=reward_scale)

    def env_runners(self, **kw):
        return replace(self, **kw)

    def learners(self, *, device: Optional[str] = None):
        return replace(self, device=device)

    def training(self, **kw):
        return replace(self, train=replace(self.train, **kw))

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    """Off-policy control loop: runner actors collect → replay →
    learner updates → weight sync (ref: sac.py
    training_step shape shared with DQN)."""

    def __init__(self, config: SACConfig):
        assert config.env_fn is not None
        self.config = config
        spec = ContinuousModuleSpec(config.observation_dim,
                                    config.action_dim, config.hidden)
        from ..core import serialization

        from .actor_manager import (FaultTolerantActorManager,
                                    cpu_actor_class)

        serialization.ensure_code_portable(config.env_fn)
        self.learner = SACTorchLearner(spec, config.train,
                                       device=config.device)
        runner_cls = cpu_actor_class(SACEnvRunner)

        def factory(i):
            return runner_cls.remote(config.env_fn, spec,
                                     config.num_envs_per_runner,
                                     seed=4000 + 37 * i)

        def on_restore(actor):
            ray_tpu_torch.get(actor.set_weights.remote(
                self.learner.get_weights()), timeout=120)

        self._runners = FaultTolerantActorManager(
            factory, config.num_env_runners, on_restore=on_restore)
        self._runners.foreach("set_weights",
                              self.learner.get_weights())
        self.buffer = ContinuousReplayBuffer(
            config.train.buffer_capacity, config.observation_dim,
            config.action_dim)
        self._rng = np.random.default_rng(11)
        self.env_steps_total = 0
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        warmup = self.env_steps_total < cfg.train.learning_starts
        results = self._runners.foreach("sample", cfg.rollout_length,
                                        warmup)
        self._runners.restore_unhealthy()
        for r in results:
            if r.ok:
                tr = r.value
                if cfg.reward_scale != 1.0:
                    tr = {**tr,
                          "rewards": tr["rewards"] * cfg.reward_scale}
                self.buffer.add_batch(tr)
                self.env_steps_total += len(tr["actions"])
        metrics: Dict[str, float] = {}
        if len(self.buffer) >= cfg.train.learning_starts:
            for _ in range(cfg.train.updates_per_iteration):
                batch = self.buffer.sample(
                    self._rng, cfg.train.train_batch_size)
                metrics = self.learner.update_from_batch(batch)
            self._runners.foreach("set_weights",
                                  self.learner.get_weights())
            self._runners.restore_unhealthy()
        self.iteration += 1
        stats = [r.value for r in
                 self._runners.foreach("episode_stats", 20) if r.ok]
        return {
            "training_iteration": self.iteration,
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
