"""Multi-agent RL: MultiAgentEnv, MultiRLModule, runner + PPO trainer.

Role-equivalent to the reference's multi-agent stack:
- ``MultiAgentEnv`` (ref: rllib/env/multi_agent_env.py:29) — dict-keyed
  observe/step protocol with the ``__all__`` done convention;
- ``MultiRLModule`` (ref: rllib/core/rl_module/multi_rl_module.py:49) —
  a container of per-policy modules with an agent→module mapping;
- ``MultiAgentEnvRunner`` (ref: rllib/env/multi_agent_env_runner.py) —
  collects per-MODULE batches by routing each agent's transitions
  through the policy mapping and per-module connector pipelines;
- ``MultiAgentPPO`` — per-module PPO learners stepped from one driver
  loop (ref: the PPO config's multi_agent(policies=...,
  policy_mapping_fn=...) surface in algorithm_config.py).

Counterpart of ``ray_tpu/rl/multi_agent.py``.  Forward passes batch
across (env, agent) slots per module, so one exploration call serves
every agent mapped to that module regardless of how many envs are
vectorized.  Runners keep their modules on the CPU, the device of their
lease; the learners run on ``device`` (``None``: the card).

Scope (documented deviation): agents must share the episode boundary —
per-agent early termination inside a live episode is not modeled (the
reference's MultiAgentEpisode tracks ragged per-agent histories; the
batch-shaped runner keeps fixed [T, slots] panels instead).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch

from .connectors import ConnectorPipelineV2
from .convert import rl_params_from_numpy, rl_params_to_numpy
from .env_runner import obs_tensor
from .learner import LearnerGroup, PPOConfig
from .rl_module import RLModuleSpec, TorchRLModule

AgentID = str
ModuleID = str


class MultiAgentEnv:
    """Dict-keyed multi-agent environment protocol (ref:
    rllib/env/multi_agent_env.py:29).

    ``reset() -> (obs_dict, info_dict)`` and
    ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
    infos)`` where every mapping is keyed by agent id and the done
    dicts carry the ``"__all__"`` aggregate key.
    """

    #: Static agent roster (ref: possible_agents).
    possible_agents: List[AgentID] = []

    def reset(self, *, seed: Optional[int] = None
              ) -> Tuple[Dict[AgentID, Any], Dict]:
        raise NotImplementedError

    def step(self, actions: Dict[AgentID, Any]) -> Tuple[
            Dict[AgentID, Any], Dict[AgentID, float],
            Dict[str, bool], Dict[str, bool], Dict]:
        raise NotImplementedError


@dataclass(frozen=True)
class MultiRLModuleSpec:
    """Per-policy module specs (ref: multi_rl_module.py:49
    MultiRLModuleSpec — a dict of single-module specs)."""

    module_specs: Dict[ModuleID, RLModuleSpec]


class MultiTorchRLModule:
    """Container of per-policy TorchRLModules sharing nothing but the
    call convention (ref: MultiRLModule holding RLModules keyed by
    module id).  Module ``i`` in sorted id order is seeded ``seed + i``
    (its weights and its sampling generator)."""

    def __init__(self, spec: MultiRLModuleSpec, device=None,
                 seed: int = 0):
        self.spec = spec
        self.modules: Dict[ModuleID, TorchRLModule] = {
            mid: TorchRLModule(spec.module_specs[mid], device, seed + i)
            for i, mid in enumerate(sorted(spec.module_specs))}

    def get_weights(self) -> Dict[ModuleID, Any]:
        return {mid: rl_params_to_numpy(m.state_dict())
                for mid, m in self.modules.items()}

    def set_weights(self, params: Dict[ModuleID, Any]) -> None:
        for mid, p in params.items():
            self.modules[mid].load_state_dict(rl_params_from_numpy(p))


class MultiAgentEnvRunner:
    """Rollout collector over K copies of a MultiAgentEnv.

    Each (env, agent) pair is one column of its module's [T, slots]
    rollout panel; one forward per MODULE serves all its slots in one
    batch.  Episodes end on ``__all__`` and the env resets
    in-place, so panels stay rectangular (see module docstring).
    """

    def __init__(self, env_fn: Callable[[], MultiAgentEnv],
                 multi_spec: MultiRLModuleSpec,
                 policy_mapping_fn: Callable[[AgentID], ModuleID],
                 num_envs: int = 1, seed: int = 0, gamma: float = 0.99,
                 env_to_module: Optional[
                     Dict[ModuleID, ConnectorPipelineV2]] = None):
        self.envs = [env_fn() for _ in range(num_envs)]
        self.num_envs = num_envs
        self.mapping = policy_mapping_fn
        self.multi = MultiTorchRLModule(multi_spec, "cpu", seed)
        self.gamma = gamma
        self.connectors = env_to_module or {}
        self._armed = False
        # Fixed slot layout: module_id -> [(env_idx, agent_id), ...].
        self.agents = list(self.envs[0].possible_agents)
        self.slots: Dict[ModuleID, List[Tuple[int, AgentID]]] = {}
        for e in range(num_envs):
            for aid in self.agents:
                self.slots.setdefault(self.mapping(aid), []).append(
                    (e, aid))
        self._obs: List[Dict[AgentID, Any]] = []
        for e, env in enumerate(self.envs):
            obs, _ = env.reset(seed=seed + e)
            self._obs.append(obs)
        self._ep_returns = {
            aid: np.zeros(num_envs) for aid in self.agents}
        self._completed: Dict[AgentID, List[float]] = {
            aid: [] for aid in self.agents}

    def set_weights(self, params: Dict[ModuleID, Any]) -> bool:
        self.multi.set_weights(params)
        self._armed = True
        return True

    def _module_obs(self, mid: ModuleID) -> np.ndarray:
        rows = [np.asarray(self._obs[e][aid], np.float32)
                for e, aid in self.slots[mid]]
        batch = {"obs": np.stack(rows)}
        pipe = self.connectors.get(mid)
        if pipe is not None:
            batch = pipe(batch)
        return batch["obs"]

    def sample(self, num_steps: int
               ) -> Dict[ModuleID, Dict[str, np.ndarray]]:
        assert self._armed, "set_weights first"
        acc = {mid: {k: [] for k in ("obs", "actions", "rewards",
                                     "dones", "logp", "values")}
               for mid in self.slots}
        for _ in range(num_steps):
            # One batched forward per module over all its slots.
            step_actions: List[Dict[AgentID, Any]] = [
                {} for _ in range(self.num_envs)]
            for mid, slots in self.slots.items():
                obs = self._module_obs(mid)
                action, logp, value = self.multi.modules[
                    mid].forward_exploration(obs_tensor(obs))
                action = action.numpy()
                acc[mid]["obs"].append(obs)
                acc[mid]["actions"].append(action)
                acc[mid]["logp"].append(logp.numpy())
                acc[mid]["values"].append(value.numpy())
                for s, (e, aid) in enumerate(slots):
                    step_actions[e][aid] = action[s]
            rewards = {mid: np.zeros(len(s), np.float32)
                       for mid, s in self.slots.items()}
            dones = {mid: np.zeros(len(s), np.float32)
                     for mid, s in self.slots.items()}
            for e, env in enumerate(self.envs):
                obs, rew, term, trunc, _info = env.step(step_actions[e])
                done_all = bool(term.get("__all__")
                                or trunc.get("__all__"))
                for aid in self.agents:
                    self._ep_returns[aid][e] += rew.get(aid, 0.0)
                if done_all:
                    for aid in self.agents:
                        self._completed[aid].append(
                            float(self._ep_returns[aid][e]))
                        self._ep_returns[aid][e] = 0.0
                    obs, _ = env.reset()
                self._obs[e] = obs
                for mid, slots in self.slots.items():
                    for s, (se, aid) in enumerate(slots):
                        if se == e:
                            rewards[mid][s] = rew.get(aid, 0.0)
                            dones[mid][s] = float(done_all)
            for mid in self.slots:
                acc[mid]["rewards"].append(rewards[mid])
                acc[mid]["dones"].append(dones[mid])
        out: Dict[ModuleID, Dict[str, np.ndarray]] = {}
        for mid, slots in self.slots.items():
            obs = self._module_obs(mid)
            with torch.no_grad():
                last_value = self.multi.modules[mid](obs_tensor(obs))[1]
            out[mid] = {
                "obs": np.stack(acc[mid]["obs"]),
                "actions": np.stack(acc[mid]["actions"]),
                "rewards": np.stack(acc[mid]["rewards"]),
                "dones": np.stack(acc[mid]["dones"]),
                "logp": np.stack(acc[mid]["logp"]).astype(np.float32),
                "values": np.stack(acc[mid]["values"]).astype(
                    np.float32),
                "last_values": last_value.numpy().astype(np.float32),
                "last_obs": np.asarray(obs, np.float32),
            }
        return out

    def episode_stats(self, window: int = 100
                      ) -> Dict[AgentID, Dict[str, float]]:
        out = {}
        for aid, rets in self._completed.items():
            recent = rets[-window:]
            out[aid] = {
                "episodes_total": len(rets),
                "episode_return_mean":
                    float(np.mean(recent)) if recent else 0.0}
        return out


class MultiAgentEnvRunnerGroup:
    """N multi-agent runner actors with broadcast + fault tolerance
    (same fleet shape as the single-agent EnvRunnerGroup)."""

    def __init__(self, env_fn, multi_spec, policy_mapping_fn,
                 num_runners: int = 1, num_envs_per_runner: int = 1,
                 gamma: float = 0.99, env_to_module=None):
        from ..core import serialization

        from .actor_manager import (FaultTolerantActorManager,
                                    cpu_actor_class)

        serialization.ensure_code_portable(env_fn)
        actor_cls = cpu_actor_class(MultiAgentEnvRunner)
        self._weights = None

        def factory(i: int):
            return actor_cls.remote(
                env_fn, multi_spec, policy_mapping_fn,
                num_envs_per_runner, seed=1000 + 17 * i, gamma=gamma,
                env_to_module=env_to_module)

        def on_restore(actor):
            if self._weights is not None:
                ray_tpu_torch.get(
                    actor.set_weights.remote(self._weights), timeout=120)

        self._mgr = FaultTolerantActorManager(
            factory, num_runners, on_restore=on_restore)

    def set_weights(self, params) -> None:
        self._weights = params
        self._mgr.foreach("set_weights", params)
        self._mgr.restore_unhealthy()

    def sample(self, num_steps: int) -> List[Dict]:
        results = self._mgr.foreach("sample", num_steps)
        rollouts = [r.value for r in results if r.ok]
        self._mgr.restore_unhealthy()
        if not rollouts:
            raise RuntimeError("every env runner failed this iteration")
        return rollouts

    def stats(self, window: int = 100) -> List[Dict]:
        return [r.value for r in
                self._mgr.foreach("episode_stats", window) if r.ok]

    def shutdown(self) -> None:
        self._mgr.shutdown()


@dataclass
class MultiAgentConfig:
    """Fluent config for multi-agent PPO (ref: the multi_agent()
    surface of algorithm_config.py + PPOConfig training knobs)."""

    env_fn: Optional[Callable] = None
    module_specs: Dict[ModuleID, RLModuleSpec] = field(
        default_factory=dict)
    policy_mapping: Optional[Callable[[AgentID], ModuleID]] = None
    num_env_runners: int = 1
    num_envs_per_runner: int = 2
    rollout_length: int = 64
    num_learners: int = 0
    device: Optional[str] = None    # the learners' device; None = card
    ppo: PPOConfig = field(default_factory=PPOConfig)
    env_to_module: Optional[Dict[ModuleID, ConnectorPipelineV2]] = None

    def environment(self, env_fn) -> "MultiAgentConfig":
        return replace(self, env_fn=env_fn)

    def multi_agent(self, *, policies: Dict[ModuleID, RLModuleSpec],
                    policy_mapping_fn: Callable[[AgentID], ModuleID],
                    env_to_module=None) -> "MultiAgentConfig":
        return replace(self, module_specs=dict(policies),
                       policy_mapping=policy_mapping_fn,
                       env_to_module=env_to_module)

    def env_runners(self, *, num_env_runners: int = 1,
                    num_envs_per_runner: int = 2,
                    rollout_length: int = 64) -> "MultiAgentConfig":
        return replace(self, num_env_runners=num_env_runners,
                       num_envs_per_runner=num_envs_per_runner,
                       rollout_length=rollout_length)

    def training(self, **ppo_kwargs) -> "MultiAgentConfig":
        return replace(self, ppo=replace(self.ppo, **ppo_kwargs))

    def learners(self, *, num_learners: int = 0,
                 device: Optional[str] = None) -> "MultiAgentConfig":
        return replace(self, num_learners=num_learners, device=device)

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """PPO over a MultiRLModule: one LearnerGroup per module id, one
    shared multi-agent runner fleet (ref: Algorithm.training_step
    looping modules through the learner group's multi-module update)."""

    def __init__(self, config: MultiAgentConfig):
        assert config.env_fn is not None, "config.environment(...) first"
        assert config.module_specs, "config.multi_agent(...) first"
        self.config = config
        spec = MultiRLModuleSpec(dict(config.module_specs))
        self.learners: Dict[ModuleID, LearnerGroup] = {
            mid: LearnerGroup(ms, config.ppo, config.num_learners,
                              device=config.device)
            for mid, ms in config.module_specs.items()}
        self.env_runner_group = MultiAgentEnvRunnerGroup(
            config.env_fn, spec, config.policy_mapping,
            config.num_env_runners, config.num_envs_per_runner,
            gamma=config.ppo.gamma, env_to_module=config.env_to_module)
        self.iteration = 0
        self._weights = {mid: lg.get_weights()
                         for mid, lg in self.learners.items()}
        self.env_runner_group.set_weights(self._weights)

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        rollouts = self.env_runner_group.sample(
            self.config.rollout_length)
        metrics: Dict[str, Any] = {}
        for mid, lg in self.learners.items():
            mod_rollouts = [r[mid] for r in rollouts if mid in r]
            if not mod_rollouts:
                continue
            m = lg.update(mod_rollouts)
            metrics.update({f"{mid}/{k}": v for k, v in m.items()})
        self._weights = {mid: lg.get_weights()
                         for mid, lg in self.learners.items()}
        self.env_runner_group.set_weights(self._weights)
        self.iteration += 1
        stats = self.env_runner_group.stats()
        per_agent: Dict[str, List[float]] = {}
        for s in stats:
            for aid, d in s.items():
                per_agent.setdefault(aid, []).append(
                    d["episode_return_mean"])
        for aid, vals in per_agent.items():
            metrics[f"episode_return_mean/{aid}"] = float(
                np.mean(vals))
        metrics["training_iteration"] = self.iteration
        metrics["time_this_iter_s"] = time.perf_counter() - t0
        return metrics

    def get_weights(self) -> Dict[ModuleID, Any]:
        return self._weights

    def stop(self) -> None:
        self.env_runner_group.shutdown()
        for lg in self.learners.values():
            lg.shutdown()
