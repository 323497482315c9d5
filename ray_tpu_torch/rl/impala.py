"""IMPALA — asynchronous sampling with V-trace off-policy correction.

Counterpart of ``ray_tpu/rl/impala.py`` (ref:
rllib/algorithms/impala/impala.py:136 broadcast interval, :150
aggregator actors per learner; V-trace per Espeholt et al. 2018, the
public IMPALA paper).  Env runners sample CONTINUOUSLY (a new rollout
is requested the moment one lands), aggregator actors concatenate
rollouts into learner-sized batches off the driver, and the learner
actors apply V-trace-corrected policy-gradient updates on their device;
fresh weights broadcast every ``broadcast_interval`` updates, so
learning and acting overlap instead of alternating (the PPO train()
loop is synchronous by design; this one is not).

The update rule is the JAX learner's ``optax.chain(
clip_by_global_norm(40), rmsprop(lr, decay=0.99, eps=0.1))``.  optax's
RMSprop scales by ``1 / sqrt(nu + eps)``, eps inside the root, with
``nu`` starting at 0; ``torch.optim.RMSprop`` divides by ``sqrt(nu) +
eps``, and with eps = 0.1 the two steps differ by a large factor.  So
``ClippedRMSprop`` writes optax's step, as ``train_step.ClippedAdamW``
writes AdamW.

Learner actors on the card lease ``GPU: 1 / num_learners`` (the JAX
learners lease nothing); they average their weights over a ``cpu``
(gloo) collective group, learner to learner.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch

from ..device import resolve_device
from ..train.train_step import global_norm
from .convert import rl_params_from_numpy, rl_params_to_numpy
from .learner import as_tensors, grads_of, learner_actor_class, metrics_of
from .rl_module import RLModuleSpec, TorchRLModule


@dataclass
class VTraceConfig:
    lr: float = 6e-4
    gamma: float = 0.99
    rho_clip: float = 1.0
    c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 40.0


def vtrace_targets(values, last_value, rewards, discounts, rhos,
                   rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets vs_t and pg advantages ([T, N] tensors; backward
    recursion over T).  Both are detached, as the JAX function's
    ``stop_gradient`` does (with rho=c=1 they reduce to discounted
    n-step returns)."""
    rho_cl = torch.clamp(rhos, max=rho_clip)
    c_cl = torch.clamp(rhos, max=c_clip)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rho_cl * (rewards + discounts * next_values - values)
    acc = torch.zeros_like(last_value)
    accs = []
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * c_cl[t] * acc
        accs.append(acc)
    vs = values + torch.stack(accs[::-1])
    vs_next = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho_cl * (rewards + discounts * vs_next - values)
    return vs.detach(), pg_adv.detach()


class ClippedRMSprop:
    """``optax.chain(clip_by_global_norm(grad_clip), rmsprop(lr, decay,
    eps))`` over a list of parameters: ``nu = decay * nu + (1 - decay) *
    g**2`` from ``nu = 0``, then ``p -= lr * g / sqrt(nu + eps)``."""

    def __init__(self, lr: float, *, grad_clip: float, decay: float = 0.99,
                 eps: float = 0.1):
        self.lr, self.grad_clip = lr, grad_clip
        self.decay, self.eps = decay, eps

    def init(self, params: List[torch.Tensor]) -> Dict:
        return {"nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict,
               params: List[torch.Tensor]) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; returns
        the pre-clip global norm."""
        norm = global_norm(grads)
        clip = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        nu = state["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.decay)
        denom = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(denom)
        torch._foreach_mul_(denom, grads)
        torch._foreach_add_(params, denom, alpha=-self.lr)
        return norm


def vtrace_loss(module: TorchRLModule, batch: Dict[str, torch.Tensor],
                cfg: VTraceConfig):
    t, n = batch["rewards"].shape
    logits, values = module(batch["obs"].reshape(t * n, -1))
    logits = logits.reshape(t, n, -1)
    values = values.reshape(t, n)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
    rhos = torch.exp(logp - batch["logp"])
    discounts = cfg.gamma * (1.0 - batch["dones"])
    _, last_value = module(batch["last_obs"])
    vs, pg_adv = vtrace_targets(values, last_value, batch["rewards"],
                                discounts, rhos, cfg.rho_clip, cfg.c_clip)
    pi_loss = -torch.mean(logp * pg_adv)
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy = -torch.mean(
        torch.sum(torch.softmax(logits, dim=-1) * logp_all, dim=-1))
    total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
    return total, (pi_loss, vf_loss, entropy, torch.mean(rhos).detach())


_IMPALA_BATCH = ("obs", "actions", "rewards", "dones", "logp", "last_obs")
_IMPALA_METRICS = ("pi_loss", "vf_loss", "entropy", "mean_rho", "loss")


class ImpalaTorchLearner:
    """V-trace actor-critic update on ``device`` (``None``: the card)."""

    def __init__(self, module_spec: RLModuleSpec,
                 config: Optional[VTraceConfig] = None, seed: int = 0,
                 device=None):
        self.cfg = config or VTraceConfig()
        self.device = resolve_device(device)
        self.module = TorchRLModule(module_spec, self.device, seed)
        self.params = list(self.module.parameters())
        self.optimizer = ClippedRMSprop(self.cfg.lr,
                                        grad_clip=self.cfg.grad_clip)
        self.opt_state = self.optimizer.init(self.params)
        self.num_updates = 0

    def get_weights(self):
        return rl_params_to_numpy(self.module.state_dict())

    def set_weights(self, params) -> bool:
        self.module.load_state_dict(rl_params_from_numpy(params))
        return True

    def sync_weights_collective(self, group_name: str) -> bool:
        """Average params with the other learners DIRECTLY, learner-to-
        learner over the collective group — the driver never sees the
        tensors (ref: rllib/core/learner/learner_group.py collective
        weight sync)."""
        from .. import collective as col

        flat = torch.nn.utils.parameters_to_vector(self.params).detach()
        mean = col.allreduce(flat, group_name, op=col.ReduceOp.MEAN)
        with torch.no_grad():
            for p, m in zip(self.params,
                            mean.split([p.numel() for p in self.params])):
                p.copy_(m.view_as(p))
        return True

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        dev = as_tensors(batch, _IMPALA_BATCH, self.device)
        loss, aux = vtrace_loss(self.module, dev, self.cfg)
        self.optimizer.update(grads_of(loss, self.params), self.opt_state,
                              self.params)
        self.num_updates += 1
        return metrics_of(_IMPALA_METRICS, [*aux, loss.detach()])


class Aggregator:
    """Batches rollouts for one learner, off the driver (ref:
    impala.py:150 AggregatorActor per learner)."""

    def __init__(self):
        self._buf: List[Dict[str, np.ndarray]] = []

    def add(self, rollout: Dict[str, np.ndarray]) -> int:
        self._buf.append(rollout)
        return len(self._buf)

    def drain(self) -> Optional[Dict[str, np.ndarray]]:
        """Concatenate buffered rollouts over the env axis into one
        learner batch (keeps [T, N] layout for V-trace)."""
        if not self._buf:
            return None
        rollouts, self._buf = self._buf, []
        out: Dict[str, np.ndarray] = {}
        for k in rollouts[0]:
            axis = 0 if k in ("last_values", "last_obs") else 1
            out[k] = np.concatenate([r[k] for r in rollouts], axis=axis)
        return out

    def size(self) -> int:
        return len(self._buf)


@dataclass
class IMPALAConfig:
    env_fn: Optional[Callable] = None
    observation_dim: int = 0
    action_dim: int = 0
    hidden: tuple = (64, 64)
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_length: int = 64
    num_learners: int = 1
    device: Optional[str] = None     # the learners' device; None = card
    rollouts_per_batch: int = 2      # aggregator drain threshold
    broadcast_interval: int = 2      # updates between weight syncs
    vtrace: VTraceConfig = field(default_factory=VTraceConfig)

    def environment(self, env_fn, *, observation_dim, action_dim):
        return replace(self, env_fn=env_fn,
                       observation_dim=observation_dim,
                       action_dim=action_dim)

    def env_runners(self, **kw):
        return replace(self, **kw)

    def learners(self, *, num_learners: int = 1,
                 device: Optional[str] = None):
        return replace(self, num_learners=num_learners, device=device)

    def training(self, **vtrace_kw):
        return replace(self, vtrace=replace(self.vtrace, **vtrace_kw))

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """Async control loop: continuous sampling -> aggregators ->
    concurrent learner updates -> periodic broadcast."""

    def __init__(self, config: IMPALAConfig):
        assert config.env_fn is not None, "config.environment(...) first"
        assert config.num_learners >= 1
        self.config = config
        spec = RLModuleSpec(config.observation_dim, config.action_dim,
                            config.hidden)
        from .env_runner import EnvRunnerGroup

        learner_cls, dev = learner_actor_class(
            ImpalaTorchLearner, config.num_learners,
            resolve_device(config.device))
        self.learners = [learner_cls.remote(spec, config.vtrace, seed=0,
                                            device=dev)
                         for _ in range(config.num_learners)]
        agg_cls = ray_tpu_torch.remote(Aggregator)
        self.aggregators = [agg_cls.remote()
                            for _ in range(config.num_learners)]
        self.env_runner_group = EnvRunnerGroup(
            config.env_fn, spec, config.num_env_runners,
            config.num_envs_per_runner, gamma=config.vtrace.gamma)
        # Learners form a host collective group; weight averaging runs
        # learner-to-learner instead of through the driver.
        self._col_group = None
        if config.num_learners > 1:
            from .. import collective as col

            self._col_group = ("impala/"
                               + self.learners[0].actor_id.hex()[:12])
            col.create_collective_group(
                self.learners, config.num_learners,
                list(range(config.num_learners)), backend="cpu",
                group_name=self._col_group)
        self._weights = ray_tpu_torch.get(
            self.learners[0].get_weights.remote())
        self.env_runner_group.set_weights(self._weights)
        # runner -> in-flight sample ref (continuous sampling).
        self._inflight: Dict[int, Any] = {}
        self._agg_counts = [0] * config.num_learners
        self._next_agg = 0
        self.iteration = 0
        self._updates_since_broadcast = 0
        self.num_updates = 0

    # ------------------------------------------------------------ plumbing
    def _prime(self) -> None:
        for i, runner in enumerate(self.env_runner_group.runners):
            if i not in self._inflight:
                self._inflight[i] = runner.sample.remote(
                    self.config.rollout_length)

    def _route_ready(self, timeout: float) -> int:
        """Move completed rollouts into aggregators (BY REFERENCE — the
        rollout never lands on the driver) and resubmit sampling on
        those runners."""
        refs = list(self._inflight.values())
        if not refs:
            return 0
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        routed = 0
        ready_ids = {r.id for r in ready}
        runners = self.env_runner_group.runners
        mgr = self.env_runner_group._mgr
        for idx, ref in list(self._inflight.items()):
            if ref.id not in ready_ids:
                continue
            del self._inflight[idx]
            ok = True
            k = self._next_agg
            self._next_agg = (k + 1) % len(self.aggregators)
            try:
                self._agg_counts[k] = ray_tpu_torch.get(
                    self.aggregators[k].add.remote(ref), timeout=60)
                routed += 1
            except Exception:
                # Rollout lost with its runner: mark it so we stop
                # resubmitting to a corpse (an instantly-errored ref
                # would otherwise busy-spin the fill loop).
                ok = False
                mgr.mark_unhealthy(idx)
            if ok and idx < len(runners):
                try:
                    self._inflight[idx] = runners[idx].sample.remote(
                        self.config.rollout_length)
                except Exception:
                    mgr.mark_unhealthy(idx)
        if not self._inflight:
            # Every runner died: restore the fleet (weights re-armed by
            # on_restore) and resume sampling.
            mgr.restore_unhealthy()
            self._prime()
        return routed

    # -------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        """One iteration = every learner applies one batch (ref:
        Algorithm.step for IMPALA — async sampling continues
        throughout)."""
        cfg = self.config
        t0 = time.perf_counter()
        self._prime()
        # Fill each aggregator to the batch threshold.
        deadline = time.time() + 300
        update_refs: List[Any] = []
        for k, (learner, agg) in enumerate(
                zip(self.learners, self.aggregators)):
            while self._agg_counts[k] < cfg.rollouts_per_batch:
                if time.time() > deadline:
                    raise TimeoutError("rollouts starved")
                self._route_ready(timeout=10.0)
                mgr = self.env_runner_group._mgr
                if mgr.num_healthy() < len(mgr.actors):
                    mgr.restore_unhealthy()
                    self._prime()
            batch_ref = agg.drain.remote()
            self._agg_counts[k] = 0
            update_refs.append(
                learner.update_from_batch.remote(batch_ref))
        metrics_list = ray_tpu_torch.get(update_refs, timeout=300)
        self.num_updates += 1
        self._updates_since_broadcast += 1
        if self._updates_since_broadcast >= cfg.broadcast_interval:
            self._broadcast()
        self.iteration += 1
        # Tight window: async sampling improves the policy fast enough
        # that a 100-episode mean lags far behind current behavior.
        stats = self.env_runner_group.stats(window=20)
        # Steps actually consumed: each learner drained
        # rollouts_per_batch rollouts this iteration.
        steps = (cfg.rollout_length * cfg.num_envs_per_runner
                 * cfg.rollouts_per_batch * cfg.num_learners)
        out: Dict[str, Any] = {
            "training_iteration": self.iteration,
            "env_steps_this_iter": steps,
            "episode_return_mean": float(np.mean(
                [s["episode_return_mean"] for s in stats]))
            if stats else 0.0,
            "episodes_total": int(sum(s["episodes_total"]
                                      for s in stats)),
            "num_env_runner_restarts":
                self.env_runner_group.num_restarts,
            "time_this_iter_s": time.perf_counter() - t0,
        }
        for k in metrics_list[0]:
            out[k] = float(np.mean([m[k] for m in metrics_list]))
        return out

    def _broadcast(self) -> None:
        """Sync learner params (collective mean across learners, off
        the driver), then push the result to the runners (ref:
        impala.py:136 broadcast_interval).  Only ONE learner's weights
        transit the driver — for the env runners, which need them
        anyway."""
        if self._col_group is not None:
            ray_tpu_torch.get(
                [ln.sync_weights_collective.remote(self._col_group)
                 for ln in self.learners], timeout=120)
        mean_w = ray_tpu_torch.get(self.learners[0].get_weights.remote(),
                                   timeout=120)
        self._weights = mean_w
        self.env_runner_group.set_weights(mean_w)
        self._updates_since_broadcast = 0

    def get_weights(self):
        return self._weights

    def stop(self) -> None:
        self.env_runner_group.shutdown()
        for a in self.learners + self.aggregators:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
