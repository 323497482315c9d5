"""FaultTolerantActorManager — elastic actor fleets for RL.

A copy of ``ray_tpu/rl/actor_manager.py`` over the port's runtime.
Role-equivalent to the reference's FaultTolerantActorManager (ref:
rllib/utils/actor_manager.py:198): fan calls out to a fleet, tag
per-actor success/failure instead of raising, mark failed actors
unhealthy, and restore them from a factory so a killed env-runner or
learner mid-iteration is absorbed rather than fatal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import ray_tpu_torch


def cpu_actor_class(cls):
    """``cls`` as an actor class for work on the CPU (env runners,
    learners given ``device="cpu"``).  Its process runs one intra-op
    thread, as its lease holds one CPU: torch's pool otherwise starts a
    thread per core in every process, and a fleet of runners and
    learners on one host then spends its time contending for cores."""
    return ray_tpu_torch.remote(cls).options(
        runtime_env={"env_vars": {"OMP_NUM_THREADS": "1"}})


@dataclass
class CallResult:
    actor_index: int
    ok: bool
    value: Any = None
    error: Optional[BaseException] = None


class FaultTolerantActorManager:
    def __init__(self, factory: Callable[[int], Any], num_actors: int,
                 on_restore: Optional[Callable[[Any], None]] = None):
        """``factory(i)`` creates actor i; ``on_restore(actor)`` re-arms
        a fresh replacement (e.g. pushes current weights)."""
        self._factory = factory
        self._on_restore = on_restore
        self._actors: List[Any] = [factory(i) for i in range(num_actors)]
        self._healthy: List[bool] = [True] * num_actors
        self.num_restarts = 0

    # ------------------------------------------------------------- access
    @property
    def actors(self) -> List[Any]:
        return list(self._actors)

    def healthy_actors(self) -> List[Any]:
        return [a for a, h in zip(self._actors, self._healthy) if h]

    def num_healthy(self) -> int:
        return sum(self._healthy)

    def is_healthy(self, index: int) -> bool:
        return self._healthy[index]

    def mark_unhealthy(self, index: int) -> None:
        """For callers that talk to actors directly (outside foreach)
        and observe a failure."""
        self._healthy[index] = False

    # -------------------------------------------------------------- calls
    def foreach(self, method: str, *args, timeout: float = 120.0,
                healthy_only: bool = True, **kwargs) -> List[CallResult]:
        """Invoke ``method`` on each (healthy) actor; never raises for a
        single actor's death — the result is tagged and the actor is
        marked unhealthy (ref: foreach_actor remote_actor_ids +
        mark_unhealthy semantics)."""
        targets = [(i, a) for i, a in enumerate(self._actors)
                   if not healthy_only or self._healthy[i]]
        refs = []
        for i, a in targets:
            try:
                refs.append((i, getattr(a, method).remote(*args,
                                                          **kwargs)))
            except Exception as e:  # noqa: BLE001 — submit-time death
                refs.append((i, e))
        out: List[CallResult] = []
        for i, ref in refs:
            if isinstance(ref, Exception):
                self._healthy[i] = False
                out.append(CallResult(i, False, error=ref))
                continue
            try:
                out.append(CallResult(
                    i, True, value=ray_tpu_torch.get(ref, timeout=timeout)))
            except Exception as e:  # noqa: BLE001 — actor died mid-call
                self._healthy[i] = False
                out.append(CallResult(i, False, error=e))
        return out

    # ------------------------------------------------------------ healing
    def restore_unhealthy(self) -> int:
        """Recreate every unhealthy actor; returns how many restarted
        (ref: FaultTolerantActorManager probe_unhealthy_actors +
        restored-actor state sync in EnvRunnerGroup)."""
        restored = 0
        for i, healthy in enumerate(self._healthy):
            if healthy:
                continue
            try:
                ray_tpu_torch.kill(self._actors[i])
            except Exception:
                pass
            actor = self._factory(i)
            if self._on_restore is not None:
                try:
                    self._on_restore(actor)
                except Exception:
                    # Stays unhealthy; retry next round — and reap the
                    # half-armed replacement so it can't leak.
                    try:
                        ray_tpu_torch.kill(actor)
                    except Exception:
                        pass
                    continue
            self._actors[i] = actor
            self._healthy[i] = True
            self.num_restarts += 1
            restored += 1
        return restored

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
