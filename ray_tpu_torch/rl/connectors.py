"""ConnectorV2 — composable transforms between env and module.

A copy of ``ray_tpu/rl/connectors.py`` (numpy only).  Role-equivalent
to the reference's connector pipelines (ref:
rllib/connectors/connector_v2.py ConnectorV2 and
connector_pipeline_v2.py): small callables that massage data on the
env→module path (observation preprocessing before forward passes) and
the module→env path (action post-processing before env.step), so those
transforms are configuration, not hardcoded runner logic.

Deviation from the reference: connectors here transform plain numpy
batch dicts ({"obs": ...} / {"actions": ...}) instead of episode
lists — the runners are vector-env batch-shaped end to end.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

Batch = Dict[str, Any]


class ConnectorV2:
    """One transform stage: __call__(batch) -> batch (may mutate).
    Stateful connectors (e.g. running normalizers) expose
    get_state/set_state so weights sync can carry them to runners."""

    def __call__(self, batch: Batch) -> Batch:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipelineV2(ConnectorV2):
    """Runs connectors in order (ref: connector_pipeline_v2.py)."""

    def __init__(self, connectors: Optional[Sequence[ConnectorV2]]
                 = None):
        self.connectors: List[ConnectorV2] = list(connectors or [])

    def __call__(self, batch: Batch) -> Batch:
        for c in self.connectors:
            batch = c(batch)
        return batch

    def append(self, connector: ConnectorV2) -> "ConnectorPipelineV2":
        self.connectors.append(connector)
        return self

    def get_state(self) -> Dict[str, Any]:
        return {str(i): c.get_state()
                for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])


# --------------------------------------------------- env -> module stages
class FlattenObs(ConnectorV2):
    """[N, ...] observation -> [N, prod(...)] float32 (ref:
    connectors/env_to_module/flatten_observations.py)."""

    def __call__(self, batch: Batch) -> Batch:
        obs = np.asarray(batch["obs"])
        batch["obs"] = obs.reshape(obs.shape[0], -1).astype(np.float32)
        return batch


class NormalizeObs(ConnectorV2):
    """Running mean/std normalization (Welford), frozen at inference
    via update=False (ref: connectors/env_to_module/
    mean_std_filter.py)."""

    def __init__(self, clip: float = 10.0, update: bool = True):
        self.clip = clip
        self.update = update
        self._count = 0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, batch: Batch) -> Batch:
        obs = np.asarray(batch["obs"], np.float32)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[1:], np.float64)
            self._m2 = np.zeros(obs.shape[1:], np.float64)
        if self.update:
            for row in obs:
                self._count += 1
                d = row - self._mean
                self._mean += d / self._count
                self._m2 += d * (row - self._mean)
        if self._count < 2:
            # Too few samples for a variance estimate (e.g. a frozen
            # inference copy running before the first state sync):
            # pass observations through near-identity instead of
            # dividing by ~1e-8 and saturating everything at ±clip.
            std = np.ones_like(self._mean)
        else:
            std = np.sqrt(self._m2 / (self._count - 1)) + 1e-8
        batch["obs"] = np.clip((obs - self._mean) / std,
                               -self.clip, self.clip).astype(np.float32)
        return batch

    def get_state(self) -> Dict[str, Any]:
        return {"count": self._count, "mean": self._mean,
                "m2": self._m2}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


# --------------------------------------------------- module -> env stages
class RescaleActions(ConnectorV2):
    """Map policy actions in [-1, 1] onto the env's Box bounds (ref:
    connectors/module_to_env/unsquash_to_env_action_space —
    tanh-squashed policies emit [-1, 1])."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, batch: Batch) -> Batch:
        a = np.asarray(batch["actions"], np.float32)
        batch["actions"] = self.low + (a + 1.0) * 0.5 * (self.high
                                                         - self.low)
        return batch


class ClipActions(ConnectorV2):
    """Clip actions into the env's Box bounds (ref:
    connectors/module_to_env/clip_actions)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, batch: Batch) -> Batch:
        batch["actions"] = np.clip(np.asarray(batch["actions"],
                                              np.float32),
                                   self.low, self.high)
        return batch
