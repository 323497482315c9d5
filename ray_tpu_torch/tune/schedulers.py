"""Trial schedulers: FIFO and ASHA (asynchronous successive halving).

Role-equivalent to the reference's tune.schedulers (ref:
python/ray/tune/schedulers/async_hyperband.py ASHAScheduler).  The
controller calls ``on_result`` for every report; the scheduler answers
CONTINUE or STOP.  Counterpart of ``ray_tpu/tune/schedulers.py``.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"          # culled by the scheduler (under-performing)
COMPLETE = "COMPLETE"  # budget (max_t) reached — a normal finish


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE


class ASHAScheduler:
    """Asynchronous successive halving on ``metric`` at rungs
    grace_period * reduction_factor^k."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.eta = reduction_factor
        self.time_attr = time_attr
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        # rung milestone -> list of recorded metric values
        self.recorded: Dict[int, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return COMPLETE  # budget exhausted — not a cull
        for rung in reversed(self.rungs):
            if t == rung:
                peers = self.recorded[rung]
                peers.append(float(value))
                if len(peers) < self.eta:
                    return CONTINUE  # not enough peers; be optimistic
                ranked = sorted(peers)
                if self.mode == "max":
                    ranked = ranked[::-1]
                cutoff_idx = max(len(ranked) // self.eta - 1, 0)
                cutoff = ranked[cutoff_idx]
                good = (value <= cutoff if self.mode == "min"
                        else value >= cutoff)
                return CONTINUE if good else STOP
        return CONTINUE


class PopulationBasedTraining:
    """PBT (ref: tune/schedulers/pbt.py; the public PBT paper): every
    ``perturbation_interval`` iterations a bottom-quantile trial
    EXPLOITs a top-quantile trial (adopting its checkpoint) and
    EXPLOREs by mutating hyperparameters.

    Population-level decisions need population state, so this scheduler
    implements ``on_population_result(trial, result, trials)`` and
    returns either CONTINUE or a dict
    {"exploit": source_trial, "config": mutated_config} which the Tuner
    applies by restarting the trial from the source's checkpoint.
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: int = 0):
        import random

        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self.num_exploits = 0

    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE  # population hook drives PBT

    # ------------------------------------------------------------- explore
    def _mutate(self, config: Dict) -> Dict:
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if callable(spec):
                out[key] = spec()
            elif isinstance(spec, (list, tuple)):
                # Perturb to an ADJACENT list entry (ref: pbt.py
                # _explore — list-valued hyperparams step to a
                # neighboring index, they are not re-drawn uniformly;
                # a uniform draw can hand the exploited trial the very
                # value it is being rescued from).
                choices = list(spec)
                try:
                    idx = choices.index(out[key])
                except ValueError:
                    out[key] = self._rng.choice(choices)
                    continue
                if len(choices) == 1:
                    continue
                if idx == 0:
                    idx = 1
                elif idx == len(choices) - 1:
                    idx = len(choices) - 2
                else:
                    idx = idx + self._rng.choice((-1, 1))
                out[key] = choices[idx]
            else:  # continuous: the classic 0.8x / 1.2x perturbation
                factor = self._rng.choice((0.8, 1.2))
                out[key] = type(out[key])(out[key] * factor)
        return out

    # ------------------------------------------------------------- exploit
    def on_population_result(self, trial, result: Dict, trials):
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t - self._last_perturb.get(trial.trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        # Rank the population by its latest metric.
        scored = []
        for other in trials:
            m = other.last_metrics().get(self.metric)
            if m is not None:
                scored.append((float(m), other))
        if len(scored) < 2:
            return CONTINUE
        reverse = self.mode == "max"
        scored.sort(key=lambda x: x[0], reverse=reverse)
        k = max(1, int(len(scored) * self.quantile))
        top = [tr for _, tr in scored[:k]]
        bottom = {tr.trial_id for _, tr in scored[-k:]}
        if trial.trial_id not in bottom or trial in top:
            return CONTINUE
        source = self._rng.choice(
            [tr for tr in top if tr.trial_id != trial.trial_id]
            or [top[0]])
        if source.checkpoint is None:
            return CONTINUE  # nothing to clone yet
        self.num_exploits += 1
        return {"exploit": source,
                "config": self._mutate(source.config)}
