"""Search spaces and suggestion generation.

Role-equivalent to the reference's tune.search (ref:
python/ray/tune/search/ — BasicVariantGenerator, sample.py domains).
Domains: uniform/loguniform/randint/choice/grid_search; the basic
generator crosses grid axes and samples the rest per trial.
Counterpart of ``ray_tpu/tune/search.py``.
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low),
                                    math.log(self.high)))


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    options: List[Any]

    def sample(self, rng):
        return rng.choice(self.options)


@dataclass
class GridSearch:
    values: List[Any]


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(options: List[Any]) -> Choice:
    return Choice(list(options))


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


def sample_from(fn: Callable[[Dict], Any]):
    return _SampleFrom(fn)


@dataclass
class _SampleFrom:
    fn: Callable


class Searcher:
    """Sequential search algorithm interface (ref:
    tune/search/searcher.py Searcher — suggest/on_trial_complete).
    Pass an instance as ``TuneConfig(search_alg=...)``; the Tuner then
    asks for one config per trial as capacity frees up instead of
    expanding the space up front."""

    def setup(self, param_space: Dict[str, Any],
              metric: Optional[str], mode: str,
              seed: Optional[int]) -> None:
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Dict[str, Any]) -> None:
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (Bergstra et al. 2011, the
    public algorithm behind Optuna's default sampler) — the model-based
    searcher the reference reaches through its Optuna adapter (ref:
    tune/search/optuna/optuna_search.py), implemented natively because
    the images carry no optuna/hyperopt.

    After ``n_initial`` random trials, each numeric dimension models
    the observations as two kernel densities — the best ``gamma``
    quantile ("good") vs the rest — and suggestions maximize the
    good/bad likelihood ratio over ``n_candidates`` draws from the
    good density.  Categorical dimensions use smoothed category
    frequencies.  GridSearch axes are unsupported (grids enumerate;
    use the default generator)."""

    def __init__(self, n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._observed: List[Dict[str, Any]] = []   # config + score

    def setup(self, param_space, metric, mode, seed) -> None:
        super().setup(param_space, metric, mode, seed)
        if any(isinstance(v, GridSearch)
               for v in param_space.values()):
            raise ValueError(
                "TPESearcher does not support grid_search axes")
        self._pending: Dict[str, Dict[str, Any]] = {}

    # ----------------------------------------------------- unit mapping
    def _to_unit(self, dom: Domain, value: float) -> float:
        import math

        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            return (math.log(value) - lo) / (hi - lo)
        lo, hi = float(dom.low), float(dom.high)
        return (value - lo) / (hi - lo) if hi > lo else 0.5

    def _from_unit(self, dom: Domain, u: float):
        import math

        u = min(max(u, 0.0), 1.0)
        if isinstance(dom, LogUniform):
            lo, hi = math.log(dom.low), math.log(dom.high)
            return math.exp(lo + u * (hi - lo))
        lo, hi = float(dom.low), float(dom.high)
        v = lo + u * (hi - lo)
        if isinstance(dom, RandInt):
            return min(int(dom.high) - 1, max(int(dom.low), round(v)))
        return v

    # --------------------------------------------------------- suggest
    def _split(self) -> tuple:
        obs = sorted(self._observed, key=lambda o: o["score"])
        n_good = max(1, int(len(obs) * self.gamma))
        return obs[:n_good], obs[n_good:]

    @staticmethod
    def _kde(points: List[float], x: float, bw: float) -> float:
        import math

        if not points:
            return 1.0
        return sum(math.exp(-0.5 * ((x - p) / bw) ** 2)
                   for p in points) / (len(points) * bw)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {}
        model_ready = len(self._observed) >= self.n_initial
        good, bad = self._split() if model_ready else ([], [])
        for key, dom in self.param_space.items():
            if isinstance(dom, Choice):
                if model_ready:
                    counts = {repr(o): 1.0 for o in dom.options}
                    for g in good:
                        counts[repr(g["config"][key])] = counts.get(
                            repr(g["config"][key]), 1.0) + 1.0
                    total = sum(counts.values())
                    r = self.rng.random() * total
                    acc = 0.0
                    for opt in dom.options:
                        acc += counts[repr(opt)]
                        if r <= acc:
                            cfg[key] = opt
                            break
                    else:
                        cfg[key] = dom.options[-1]
                else:
                    cfg[key] = dom.sample(self.rng)
            elif isinstance(dom, Domain):
                if model_ready:
                    gpts = [self._to_unit(dom, g["config"][key])
                            for g in good]
                    bpts = [self._to_unit(dom, b["config"][key])
                            for b in bad]
                    bw = max(0.05, 1.0 / max(len(gpts), 1) ** 0.5)
                    best_u, best_ratio = None, -1.0
                    for _ in range(self.n_candidates):
                        base = self.rng.choice(gpts) if gpts \
                            else self.rng.random()
                        u = base + self.rng.gauss(0.0, bw)
                        u = min(max(u, 0.0), 1.0)
                        ratio = (self._kde(gpts, u, bw)
                                 / (self._kde(bpts, u, bw) + 1e-12))
                        if ratio > best_ratio:
                            best_u, best_ratio = u, ratio
                    cfg[key] = self._from_unit(dom, best_u)
                else:
                    cfg[key] = dom.sample(self.rng)
            elif isinstance(dom, _SampleFrom):
                cfg[key] = dom.fn(cfg)
            else:
                cfg[key] = dom
        self._pending[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Dict[str, Any]) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not result or self.metric not in result:
            return
        value = float(result[self.metric])
        score = value if self.mode == "min" else -value
        self._observed.append({"config": cfg, "score": score})


class BasicVariantGenerator:
    """Cross product of grid axes x num_samples random draws of the rest
    (ref: tune/search/basic_variant.py)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grid_values = [self.param_space[k].values for k in grid_keys]
        combos = list(itertools.product(*grid_values)) if grid_keys \
            else [()]
        out: List[Dict[str, Any]] = []
        for _ in range(self.num_samples):
            for combo in combos:
                cfg: Dict[str, Any] = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    elif isinstance(v, _SampleFrom):
                        cfg[k] = v.fn(cfg)
                    else:
                        cfg[k] = v
                out.append(cfg)
        return out
