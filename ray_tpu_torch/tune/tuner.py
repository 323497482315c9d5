"""Tuner + TuneController — concurrent trial execution.

Role-equivalent to the reference's Tuner.fit -> TuneController (ref:
python/ray/tune/tuner.py:44, tune/execution/tune_controller.py): expand
the param space into trials, run up to ``max_concurrent`` trial actors,
stream their reports, let the scheduler stop under-performers, and
return a ResultGrid.  Trainables are functions ``fn(config)`` that call
``ray_tpu_torch.tune.report(...)`` — or a BaseTrainer (``TorchTrainer``),
whose param space merges into its train_loop_config (the reference's
trainer-as-trainable wrap, base_trainer.py:724).  Counterpart of
``ray_tpu/tune/tuner.py``; the trial function travels pickled by the
port's vendored cloudpickle.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ..train.config import Result, RunConfig
from .schedulers import COMPLETE, CONTINUE, FIFOScheduler, STOP
from .search import BasicVariantGenerator

_trial_session = None  # set inside trial processes


@dataclass
class TuneConfig:
    num_samples: int = 1
    metric: Optional[str] = None
    mode: str = "min"
    scheduler: Any = None
    max_concurrent_trials: int = 2
    seed: Optional[int] = None
    # A search.Searcher (e.g. TPESearcher): configs are suggested one
    # trial at a time, informed by completed results, instead of the
    # up-front BasicVariantGenerator expansion (ref: tune/search/).
    search_alg: Any = None


@ray_tpu_torch.remote(max_concurrency=4)
class _TrialActor:
    """Runs one trial's function; buffers its reports."""

    def __init__(self):
        self.reports: List[Dict] = []
        self.iteration = 0
        self.checkpoint: Any = None

    def run(self, fn_payload: bytes, config: Dict,
            checkpoint: Any = None, start_iteration: int = 0):
        from ray_tpu_torch._vendor import cloudpickle
        from ray_tpu_torch.tune import tuner as tuner_mod

        fn = cloudpickle.loads(fn_payload)
        self.checkpoint = checkpoint
        self.iteration = start_iteration
        tuner_mod._trial_session = self
        try:
            return fn(config)
        finally:
            tuner_mod._trial_session = None

    def _record(self, metrics: Dict, checkpoint: Any = None):
        self.iteration += 1
        row = dict(metrics)
        row.setdefault("training_iteration", self.iteration)
        if checkpoint is not None:
            self.checkpoint = checkpoint
            row["__checkpoint__"] = checkpoint
        self.reports.append(row)

    def poll(self):
        out, self.reports = self.reports, []
        return out


def report(metrics: Dict[str, Any], checkpoint=None) -> None:
    """Called inside a trial fn (ref: tune.report / session.report).
    ``checkpoint`` (any picklable value) becomes the trial's restore
    point — PBT exploits clone it into other trials."""
    if _trial_session is None:
        raise RuntimeError("tune.report() called outside a trial")
    _trial_session._record(metrics, checkpoint)


def get_checkpoint() -> Any:
    """Inside a trial fn: the checkpoint to resume from (None on a
    fresh start; ref: tune.get_checkpoint)."""
    if _trial_session is None:
        raise RuntimeError("tune.get_checkpoint() outside a trial")
    return getattr(_trial_session, "checkpoint", None)


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    actor: Any = None
    run_ref: Any = None
    status: str = "PENDING"   # PENDING|RUNNING|TERMINATED|STOPPED|ERROR
    history: List[Dict] = field(default_factory=list)
    error: Optional[BaseException] = None
    checkpoint: Any = None     # latest tune.report(checkpoint=...) value
    num_restarts: int = 0      # PBT exploit restarts
    # Exploit provenance: (source_trial_id, source_score) per exploit,
    # so tests/analysis can verify adoption continuity (ref: pbt.py
    # logging the exploit decision into trial metadata).
    exploits: List[Any] = field(default_factory=list)

    def last_metrics(self) -> Dict:
        return self.history[-1] if self.history else {}


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str):
        self.trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self.trials)

    def __iter__(self):
        for t in self.trials:
            yield Result(metrics=t.last_metrics(), error=t.error,
                         metrics_history=t.history)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        best: Optional[Trial] = None
        for t in self.trials:
            if t.error is not None or metric not in t.last_metrics():
                continue
            if best is None:
                best = t
                continue
            a, b = t.last_metrics()[metric], best.last_metrics()[metric]
            if (mode == "min" and a < b) or (mode == "max" and a > b):
                best = t
        if best is None:
            raise ValueError(f"no trial reported metric {metric!r}")
        return Result(metrics=best.last_metrics(), error=None,
                      metrics_history=best.history)

    @property
    def best_config(self) -> Dict:
        best = self.get_best_result()
        for t in self.trials:
            if t.last_metrics() == best.metrics:
                return t.config
        return {}


class Tuner:
    def __init__(self, trainable: Any, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    def _as_function(self) -> Callable[[Dict], Any]:
        from ..train.trainer import BaseTrainer

        if isinstance(self.trainable, BaseTrainer):
            trainer = self.trainable

            def run_trainer(config: Dict):
                import copy

                from ray_tpu_torch.tune import tuner as tuner_mod

                t = copy.copy(trainer)
                t.train_loop_config = {**trainer.train_loop_config,
                                       **config}
                result = t.fit()
                if result.error is not None:
                    raise result.error
                for h in result.metrics_history:
                    tuner_mod.report(h["metrics"])
                return result.metrics

            return run_trainer
        return self.trainable

    def fit(self) -> ResultGrid:
        from ..core import serialization

        tc = self.tune_config
        fn = self._as_function()
        serialization.ensure_code_portable(fn)
        serialization.ensure_code_portable(self.trainable)
        from .._vendor import cloudpickle

        payload = cloudpickle.dumps(fn)
        searcher = tc.search_alg
        trials: List[Trial]
        if searcher is not None:
            searcher.setup(self.param_space, tc.metric, tc.mode,
                           tc.seed)
            trials = []
            pending: List[Trial] = []
            to_suggest = tc.num_samples
        else:
            variants = BasicVariantGenerator(
                self.param_space, tc.num_samples, tc.seed).variants()
            trials = [
                Trial(trial_id=f"trial_{i:04d}_{uuid.uuid4().hex[:6]}",
                      config=cfg) for i, cfg in enumerate(variants)]
            pending = list(trials)
            to_suggest = 0

        def _next_trial() -> Optional[Trial]:
            nonlocal to_suggest
            if pending:
                return pending.pop(0)
            if to_suggest > 0:
                to_suggest -= 1
                tid = (f"trial_{len(trials):04d}_"
                       f"{uuid.uuid4().hex[:6]}")
                t = Trial(trial_id=tid, config=searcher.suggest(tid))
                trials.append(t)
                return t
            return None

        def _completed(t: Trial) -> None:
            if searcher is not None:
                try:
                    searcher.on_trial_complete(t.trial_id,
                                               t.last_metrics())
                except Exception:
                    pass

        scheduler = tc.scheduler or FIFOScheduler()
        running: List[Trial] = []
        while pending or running or to_suggest:
            while len(running) < tc.max_concurrent_trials:
                t = _next_trial()
                if t is None:
                    break
                t.actor = _TrialActor.remote()
                t.run_ref = t.actor.run.remote(payload, t.config)
                t.status = "RUNNING"
                running.append(t)
            if not running:
                continue
            # Poll reports and completion.
            done_refs, _ = ray_tpu_torch.wait([t.run_ref for t in running],
                                        num_returns=1, timeout=0.2)
            pop_hook = getattr(scheduler, "on_population_result", None)
            for t in list(running):
                exploit_decision = None
                stopped = False
                # Consume the WHOLE batch (poll() already popped it from
                # the actor) before acting on any decision — dropping
                # the tail would lose metrics and checkpoints forever.
                for row in ray_tpu_torch.get(t.actor.poll.remote()):
                    if "__checkpoint__" in row:
                        t.checkpoint = row.pop("__checkpoint__")
                    t.history.append(row)
                    if stopped or exploit_decision is not None:
                        continue
                    decision = scheduler.on_result(t.trial_id, row)
                    if decision in (STOP, COMPLETE) and \
                            t.status == "RUNNING":
                        t.status = ("STOPPED" if decision == STOP
                                    else "TERMINATED")
                        stopped = True
                        continue
                    if pop_hook is not None and t.status == "RUNNING":
                        pdec = pop_hook(t, row, trials)
                        if isinstance(pdec, dict) and "exploit" in pdec:
                            exploit_decision = pdec
                if stopped:
                    ray_tpu_torch.kill(t.actor)
                    running.remove(t)
                    _completed(t)
                    continue
                if exploit_decision is not None:
                    # PBT: adopt the source's checkpoint + mutated
                    # config and restart the trial, continuing the
                    # iteration clock so perturbation windows and rung
                    # milestones stay monotonic.
                    source = exploit_decision["exploit"]
                    ray_tpu_torch.kill(t.actor)
                    t.config = exploit_decision["config"]
                    t.checkpoint = source.checkpoint
                    t.num_restarts += 1
                    t.exploits.append(
                        (source.trial_id,
                         source.last_metrics().get(tc.metric)))
                    last_iter = max(
                        (r.get("training_iteration", 0)
                         for r in t.history), default=0)
                    t.actor = _TrialActor.remote()
                    t.run_ref = t.actor.run.remote(
                        payload, t.config, t.checkpoint, last_iter)
                    continue
                if t.status != "RUNNING":
                    continue
                if t.run_ref in done_refs:
                    try:
                        ray_tpu_torch.get(t.run_ref)
                        # Final poll for reports emitted just before exit.
                        try:
                            for row in ray_tpu_torch.get(t.actor.poll.remote()):
                                if "__checkpoint__" in row:
                                    t.checkpoint = \
                                        row.pop("__checkpoint__")
                                t.history.append(row)
                        except Exception:
                            pass
                        t.status = "TERMINATED"
                    except Exception as e:  # noqa: BLE001
                        t.error = e
                        t.status = "ERROR"
                    ray_tpu_torch.kill(t.actor)
                    running.remove(t)
                    _completed(t)
        return ResultGrid(trials, tc.metric, tc.mode)
