"""The port's tune library (``ray_tpu_torch.tune``) against the JAX
package's (``ray_tpu.tune``).

The deterministic parts run in both packages in this process and must
be equal exactly: ``BasicVariantGenerator``'s variants for a seed,
``TPESearcher``'s suggestions for a seed and a fed history, and the
decisions of ``ASHAScheduler`` and ``PopulationBasedTraining`` on one
scripted result stream.  Then ``Tuner`` runs end to end on one port
runtime: ``tests/test_data_tune.py``'s grid, random, ASHA, trial-error
and TPE-with-ASHA cases, a TPE search one trial at a time whose
suggestions must equal the JAX searcher's replayed on the same results,
and a grid over a ``TorchTrainer``.  (The JAX package's timing-bound
TPE and PBT convergence tests are not the reference: which trials a
concurrent search or population sees depends on when reports land.
Their deterministic parts are the searcher and scheduler cases here.)

Trial functions run in workers pickled by value; they touch no jax.
"""

import importlib
import time

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _tune(pkg):
    return importlib.import_module(pkg + ".tune")


def _space(tune):
    return {"g": tune.grid_search([1, 2, 3]),
            "u": tune.uniform(-1.0, 1.0),
            "lu": tune.loguniform(1e-4, 1e-1),
            "ri": tune.randint(0, 10),
            "c": tune.choice(["a", "b", "c"]),
            "derived": tune.sample_from(lambda cfg: cfg["g"] * 10),
            "const": 0.5}


def _both(fn):
    return {pkg: fn(_tune(pkg), pkg) for pkg in PACKAGES}


# ------------------------------------------------------------- search
@pytest.mark.parametrize("seed,num_samples", [(0, 1), (11, 3), (None, 0)])
def test_basic_variants_equal_jax(seed, num_samples):
    def variants(tune, pkg):
        search = importlib.import_module(pkg + ".tune.search")
        return search.BasicVariantGenerator(_space(tune), num_samples,
                                            seed).variants()

    got = _both(variants)
    assert len(got["ray_tpu_torch"]) == 3 * num_samples
    if seed is not None:
        assert got["ray_tpu_torch"] == got["ray_tpu"]
    for cfg in got["ray_tpu_torch"]:
        assert cfg["derived"] == cfg["g"] * 10 and cfg["const"] == 0.5
        assert -1.0 <= cfg["u"] <= 1.0 and 1e-4 <= cfg["lu"] <= 1e-1


def _objective(cfg):
    return ((cfg["u"] - 0.3) ** 2 + abs(cfg["lu"] - 0.01) * 10
            + (cfg["ri"] - 4) ** 2 / 10 + (0 if cfg["c"] == "b" else 1))


@pytest.mark.parametrize("mode", ["min", "max"])
def test_tpe_suggestions_equal_jax(mode):
    """Suggest, score, feed back, 24 times: the same configs in both
    packages, through the random warm-up and the model phase."""
    def run(tune, pkg):
        space = {k: v for k, v in _space(tune).items() if k != "g"}
        space["derived"] = tune.sample_from(lambda cfg: cfg["ri"] + 1)
        searcher = tune.TPESearcher(n_initial=6, n_candidates=16)
        searcher.setup(space, "loss", mode, 5)
        out = []
        for i in range(24):
            cfg = searcher.suggest(f"t{i}")
            searcher.on_trial_complete(f"t{i}", {"loss": _objective(cfg)})
            out.append(cfg)
        searcher.on_trial_complete("unknown", {"loss": 1.0})
        return out, len(searcher._observed)

    got = _both(run)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"][1] == 24


def test_tpe_rejects_grid_axes():
    tune = _tune("ray_tpu_torch")
    with pytest.raises(ValueError):
        tune.TPESearcher().setup({"x": tune.grid_search([1, 2])}, "m",
                                 "min", 0)


# --------------------------------------------------------- schedulers
def _stream(n_trials=6, n_iters=9):
    """A scripted result stream: trials report in a rotating order, each
    on its own loss curve."""
    rows = []
    for it in range(1, n_iters + 1):
        for k in range(n_trials):
            tid = f"t{(k + it) % n_trials}"
            base = int(tid[1:])
            rows.append((tid, {"loss": base + 1.0 / it,
                               "score": 10 - base + it * 0.1 * base,
                               "training_iteration": it}))
    return rows


@pytest.mark.parametrize("kw", [
    dict(max_t=8, grace_period=2, reduction_factor=2),
    dict(max_t=9, grace_period=1, reduction_factor=3, mode="max",
         metric="score")])
def test_asha_decisions_equal_jax(kw):
    def run(tune, pkg):
        sched = tune.ASHAScheduler(**kw)
        decisions = [(tid, sched.on_result(tid, row))
                     for tid, row in _stream()]
        decisions.append(("none", sched.on_result("x", {})))
        return decisions, sched.rungs, dict(sched.recorded)

    got = _both(run)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    kinds = {d for _t, d in got["ray_tpu_torch"][0]}
    assert {"CONTINUE", "STOP", "COMPLETE"} <= kinds


@pytest.mark.parametrize("mutations", [
    {"lr": [0.1, 0.5, 1.0, 2.0]},
    {"lr": [0.1, 0.5, 1.0, 2.0], "mom": 0.9}])
def test_pbt_decisions_equal_jax(mutations):
    """The population hook on the scripted stream, with checkpoints
    appearing from the second iteration: each exploit's source and
    mutated config, and the count."""
    def run(tune, pkg):
        tuner = importlib.import_module(pkg + ".tune.tuner")
        sched = tune.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=3,
            hyperparam_mutations=mutations, quantile_fraction=0.25, seed=7)
        trials = {f"t{i}": tuner.Trial(
            trial_id=f"t{i}", config={"lr": [0.1, 0.5, 1.0, 2.0][i % 4],
                                      "mom": 0.5 + i / 10})
            for i in range(6)}
        decisions = []
        for tid, row in _stream():
            t = trials[tid]
            t.history.append(row)
            if row["training_iteration"] >= 2:
                t.checkpoint = {"it": row["training_iteration"], "id": tid}
            assert sched.on_result(tid, row) == "CONTINUE"
            d = sched.on_population_result(t, row, list(trials.values()))
            if isinstance(d, dict):
                t.config = d["config"]
                decisions.append((tid, d["exploit"].trial_id, d["config"]))
            else:
                decisions.append((tid, d))
        return decisions, sched.num_exploits

    got = _both(run)
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"][1] >= 2


def test_report_outside_a_trial_raises():
    tune = _tune("ray_tpu_torch")
    with pytest.raises(RuntimeError):
        tune.report({"x": 1})
    with pytest.raises(RuntimeError):
        tune.get_checkpoint()


# --------------------------------------------- Tuner on the port's runtime
@pytest.fixture(scope="module")
def port():
    import ray_tpu_torch as rt

    rt.init(mode="cluster", num_cpus=4)
    yield rt
    rt.shutdown()


def test_tuner_grid_and_best(port):
    rtt = _tune("ray_tpu_torch")

    def objective(config):
        score = (config["x"] - 3) ** 2 + config["y"]
        importlib.import_module("ray_tpu_torch.tune").report(
            {"score": score})

    grid = rtt.Tuner(
        objective,
        param_space={"x": rtt.grid_search([1, 2, 3, 4]), "y": 0.5},
        tune_config=rtt.TuneConfig(metric="score", mode="min",
                                   max_concurrent_trials=3)).fit()
    assert len(grid) == 4
    assert [t.status for t in grid.trials] == ["TERMINATED"] * 4
    assert grid.get_best_result().metrics["score"] == 0.5
    assert grid.best_config["x"] == 3


def test_tuner_random_sampling_draws_the_jax_variants(port):
    rtt = _tune("ray_tpu_torch")

    def objective(config):
        importlib.import_module("ray_tpu_torch.tune").report(
            {"val": config["lr"]})

    grid = rtt.Tuner(
        objective, param_space={"lr": rtt.loguniform(1e-4, 1e-1)},
        tune_config=rtt.TuneConfig(num_samples=4, metric="val",
                                   mode="min", seed=7)).fit()
    vals = [r.metrics["val"] for r in grid]
    jax_search = importlib.import_module("ray_tpu.tune.search")
    jtune = _tune("ray_tpu")
    want = jax_search.BasicVariantGenerator(
        {"lr": jtune.loguniform(1e-4, 1e-1)}, 4, 7).variants()
    assert vals == [c["lr"] for c in want]
    assert len(set(vals)) == 4


def test_asha_stops_bad_trials(port):
    rtt = _tune("ray_tpu_torch")

    def objective(config):
        tune = importlib.import_module("ray_tpu_torch.tune")
        for i in range(8):
            tune.report({"loss": config["base"] + i * 0.001})
            time.sleep(0.05)

    sched = rtt.ASHAScheduler(metric="loss", mode="min", max_t=8,
                              grace_period=2, reduction_factor=2)
    grid = rtt.Tuner(
        objective,
        param_space={"base": rtt.grid_search([0.1, 0.2, 5.0, 9.0])},
        tune_config=rtt.TuneConfig(metric="loss", mode="min",
                                   scheduler=sched,
                                   max_concurrent_trials=4)).fit()
    statuses = {t.config["base"]: t.status for t in grid.trials}
    assert statuses[0.1] == "TERMINATED"
    stopped = [b for b, s in statuses.items() if s == "STOPPED"]
    assert 9.0 in stopped or 5.0 in stopped
    assert grid.get_best_result().metrics["loss"] < 1.0


def test_tuner_trial_error_captured(port):
    rtt = _tune("ray_tpu_torch")

    def objective(config):
        if config["x"] == 2:
            raise RuntimeError("bad trial")
        importlib.import_module("ray_tpu_torch.tune").report({"ok": 1})

    grid = rtt.Tuner(
        objective, param_space={"x": rtt.grid_search([1, 2])},
        tune_config=rtt.TuneConfig(metric="ok", mode="max")).fit()
    errs = [t for t in grid.trials if t.status == "ERROR"]
    assert len(errs) == 1 and "bad trial" in str(errs[0].error)
    assert grid.get_best_result().metrics["ok"] == 1


def _tpe_loss(config):
    return (config["x"] - 3.0) ** 2 + (0.0 if config["act"] == "good"
                                       else 4.0)


def test_tpe_search_one_trial_at_a_time_equals_jax_replay(port):
    """One trial at a time, every suggestion follows every earlier
    result: the configs equal the JAX searcher's, replayed offline on
    the same losses."""
    rtt = _tune("ray_tpu_torch")

    def objective(config):
        importlib.import_module("ray_tpu_torch.tune").report(
            {"loss": _tpe_loss(config)})

    def space(tune):
        return {"x": tune.uniform(-10.0, 10.0),
                "act": tune.choice(["good", "bad"])}

    grid = rtt.Tuner(
        objective, param_space=space(rtt),
        tune_config=rtt.TuneConfig(
            num_samples=6, metric="loss", mode="min", seed=5,
            max_concurrent_trials=1,
            search_alg=rtt.TPESearcher(n_initial=3))).fit()
    jtune = _tune("ray_tpu")
    replay = jtune.TPESearcher(n_initial=3)
    replay.setup(space(jtune), "loss", "min", 5)
    want = []
    for i in range(6):
        cfg = replay.suggest(str(i))
        replay.on_trial_complete(str(i), {"loss": _tpe_loss(cfg)})
        want.append(cfg)
    assert [t.config for t in grid.trials] == want
    assert [t.last_metrics()["loss"] for t in grid.trials] == \
        [_tpe_loss(c) for c in want]


def test_tpe_with_asha_early_stops_still_complete(port):
    rtt = _tune("ray_tpu_torch")

    def objective(config):
        tune = importlib.import_module("ray_tpu_torch.tune")
        for i in range(4):
            tune.report({"loss": (config["x"] - 1.0) ** 2 + 1.0 / (i + 1)})

    grid = rtt.Tuner(
        objective, param_space={"x": rtt.uniform(0.0, 2.0)},
        tune_config=rtt.TuneConfig(
            num_samples=8, metric="loss", mode="min", seed=3,
            max_concurrent_trials=4,
            scheduler=rtt.ASHAScheduler(metric="loss", mode="min",
                                        max_t=4, grace_period=1),
            search_alg=rtt.TPESearcher(n_initial=4))).fit()
    assert len(grid) == 8
    assert grid.get_best_result().metrics["loss"] < 2.0


def _trainer_loop(config):
    """jax-free: a TorchTrainer worker reporting a loss per step."""
    import os

    train = importlib.import_module("ray_tpu_torch.train")
    for step in range(3):
        train.report({"loss": config["lr"] * (3 - step),
                      "step": step, "pid": os.getpid()})


def test_tuner_over_a_torch_trainer(port, tmp_path):
    """The trainer as a trainable: each grid point merges into the
    trainer's loop config, and its metrics history becomes the trial's
    reports."""
    rtt = _tune("ray_tpu_torch")
    train = importlib.import_module("ray_tpu_torch.train")
    trainer = train.TorchTrainer(
        _trainer_loop, train_loop_config={"lr": 0.0},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="tuned",
                                   storage_path=str(tmp_path)))
    grid = rtt.Tuner(
        trainer, param_space={"lr": rtt.grid_search([0.5, 0.25])},
        tune_config=rtt.TuneConfig(metric="loss", mode="min",
                                   max_concurrent_trials=2)).fit()
    assert [t.status for t in grid.trials] == ["TERMINATED"] * 2
    for t, lr in zip(grid.trials, (0.5, 0.25)):
        assert [h["loss"] for h in t.history] == [lr * 3, lr * 2, lr]
        assert [h["training_iteration"] for h in t.history] == [1, 2, 3]
    assert grid.get_best_result().metrics["loss"] == 0.25
    assert grid.best_config == {"lr": 0.25}
    # Two trials, two trainer workers of their own.
    assert len({t.history[0]["pid"] for t in grid.trials}) == 2
