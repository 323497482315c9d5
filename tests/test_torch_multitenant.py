"""The port's multi-tenant job plane against the JAX package's.

``tests/test_multitenant.py`` runs here against the port, each test in
the way that compares it best:

- pure functions (``util/multitenant.py``'s comparator, quota, overlay
  and victim selection, ``goodput.summarize_sources``): the JAX test
  runs with each function of the JAX module wrapped; the wrapper hands
  deep copies of the very arguments the JAX test built to the port's
  function of the same name, and the results must be equal;
- the controller/placement scenarios (fake agents, no cluster): the JAX
  test runs as written, and again with its text pointed at
  ``ray_tpu_torch`` (so its own assertions hold the port); both runs
  record the admission order, every group's final state and
  ``pending_reason``, the preempted groups and jobs and the
  ``jobs_overview`` rows, and the records must be equal;
- ``test_goodput_set_job_id_tags_published_series`` and the telemetry
  spill counters run on the port (the spill summary also against
  JAX's on the same sources).

The three ``find_starved_jobs`` tests run in ``test_torch_doctor.py``.
None is left out.

Then two CPU clusters, the JAX package's and the port's, one after the
other, each with ``tests/test_multitenant_cluster.py``'s ``_ENV``:

(a) a trainer's fit under ``RT_JOB_ID`` (as a job's supervisor sets it
for its entrypoint), through the trainer and through
``TrainControllerV2``: ``JaxTrainer`` and ``TorchTrainer`` give the same
``Result.metrics``, and the worker's goodput series carry the job;

(b) a trimmed ``test_multitenant_cluster.py`` scenario: one head with 2
CPUs, ``train-lo`` (priority 0, elastic gang of 2) and ``train-hi``
(priority 10, fixed gang of 2), both submitted through the package's
own ``JobSubmissionClient``.  It drops the bystander data and serve
jobs and the chaos killer, and the victim's loop waits at step 3 for
its notice instead of sleeping through 150 steps, so the outcome does
not hang on timing.  The outcome fields (``starts`` relative to the
notice step, ``announced``, ``train-hi``'s ``max_step``, the ``rt jobs``
rows, the ``per_job`` goodput keys) must be equal, and each package
keeps the JAX test's assertions.

On the port's cluster, ``ray_tpu_torch.timeline()`` equals
``util.state.timeline()``.
"""

import asyncio
import copy
import functools
import importlib
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _load_jax_test(filename: str, package: str = "ray_tpu"):
    """A JAX test module, loaded fresh; for the port, its text with every
    ``ray_tpu`` module pointed at ``ray_tpu_torch`` and the ``"TPU"``
    resource named ``"GPU"``."""
    path = ROOT / "tests" / filename
    src = path.read_text()
    if package == "ray_tpu_torch":
        src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
        src = src.replace('"TPU"', '"GPU"')
    mod = types.ModuleType(f"_{package}_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


# ------------------------------------------------------- pure functions
PURE = {
    "multitenant": ["admission_key", "victim_key", "quota_exceeded",
                    "overlay_usage", "select_victims"],
    "goodput": ["summarize_sources"],
}
PURE_TESTS = [
    "test_admission_key_orders_by_priority_then_fifo",
    "test_victim_key_prefers_lowest_priority_then_newest",
    "test_quota_exceeded_only_on_capped_resources",
    "test_grant_release_accounting_through_overlay",
    "test_select_victims_minimal_set_and_ordering",
    "test_select_victims_accumulates_until_feasible",
    "test_select_victims_never_preempts_equal_or_higher_priority",
    "test_select_victims_empty_when_infeasible_even_with_all",
    "test_goodput_summarize_sources_per_job_breakdown",
]


def _paired(name, jax_fn, port_fn, calls: list):
    @functools.wraps(jax_fn)
    def both(*args, **kwargs):
        port_args, port_kwargs = copy.deepcopy((args, kwargs))
        want = jax_fn(*args, **kwargs)
        got = port_fn(*port_args, **port_kwargs)
        assert got == want, (name, got, want)
        calls.append(name)
        return want

    return both


@pytest.mark.parametrize("test", PURE_TESTS)
def test_pure_jax_test_on_both_packages(test, monkeypatch):
    """The JAX test, every plane function paired with the port's: the
    test module is loaded after the pairing, so the names it imports
    from ``util.multitenant`` are the pairs too."""
    calls: list = []
    for module, names in PURE.items():
        jax_mod = importlib.import_module(f"ray_tpu.util.{module}")
        port_mod = importlib.import_module(f"ray_tpu_torch.util.{module}")
        for name in names:
            monkeypatch.setattr(jax_mod, name, _paired(
                name, getattr(jax_mod, name), getattr(port_mod, name),
                calls))
    getattr(_load_jax_test("test_multitenant.py"), test)()
    assert calls, f"{test} called no plane function"


def test_goodput_phases_are_jax_s():
    from ray_tpu.util import goodput as jgood
    from ray_tpu_torch.util import goodput as pgood

    assert (pgood.PHASES, pgood.GAUGE_NAME) == (jgood.PHASES,
                                                jgood.GAUGE_NAME)


# ------------------------------------------ controller + placement units
SCENARIOS = [
    "test_gang_admission_is_priority_ordered",
    "test_blocked_high_priority_gang_preempts_lower_job",
    "test_no_preemption_when_gang_infeasible_or_no_lower_priority",
    "test_quota_gates_gang_admission_without_blocking_others",
    "test_jobs_overview_merges_plane_kv_and_usage",
    "test_heartbeat_distributes_quota_view_and_aggregates_usage",
]


def _recording(mod) -> list:
    """Wrap the test module's ``_make_controller`` so each controller it
    makes, its nodes and every call its fake agents answer are kept."""
    made: list = []
    make = mod._make_controller

    def recorded(**overrides):
        ctl, add_node, agents = make(**overrides)
        rec = {"ctl": ctl, "nodes": [], "calls": []}

        def add(cpu):
            nid = add_node(cpu)
            rec["nodes"].append(nid)
            agent = agents[nid]
            answer = agent.call

            async def call(method, p):
                r = await answer(method, p)
                rec["calls"].append((method, nid, p.get("pg_id"),
                                     p.get("bundle_index"), r.get("ok")))
                return r

            agent.call = call
            return nid

        made.append(rec)
        return ctl, add, agents

    mod._make_controller = recorded
    return made


def _scenario_record(rec) -> dict:
    """What a scenario decided, with its random ids replaced by the
    order they were made in."""
    ctl = rec["ctl"]
    groups = list(ctl._placement._groups.values())
    pg_index = {e.pg_id: i for i, e in enumerate(groups)}
    node_index = {nid: i for i, nid in enumerate(rec["nodes"])}

    def words(text: str) -> str:
        for e in groups:
            text = text.replace(e.pg_id.hex()[:12], f"pg{pg_index[e.pg_id]}")
        return text

    admitted = []
    for method, _nid, pg_id, _b, ok in rec["calls"]:
        if method == "commit_bundle" and ok and \
                pg_index[pg_id] not in admitted:
            admitted.append(pg_index[pg_id])
    overview = asyncio.run(ctl.jobs_overview({}))["jobs"]
    for row in overview:
        row.pop("submitted")
        if "preempting" in row:
            row["preempting"]["remaining_s"] = \
                row["preempting"]["remaining_s"] > 0
    return {
        "admitted": admitted,
        "groups": [(e.state, e.pending_reason, e.priority, e.job,
                    e.bundles, e.strategy,
                    sorted((i, node_index[n])
                           for i, n in e.placement.items()))
                   for e in groups],
        "preempted_groups": [pg_index[pg] for m, _n, pg, _b, _ok
                             in rec["calls"] if m == "preempt_pg_leases"],
        "preempting": {job: (words(r["reason"]), r["by"])
                       for job, r in ctl.preempting.items()},
        "job_plane": {job: {k: v for k, v in p.items() if k != "submitted"}
                      for job, p in ctl.job_plane.items()},
        "overview": overview,
    }


@pytest.mark.parametrize("test", SCENARIOS)
def test_controller_scenario_matches_jax(test):
    records = {}
    for package in PACKAGES:
        mod = _load_jax_test("test_multitenant.py", package)
        made = _recording(mod)
        getattr(mod, test)()   # the JAX test's assertions, on each package
        records[package] = [_scenario_record(r) for r in made]
    assert records["ray_tpu"], test
    assert records["ray_tpu_torch"] == records["ray_tpu"]


# ----------------------------------------------------- goodput, telemetry
def test_goodput_set_job_id_tags_published_series():
    _load_jax_test("test_multitenant.py", "ray_tpu_torch") \
        .test_goodput_set_job_id_tags_published_series()


def test_set_job_id_overrides_the_environment_as_jax_s(monkeypatch):
    """``current_job_id`` reads the stamped id before ``RT_JOB_ID``, and
    an empty stamp falls back to the environment, in both packages."""
    monkeypatch.setenv("RT_JOB_ID", "from-env")
    seen = {}
    for package in PACKAGES:
        goodput = importlib.import_module(f"{package}.util.goodput")
        before = goodput.current_job_id()
        goodput.set_job_id("stamped")
        during = goodput.current_job_id()
        goodput.set_job_id("")
        seen[package] = (before, during, goodput.current_job_id())
        # No ledger or series of this test outlives it.
        importlib.import_module(f"{package}.util.metrics") \
            .registry().clear()
        goodput.reset()
    assert seen["ray_tpu_torch"] == seen["ray_tpu"] == \
        ("from-env", "stamped", "from-env")


def test_telemetry_surfaces_object_spill_counters(monkeypatch):
    _load_jax_test("test_multitenant.py", "ray_tpu_torch") \
        .test_telemetry_surfaces_object_spill_counters(monkeypatch)


def test_spill_summary_and_text_equal_jax_s(monkeypatch):
    """The same sources through both packages' ``cluster_summary`` and
    ``render_text``."""
    sources = {
        "node-aa": [
            {"name": "rt_object_spilled_bytes", "kind": "gauge",
             "series": [{"tags": {}, "value": 4096.0}]},
            {"name": "rt_object_spill_total", "kind": "counter",
             "series": [{"tags": {}, "value": 3.0}]},
            {"name": "rt_goodput_seconds", "kind": "gauge",
             "series": [{"tags": {"phase": "compute", "job": "j"},
                         "value": 2.0}]}],
        "node-bb": [
            {"name": "rt_object_restore_total", "kind": "counter",
             "series": [{"tags": {}, "value": 1.0}]}]}
    out = {}
    for package in PACKAGES:
        state = importlib.import_module(f"{package}.util.state")
        telemetry = importlib.import_module(f"{package}.util.telemetry")
        monkeypatch.setattr(state, "telemetry", lambda address=None: {
            "ts": 1.0, "sources": copy.deepcopy(sources), "flight": []})
        monkeypatch.setattr(state, "metrics_history",
                            lambda address=None: {})
        monkeypatch.setattr(state, "serve_resilience",
                            lambda address=None: {})
        summary = telemetry.cluster_summary()
        out[package] = (summary, telemetry.render_text(summary))
    assert out["ray_tpu_torch"] == out["ray_tpu"]


# ----------------------------------------- the job's gangs and its limits
@pytest.mark.parametrize("env,args", [
    ({}, {}),
    ({"RT_JOB_PRIORITY": "7", "RT_JOB_ID": "train-x"}, {}),
    ({"RT_JOB_PRIORITY": "7", "RT_JOB_ID": "train-x"},
     {"priority": 2, "job_id": "other"}),
    ({"RT_JOB_PRIORITY": "not-a-number"}, {}),
], ids=["no-job", "job-env", "explicit", "bad-priority"])
def test_placement_group_takes_the_job_as_jax_s(monkeypatch, env, args):
    """``placement_group()`` asks the controller for the same group in
    both packages: priority and job from the submitted job's
    environment unless given."""
    for k in ("RT_JOB_PRIORITY", "RT_JOB_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    asked = {}
    for package in PACKAGES:
        pg_mod = importlib.import_module(f"{package}.util.placement_group")
        calls = []
        fake = types.SimpleNamespace(controller_call=lambda m, p, c=calls:
                                     c.append((m, dict(p))) or {"ok": True})
        monkeypatch.setattr(pg_mod._runtime_mod, "get_runtime",
                            lambda fake=fake: fake)
        pg = pg_mod.placement_group([{"CPU": 1.0}, {"CPU": 2.0}],
                                    strategy="SPREAD", name="g", **args)
        (method, payload), = calls
        assert payload.pop("pg_id") == pg.id
        asked[package] = (method, payload)
    assert asked["ray_tpu_torch"] == asked["ray_tpu"]


@pytest.mark.parametrize("kwargs", [
    {"submission_id": "bad id!"}, {"quota": {}}, {"quota": ["CPU"]},
    {"quota": {"CPU": 0}}, {"quota": {"CPU": "4"}}, {"quota": {1: 4.0}},
    {"priority": "high"}])
def test_job_submission_refuses_what_jax_s_refuses(kwargs):
    """``submit_job``'s checks of the id, priority and quota, before any
    actor is made: the same error type and message in both packages."""
    seen = {}
    for package in PACKAGES:
        client_mod = importlib.import_module(f"{package}.job.client")
        client = object.__new__(client_mod.JobSubmissionClient)
        client._rt = types.SimpleNamespace(
            controller_call=lambda method, payload: None)
        with pytest.raises(ValueError) as e:
            client.submit_job(entrypoint="true", **kwargs)
        seen[package] = str(e.value)
    assert seen["ray_tpu_torch"] == seen["ray_tpu"]


# ------------------------------------------------------- CPU clusters
# tests/test_multitenant_cluster.py's _ENV (read from the file, so the
# two stay one).
ENV = json.loads(re.search(
    r"_ENV = (\{.*?\n\})",
    (ROOT / "tests" / "test_multitenant_cluster.py").read_text(),
    re.S).group(1).replace(",\n}", "\n}"))
JOB_ID = "job-abc"
NOTICE_STEP = 3


def _job_loop(config):
    """(a) A loop in either package's trainer: it reports the job id its
    worker stamps on goodput and the ``job`` tags of its published
    phase series."""
    import importlib

    pkg = config["pkg"]
    train = importlib.import_module(pkg + ".train")
    goodput = importlib.import_module(pkg + ".util.goodput")
    metrics = importlib.import_module(pkg + ".util.metrics")
    for step in range(3):
        with goodput.ledger().phase("compute"):
            pass
        tags = sorted({s["tags"].get("job", "")
                       for m in metrics.registry().snapshot()
                       if m["name"] == goodput.GAUGE_NAME
                       for s in m["series"]})
        train.report({"step": step, "rank": train.get_world_rank(),
                      "job": goodput.current_job_id(), "tags": tags})
    return True


def _fit_under_job(pkg: str, trainer: str, controller: bool, storage):
    train = importlib.import_module(pkg + ".train")
    os.environ["RT_JOB_ID"] = JOB_ID
    try:
        t = getattr(train, trainer)(
            _job_loop, train_loop_config={"pkg": pkg},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="job", storage_path=storage))
        result = train.TrainControllerV2(t).fit() if controller \
            else t.fit()
    finally:
        os.environ.pop("RT_JOB_ID", None)
    return {"error": repr(result.error) if result.error else None,
            "metrics": result.metrics,
            "history": [h["metrics"] for h in result.metrics_history]}


_TRAIN_SCRIPT = """\
import json, sys, time
sys.path.insert(0, {repo!r})
import {pkg} as rt
rt.init(address={addr!r})
from {pkg}.train import (ElasticScalingPolicy, FailurePolicy, RunConfig,
                         ScalingConfig, TrainControllerV2)
from {pkg}.train.v2 import FixedScalingPolicy
from {pkg}.train.backend import Backend
from {pkg}.train.trainer import BaseTrainer


def loop(config):
    import time as _t
    from {pkg} import train
    from {pkg}.train import Checkpoint
    from {pkg}.util import goodput

    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.load_json("meta")["step"]
    for step in range(start, config["steps"]):
        with goodput.ledger().phase("compute"):
            _t.sleep(0.05)
        if train.get_world_rank() != 0:
            train.report({{"step": step, "start": start}})
            continue
        if step == config["wait_at"] and start == 0:
            # The victim waits for its notice here, then saves and
            # waits to be killed at the end of the grace.
            deadline = _t.monotonic() + 120
            while not train.interrupted():
                assert _t.monotonic() < deadline, "no preemption notice"
                _t.sleep(0.1)
            with train.checkpoint_on_notice():
                with train.checkpoint_dir() as d:
                    c = Checkpoint(d)
                    c.save_json("meta", {{"step": step}})
                    train.report({{"step": step, "start": start,
                                   "notice": True}}, checkpoint=c)
            _t.sleep(120)
            raise RuntimeError("not preempted within the grace")
        if step == 1:
            with train.checkpoint_dir() as d:
                c = Checkpoint(d)
                c.save_json("meta", {{"step": step}})
                train.report({{"step": step, "start": start}},
                             checkpoint=c)
        else:
            train.report({{"step": step, "start": start}})
        with open(config["progress"], "w") as f:
            f.write(str(step))
    _t.sleep(2 * {period})   # one metrics report after the last phase
    return start


trainer = BaseTrainer(
    loop,
    train_loop_config={{"steps": {steps}, "wait_at": {wait_at},
                       "progress": {progress!r}}},
    scaling_config=ScalingConfig(num_workers=2,
                                 resources_per_worker={{"CPU": 1.0}},
                                 placement_strategy="PACK"),
    run_config=RunConfig(name={name!r}, storage_path={storage!r}))
trainer.backend_cls = Backend
policy = (FixedScalingPolicy(2) if {fixed}
          else ElasticScalingPolicy(min_workers=2, max_workers=2,
                                    resources_per_worker={{"CPU": 1.0}}))
controller = TrainControllerV2(
    trainer, scaling_policy=policy,
    failure_policy=FailurePolicy(max_failures=0))
out = {{"error": None}}
try:
    result = controller.fit()
    out["error"] = repr(result.error) if result.error else None
    out["starts"] = sorted({{h["metrics"]["start"]
                             for h in result.metrics_history}})
    out["notice_steps"] = [h["metrics"]["step"]
                           for h in result.metrics_history
                           if h["metrics"].get("notice")]
    out["preempt_ckpt"] = [bool(h.get("preempt_ckpt"))
                           for h in result.metrics_history
                           if h["metrics"].get("notice")]
    out["max_step"] = max(h["metrics"]["step"]
                          for h in result.metrics_history)
except Exception as e:  # noqa: BLE001 — the test reads this file
    out["error"] = repr(e)
out["announced"] = controller.announced_failures
out["attempt_sizes"] = controller.attempt_sizes
out["backoff_delays"] = controller.backoff_delays
with open({results!r}, "w") as f:
    json.dump(out, f)
sys.exit(1 if out["error"] else 0)
"""


def _cli(pkg: str, *args, timeout: float = 60):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", f"{pkg}.scripts.cli",
                           *args], capture_output=True, text=True,
                          env=env, timeout=timeout)


def _until(pred, timeout: float, what: str, poll: float = 0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(poll)
    raise TimeoutError(f"timed out waiting for {what}")


def _preemption(pkg: str, address: str, tmp) -> dict:
    """(b): train-lo fills the head's 2 CPUs, train-hi preempts it."""
    JobSubmissionClient = importlib.import_module(
        pkg + ".job").JobSubmissionClient
    client = JobSubmissionClient(address)
    progress = str(tmp / "lo_progress")
    results = {"lo": str(tmp / "lo.json"), "hi": str(tmp / "hi.json")}

    def submit(job_id, priority=0, quota=None, **fmt):
        path = tmp / f"{job_id}.py"
        path.write_text(_TRAIN_SCRIPT.format(
            repo=str(ROOT), pkg=pkg, addr=address, storage=str(tmp),
            period=ENV["RT_METRICS_REPORT_PERIOD_S"], **fmt))
        return client.submit_job(entrypoint=f"{sys.executable} -u {path}",
                                 submission_id=job_id, priority=priority,
                                 quota=quota)

    submit("train-lo", steps=8, wait_at=NOTICE_STEP, progress=progress,
           name="lo", results=results["lo"], fixed=False)
    _until(lambda: os.path.exists(progress)
           and int(open(progress).read() or 0) >= NOTICE_STEP - 1,
           120, "train-lo's step 2")
    # train-hi's quota is what its gang takes: it admits all the same.
    submit("train-hi", priority=10, quota={"CPU": 2}, steps=6, wait_at=-1,
           progress=str(tmp / "hi_progress"), name="hi",
           results=results["hi"], fixed=True)
    overview = importlib.import_module(pkg + ".core.runtime") \
        .get_runtime().controller_call

    def preempting():
        rows = {j["job_id"]: j for j in overview("jobs_overview",
                                                 {})["jobs"]}
        lo = rows.get("train-lo") or {}
        return lo.get("preempting")

    notice = _until(preempting, 60, "train-lo's preemption notice")
    out = {"notice": {"by": notice["by"], "reason": notice["reason"]}}
    status, per_job = {}, {}
    for job in ("train-hi", "train-lo"):
        st = client.wait_until_finished(job, timeout=180)
        status[job] = (st.status, st.message)
        if st.status != "SUCCEEDED":
            status[job] += (client.get_job_logs(job)[-3000:],)
        # Read while the job's workers are in the summary: a source
        # leaves it 30 s after its last report.
        r = _cli(pkg, "telemetry", "--format", "json", "--address",
                 address)
        for name, phases in (json.loads(r.stdout)["goodput"]
                             .get("per_job") or {}).items():
            per_job[name] = max(per_job.get(name, 0.0),
                                phases.get("compute", 0.0))
    out["status"], out["per_job"] = status, per_job
    out["lo"] = json.load(open(results["lo"]))
    out["hi"] = json.load(open(results["hi"]))
    r = _cli(pkg, "jobs", "--format", "json", "--address", address)
    out["jobs"] = {j["job_id"]: (j["priority"], j["quota"], j["state"])
                   for j in json.loads(r.stdout)}
    r = _until(lambda: (lambda r: r if r.returncode == 0 else None)(
        _cli(pkg, "doctor", "--format", "json", "--address", address)),
        90, "rt doctor exit 0", poll=0.5)
    out["doctor_critical"] = [f["check"] for f in
                              json.loads(r.stdout).get("findings", [])
                              if f["severity"] == "critical"]
    return out


def _run_package(pkg: str, tmp) -> dict:
    rt = importlib.import_module(pkg)
    Cluster = importlib.import_module(pkg + ".cluster_utils").Cluster
    trainer = {"ray_tpu": "JaxTrainer",
               "ray_tpu_torch": "TorchTrainer"}[pkg]
    old = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    c = Cluster(head_node_args={"num_cpus": 2})
    rt.init(address=c.address)
    out = {}
    try:
        for how in ("trainer", "controller"):
            try:
                out[f"fit_{how}"] = _fit_under_job(
                    pkg, trainer, how == "controller",
                    str(tmp / f"fit_{how}"))
            except Exception as e:  # noqa: BLE001 — compared in the tests
                out[f"fit_{how}"] = {"error": repr(e)}
        try:
            out["preemption"] = _preemption(pkg, c.address, tmp)
        except Exception as e:  # noqa: BLE001
            out["preemption"] = {"error": repr(e)}
        if pkg == "ray_tpu_torch":
            state = importlib.import_module(pkg + ".util.state")
            path = tmp / "timeline.json"
            try:
                out["timeline"] = (rt.timeline(), state.timeline(),
                                   rt.timeline(str(path)))
                out["timeline_file"] = json.loads(path.read_text())
            except Exception as e:  # noqa: BLE001
                out["timeline"] = repr(e)
    finally:
        rt.shutdown()
        c.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's cluster, JAX's first, one at a time."""
    return {pkg: _run_package(pkg, tmp_path_factory.mktemp(pkg))
            for pkg in PACKAGES}


@pytest.mark.parametrize("how", ["trainer", "controller"])
def test_fit_under_a_job_id_matches_jax(runs, how):
    """(a) JaxTrainer and TorchTrainer (alone and under
    TrainControllerV2) with RT_JOB_ID set: the same metrics."""
    port, jax = runs["ray_tpu_torch"][f"fit_{how}"], \
        runs["ray_tpu"][f"fit_{how}"]
    assert jax["error"] is None, jax
    assert port == jax


@pytest.mark.parametrize("how", ["trainer", "controller"])
def test_worker_goodput_series_carry_the_job(runs, how):
    fit = runs["ray_tpu_torch"][f"fit_{how}"]
    assert fit["error"] is None, fit
    assert [m["job"] for m in fit["history"]] == [JOB_ID] * 3
    assert all(m["tags"] == [JOB_ID] for m in fit["history"]), fit


def _outcome(run: dict) -> dict:
    """The fields of (b) that must be equal across the packages."""
    lo, hi = run["lo"], run["hi"]
    notice = lo["notice_steps"][0] if lo.get("notice_steps") else None
    return {
        "status": {j: s[0] for j, s in run["status"].items()},
        "lo_error": lo["error"], "hi_error": hi["error"],
        "starts": [s - notice for s in lo.get("starts", [])]
        if notice is not None else None,
        "notice_steps": lo.get("notice_steps"),
        "preempt_ckpt": lo.get("preempt_ckpt"),
        "announced": lo["announced"] >= 1,
        "backoff": bool(lo["backoff_delays"]),
        "lo_max_step": lo.get("max_step"), "hi_max_step": hi.get("max_step"),
        "lo_sizes": lo["attempt_sizes"], "hi_sizes": hi["attempt_sizes"],
        "jobs": run["jobs"],
        # (a)'s fits may still show as job-abc, as long as their
        # sources are younger than the summary's 30 s horizon.
        "per_job": sorted(set(run["per_job"]) & {"train-lo", "train-hi"}),
        "notice_by": run["notice"]["by"],
        "doctor_critical": run["doctor_critical"],
    }


def _assert_jax_test_holds(run: dict) -> None:
    """test_multitenant_cluster.py's assertions, at this scenario's
    sizes (8 steps for train-lo, 6 for train-hi)."""
    assert run["status"]["train-hi"][0] == "SUCCEEDED", run["status"]
    assert run["hi"]["error"] is None and run["hi"]["max_step"] == 5
    assert run["status"]["train-lo"][0] == "SUCCEEDED", run["status"]
    lo = run["lo"]
    assert lo["error"] is None, lo
    assert lo["announced"] >= 1, lo
    assert lo["backoff_delays"], lo
    assert lo["notice_steps"] and all(lo["preempt_ckpt"]), lo
    notice_step = lo["notice_steps"][0]
    assert notice_step >= 2
    assert lo["starts"] == [0, notice_step], lo
    assert lo["max_step"] == 7
    assert run["jobs"]["train-hi"][0] == 10
    assert run["jobs"]["train-lo"][0] == 0
    assert run["jobs"]["train-hi"][1] == {"CPU": 2.0}
    assert all(s[2] == "SUCCEEDED" for s in run["jobs"].values())
    assert run["per_job"].get("train-lo", 0) > 0, run["per_job"]
    assert not run["doctor_critical"], run


def test_priority_preemption_matches_jax(runs):
    """(b) The outcome fields are equal across the two packages."""
    port, jax = runs["ray_tpu_torch"]["preemption"], \
        runs["ray_tpu"]["preemption"]
    assert "error" not in jax, jax
    assert "error" not in port, port
    assert _outcome(port) == _outcome(jax)


@pytest.mark.parametrize("package", PACKAGES)
def test_priority_preemption_keeps_the_jax_assertions(runs, package):
    run = runs[package]["preemption"]
    assert "error" not in run, run
    _assert_jax_test_holds(run)


def test_both_jobs_pay_for_their_workers_compute(runs):
    """The repair end to end: both jobs' workers' compute reaches the
    cluster goodput summary under their job ids."""
    per_job = runs["ray_tpu_torch"]["preemption"]["per_job"]
    assert per_job.get("train-lo", 0) > 0 and \
        per_job.get("train-hi", 0) > 0, per_job


def _settled(trace):
    """A trace without the clipped-to-now lengths of RUNNING tasks."""
    return [{k: v for k, v in ev.items()
             if not (k == "dur" and ev.get("args", {}).get("state")
                     == "RUNNING")} for ev in trace]


def test_timeline_is_util_state_timeline(runs):
    traces = runs["ray_tpu_torch"]["timeline"]
    assert isinstance(traces, tuple), traces
    top, state, written = map(_settled, traces)
    assert top and top == state == written
    assert _settled(runs["ray_tpu_torch"]["timeline_file"]) == written
