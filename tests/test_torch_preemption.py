"""The port's drain and preemption plane against the JAX package's.

Every test of ``tests/test_drain_plane.py`` that ``test_torch_doctor.py``
does not already run (the four doctor tests) runs here on the port: its
text pointed at ``ray_tpu_torch``, its own assertions unchanged.  The
GCP reap test is the one exception: the port's provider drives Compute
Engine for GPU VMs (``GCPGpuNodeProvider``, which reaps TERMINATED;
Spot has no PREEMPTED state there), so its accounting is held to the
JAX test's in ``test_reap_accounting_matches_jax``.

Beside each, what the JAX assertions leave open is compared with the
JAX package on the same inputs: the backoff schedules with their
jitter, the failure decisions over a grid of errors and counts,
``TrainControllerV2``'s attempts, announced failures, delays and state
sequence, the controller's drain bookkeeping (node rows, load metrics,
the resource view), the result queue's interrupt choice, and the
``checkpoint_on_notice`` phase's series.
"""

import asyncio
import importlib
import random
import re
import threading
import time
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _load_jax_test(filename: str, package: str = "ray_tpu",
                   gpu: bool = True):
    """A JAX test module, loaded fresh; for the port, its text with every
    ``ray_tpu`` module pointed at ``ray_tpu_torch`` and (with ``gpu``)
    the ``"TPU"`` resource named ``"GPU"``."""
    path = ROOT / "tests" / filename
    src = path.read_text()
    if package == "ray_tpu_torch":
        src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
        if gpu:
            src = src.replace('"TPU"', '"GPU"')
    mod = types.ModuleType(f"_{package}_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


ON_THE_PORT = [
    "test_backoff_schedule_exponential_and_capped",
    "test_backoff_jitter_bounds",
    "test_backoff_disabled_with_zero_base",
    "test_backoff_from_env_flags",
    "test_deterministic_user_errors_raise_immediately",
    "test_deterministic_classification_sees_remote_dual_types",
    "test_infra_errors_still_retry_within_budget",
    "test_preemption_always_retries",
    "test_controller_announced_failures_cost_no_budget",
    "test_controller_crash_still_burns_budget",
    "test_controller_deterministic_error_raises_without_retry",
    "test_controller_drain_marks_node_and_advertises_replacement",
    "test_controller_if_idle_drain_does_not_replace",
    "test_controller_drain_refused_when_agent_unreachable",
    "test_controller_drain_unknown_and_ambiguous_prefix",
    "test_heartbeat_mirrors_agent_drain_state",
    "test_result_queue_interrupt_earliest_deadline_wins",
    "test_preemption_sequence_sigterm_grace_sigkill",
    "test_preemption_killer_thread_respects_max_kills",
    "test_checkpoint_on_notice_goodput_phase",
]


@pytest.mark.parametrize("test", ON_THE_PORT)
def test_jax_test_on_the_port(test, tmp_path, monkeypatch):
    fn = getattr(_load_jax_test("test_drain_plane.py", "ray_tpu_torch"),
                 test)
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: args[p] for p in fn.__code__.co_varnames[
        :fn.__code__.co_argcount]})


# ----------------------------------------------------------- backoff
@pytest.mark.parametrize("kw", [
    dict(base_s=0.5, max_s=4.0, multiplier=2.0, jitter=0.0),
    dict(base_s=1.0, max_s=100.0, multiplier=1.0, jitter=0.25),
    dict(base_s=0.3, max_s=1.0, multiplier=2.0, jitter=0.25),
    dict(base_s=0.0),
    dict(base_s=2.0, max_s=60.0, multiplier=3.0, jitter=1.5),
])
def test_backoff_schedule_equals_jax_s(kw):
    """50 delays, a reset and 5 more, from one seeded generator each."""
    seqs = {}
    for package in PACKAGES:
        backoff = importlib.import_module(f"{package}.util.backoff")
        b = backoff.RestartBackoff(**kw, rng=random.Random(11))
        seq = [b.next_delay() for _ in range(50)]
        b.reset()
        seqs[package] = seq + [b.next_delay() for _ in range(5)]
    assert seqs["ray_tpu_torch"] == seqs["ray_tpu"]


def test_backoff_from_config_equals_jax_s(monkeypatch):
    monkeypatch.setenv("RT_RESTART_BACKOFF_BASE_S", "0.3")
    monkeypatch.setenv("RT_RESTART_BACKOFF_MAX_S", "1.0")
    monkeypatch.setenv("RT_RESTART_BACKOFF_JITTER", "0.25")
    got = {}
    for package in PACKAGES:
        b = importlib.import_module(
            f"{package}.train").RestartBackoff.from_config()
        got[package] = (b.base_s, b.max_s, b.multiplier, b.jitter)
    assert got["ray_tpu_torch"] == got["ray_tpu"] == (0.3, 1.0, 2.0, 0.25)


# -------------------------------------------- failure classification
def _errors(package: str) -> list:
    errors = importlib.import_module(f"{package}.core.errors")
    train = importlib.import_module(f"{package}.train")
    return [ValueError("v"), TypeError("t"), KeyError("k"),
            IndexError("i"), AttributeError("a"), ZeroDivisionError("z"),
            AssertionError("a"), NotImplementedError("n"),
            RuntimeError("r"), OSError("o"), TimeoutError("t"),
            errors.ActorDiedError("ab12", "worker exited"),
            errors.TaskError.from_exception(ValueError("remote")),
            errors.TaskError.from_exception(RuntimeError("remote")),
            train.PreemptionError("announced", node_id="n",
                                  reason="spot")]


def test_failure_decisions_equal_jax_s():
    """Every error against budgets -1..2 and failure counts 0..4."""
    got = {}
    for package in PACKAGES:
        train = importlib.import_module(f"{package}.train")
        got[package] = [
            train.FailurePolicy(max_failures=m).decide(n, e).value
            for e in _errors(package) for m in (-1, 0, 1, 2)
            for n in range(5)]
    assert got["ray_tpu_torch"] == got["ray_tpu"]


# --------------------------------- controller v2: announced failures
def _controller_run(package: str, tmp_path, outcomes, max_failures=0):
    mod = _load_jax_test("test_drain_plane.py", package)
    train = importlib.import_module(f"{package}.train")
    trainer = mod._FakeTrainer(tmp_path / package,
                               [o(train) if o else None for o in outcomes])
    trainer.run_config.failure_config.max_failures = max_failures
    ctl = train.TrainControllerV2(trainer, restart_backoff=train.
                                  RestartBackoff(base_s=0.01, max_s=0.04,
                                                 multiplier=2.0,
                                                 jitter=0.0))
    result = ctl.fit()
    return {"error": type(result.error).__name__ if result.error else None,
            "metrics": result.metrics, "attempts": trainer.attempts,
            "announced": ctl.announced_failures,
            "delays": ctl.backoff_delays, "sizes": ctl.attempt_sizes,
            "states": [{k: v for k, v in s.items() if k != "ts"}
                       for s in ctl.state_history]}


def _preempted(train):
    return train.PreemptionError("p")


def _crash(train):
    return RuntimeError("surprise")


def _user(train):
    return ValueError("bad config")


@pytest.mark.parametrize("outcomes,max_failures", [
    ((_preempted, _preempted, None), 0),
    ((_crash, None), 0),
    ((_crash, _preempted, _crash, None), 2),
    ((_preempted, _crash, _crash, None), 1),
    ((_user, None), 5),
], ids=["two-notices", "crash", "mixed-within-budget", "mixed-over-budget",
        "user-error"])
def test_controller_v2_run_equals_jax_s(tmp_path, outcomes, max_failures):
    runs = {p: _controller_run(p, tmp_path, outcomes, max_failures)
            for p in PACKAGES}
    assert runs["ray_tpu_torch"] == runs["ray_tpu"]


# ------------------------------------- controller drain bookkeeping
DRAIN_TESTS = [
    "test_controller_drain_marks_node_and_advertises_replacement",
    "test_controller_if_idle_drain_does_not_replace",
    "test_controller_drain_refused_when_agent_unreachable",
    "test_controller_drain_unknown_and_ambiguous_prefix",
    "test_heartbeat_mirrors_agent_drain_state",
]


def _drain_record(ctl) -> dict:
    """A drain scenario's controller state, random ids as indices and
    deadlines as remaining seconds rounded to whole ones."""
    order = {nid: i for i, nid in enumerate(ctl.nodes)}
    by_hex = {nid.hex(): i for nid, i in order.items()}
    now = time.time()
    nodes = [(order[nid], n.draining, n.drain_reason,
              round(n.drain_deadline - now) if n.drain_deadline else 0,
              n.resources_total) for nid, n in ctl.nodes.items()]
    lm = asyncio.run(ctl.get_load_metrics({}))
    view = asyncio.run(ctl.resource_view({}))
    rows = asyncio.run(ctl.list_nodes({}))
    return {"nodes": nodes, "pending": lm["pending_demands"],
            "load_nodes": sorted((by_hex[k], v.get("draining"))
                                 for k, v in lm["nodes"].items()),
            "view": sorted(order[n] for n in view),
            "rows": [r.get("draining") for r in rows]}


@pytest.mark.parametrize("test", DRAIN_TESTS)
def test_drain_bookkeeping_equals_jax_s(test):
    records = {}
    for package in PACKAGES:
        mod = _load_jax_test("test_drain_plane.py", package, gpu=False)
        made = []
        make = mod._make_controller

        def recorded(make=make, made=made):
            ctl, nid = make()
            made.append(ctl)
            return ctl, nid

        mod._make_controller = recorded
        getattr(mod, test)()
        records[package] = [_drain_record(c) for c in made]
    assert records["ray_tpu"]
    assert records["ray_tpu_torch"] == records["ray_tpu"]


def test_result_queue_choice_equals_jax_s():
    """A stream of notices, some tighter and some looser: the queue's
    pick after each is the same node in both packages."""
    rng = random.Random(5)
    notices = [{"node_id": f"n{i}", "deadline": rng.uniform(0, 100)}
               for i in range(40)] + [{"node_id": "none"}]
    picks = {}
    for package in PACKAGES:
        q = importlib.import_module(
            f"{package}.train.trainer")._ResultQueue._cls()
        seen = []
        for n in notices:
            q.set_interrupt(dict(n))
            seen.append(q.interrupt_info()["node_id"])
        picks[package] = seen
    assert picks["ray_tpu_torch"] == picks["ray_tpu"]


def test_checkpoint_on_notice_series_equal_jax_s():
    """The sub-phase's ledger keys and its histogram, in both packages."""
    got = {}
    for package in PACKAGES:
        session = importlib.import_module(f"{package}.train.session")
        goodput = importlib.import_module(f"{package}.util.goodput")
        metrics = importlib.import_module(f"{package}.util.metrics")
        metrics.registry().clear()
        goodput.reset()
        with session.checkpoint_on_notice():
            assert goodput.current_phase() == "checkpoint_on_notice"
        snap = goodput.ledger().snapshot()
        names = sorted(m["name"] for m in metrics.registry().snapshot())
        got[package] = (sorted(snap["seconds"]), names,
                        snap["seconds"]["checkpoint"])
        metrics.registry().clear()
        goodput.reset()
    assert got["ray_tpu_torch"] == got["ray_tpu"]


# --------------------------------------- cloud provider preemption reap
def _reap(provider_cls, listing_key: str, listing, tracked) -> dict:
    """``reap_preempted`` on a provider with no cloud behind it (as the
    JAX test builds one): which nodes it reaps, keeps, deletes, kills."""
    provider = object.__new__(provider_cls)
    provider._lock = threading.Lock()
    provider._nodes = {}
    killed, deleted = [], []

    class _Node:
        def __init__(self, name):
            self.provider_node_id = name

    provider.api = types.SimpleNamespace(**{listing_key: lambda: listing})
    provider._kill_node_pids = lambda node: killed.append(
        node.provider_node_id)
    provider._delete_cloud_node = deleted.append
    provider._delete_instance = deleted.append
    for name in tracked:
        provider._nodes[name] = _Node(name)
    reaped = provider.reap_preempted()
    return {"reaped": sorted(reaped), "kept": sorted(provider._nodes),
            "deleted": sorted(deleted), "killed": sorted(killed)}


def test_reap_accounting_matches_jax():
    """``test_gcp_reap_preempted_relaunch_accounting``'s cluster on both
    providers: JAX's TPU nodes READY / PREEMPTED / TERMINATED / missing,
    the port's GPU VMs RUNNING / TERMINATED / TERMINATED / missing (a
    preempted Spot VM stops as TERMINATED).  The same nodes are reaped,
    kept, deleted and killed; a VM missing from the listing, or still
    STOPPING, is unknown and kept."""
    from ray_tpu.autoscaler.gcp_provider import GCPTpuNodeProvider
    from ray_tpu_torch.autoscaler.gcp_provider import GCPGpuNodeProvider

    tracked = ("keep", "gone", "term", "vanished")
    jax = _reap(GCPTpuNodeProvider, "list_nodes", [
        {"nodeId": "keep", "state": "READY"},
        {"nodeId": "gone", "state": "PREEMPTED"},
        {"name": "projects/p/locations/z/nodes/term",
         "state": "TERMINATED"}], tracked)
    port = _reap(GCPGpuNodeProvider, "list_instances", [
        {"name": "keep", "status": "RUNNING"},
        {"name": "gone", "status": "TERMINATED"},
        {"name": "term", "status": "TERMINATED"}], tracked)
    assert port == jax == {"reaped": ["gone", "term"],
                           "kept": ["keep", "vanished"],
                           "deleted": ["gone", "term"],
                           "killed": ["gone", "term"]}
    stopping = _reap(GCPGpuNodeProvider, "list_instances", [
        {"name": "keep", "status": "STOPPING"}], ("keep",))
    assert stopping["reaped"] == [] and stopping["kept"] == ["keep"]


def test_reap_survives_a_failed_listing():
    """A listing that raises reaps nothing, in both providers."""
    from ray_tpu.autoscaler.gcp_provider import GCPTpuNodeProvider
    from ray_tpu_torch.autoscaler.gcp_provider import GCPGpuNodeProvider

    def boom():
        raise RuntimeError("503")

    for cls, key in ((GCPTpuNodeProvider, "list_nodes"),
                     (GCPGpuNodeProvider, "list_instances")):
        provider = object.__new__(cls)
        provider._lock = threading.Lock()
        provider._nodes = {"a": object()}
        provider.api = types.SimpleNamespace(**{key: boom})
        assert provider.reap_preempted() == []
        assert list(provider._nodes) == ["a"]
