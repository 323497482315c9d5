"""The port's copies of the telemetry plane against the JAX package's
modules on the same calls: the goodput ledger, the metrics registry and
its Prometheus text, histogram quantiles, the flight recorder, span
contexts, the Chrome-trace and request-trace assembly, and the
collective-op series of an eager gloo group.

Everything here is deterministic (a fake clock, explicit latencies,
fixed span lists), so the outputs must be equal, except where a value is
the wall clock or a process id; those are named in each test.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
from datetime import timedelta

import numpy as np
import pytest
import torch

from ray_tpu.collective import telemetry as jax_coll_tel
from ray_tpu.util import flight_recorder as jax_fr
from ray_tpu.util import goodput as jax_goodput
from ray_tpu.util import metrics as jax_metrics
from ray_tpu.util import reqtrace as jax_reqtrace
from ray_tpu.util import spans as jax_spans
from ray_tpu.util import telemetry as jax_telemetry
from ray_tpu.util import timeline as jax_timeline
from ray_tpu.util import tracing as jax_tracing
from ray_tpu_torch.collective import telemetry as coll_tel
from ray_tpu_torch.util import flight_recorder as fr
from ray_tpu_torch.util import goodput, metrics, reqtrace, spans
from ray_tpu_torch.util import telemetry, timeline, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean_registries():
    for reg in (metrics.registry(), jax_metrics.registry()):
        reg.clear()
    yield
    for reg in (metrics.registry(), jax_metrics.registry()):
        reg.clear()


def _snapshot(mod):
    return sorted(mod.registry().snapshot(), key=lambda s: s["name"])


# ------------------------------------------------------------ goodput
def _basic(led, clk):
    with led.phase("compute"):
        clk.advance(3.0)
    clk.advance(1.0)


def _nested(led, clk):
    with led.phase("compute"):
        clk.advance(2.0)
        with led.phase("checkpoint"):
            clk.advance(5.0)
        clk.advance(1.0)


def _fractions(led, clk):
    with led.phase("compile"):
        clk.advance(1.0)
    with led.phase("compute"):
        clk.advance(7.0)
    clk.advance(2.0)


def _restart(led, clk):
    with led.phase("compute"):
        clk.advance(4.0)
    led.enter("restart")
    clk.advance(6.0)
    led.exit()
    with led.phase("compute"):
        clk.advance(10.0)


@pytest.mark.parametrize("scenario", [_basic, _nested, _fractions,
                                      _restart])
def test_goodput_ledger_matches_jax(scenario):
    """The cases of tests/test_telemetry.py's goodput math: snapshots
    and fractions under one fake clock, equal as dicts; the published
    rt_goodput_seconds series too."""
    out = []
    for mod in (goodput, jax_goodput):
        clk = FakeClock()
        led = mod.GoodputLedger(clock=clk)
        scenario(led, clk)
        out.append((led.snapshot(), led.fractions()))
    assert out[0] == out[1]
    assert _snapshot(metrics) == _snapshot(jax_metrics)
    assert sum(out[0][1].values()) == pytest.approx(1.0, abs=1e-12)


def test_goodput_unknown_phase_and_summary_match_jax():
    for mod in (goodput, jax_goodput):
        with pytest.raises(ValueError):
            mod.GoodputLedger(publish=False).enter("coffee_break")

    def snap(compute, idle):
        return [{"name": "rt_goodput_seconds", "kind": "gauge",
                 "series": [
                     {"tags": {"phase": "compute", "job": "j"},
                      "value": compute},
                     {"tags": {"phase": "idle"}, "value": idle}]}]

    sources = {"worker-a": snap(6.0, 2.0), "worker-b": snap(3.0, 1.0)}
    got = goodput.summarize_sources(sources)
    assert got == jax_goodput.summarize_sources(sources)
    assert got["fractions"]["compute"] == pytest.approx(0.75)


def test_timed_phase_and_current_phase_match_jax():
    """``timed_phase`` attributes its block and observes its histogram;
    ``current_phase`` names the innermost phase.  The histogram's
    observations are wall-clock durations: compared by count only."""
    for mod in (goodput, jax_goodput):
        mod.reset()
        with mod.timed_phase("checkpoint", "t_ckpt_seconds", "Saves.",
                             tags={"sharded": "1"},
                             tag_keys=("sharded",)):
            assert mod.current_phase() == "checkpoint"
        assert mod.current_phase() is None
    got, want = (
        {s["name"]: s for s in _snapshot(m)}["t_ckpt_seconds"]
        for m in (metrics, jax_metrics))
    assert [s["tags"] for s in got["series"]] == \
        [s["tags"] for s in want["series"]] == [{"sharded": "1"}]
    assert got["series"][0]["hist"]["count"] == 1


# ------------------------------------------------- registry, Prometheus
def _fill(mod):
    c = mod.Counter("tel_requests_total", "Requests.",
                    tag_keys=("route",))
    c.inc(tags={"route": "a"})
    c.inc(2.5, tags={"route": "b"})
    mod.Gauge("tel_depth", "Queue depth.").set(7)
    h = mod.Histogram("tel_lat", "Latency.", boundaries=[0.1, 1.0],
                      tag_keys=("route",))
    funky = 'a"b\\c\nd'
    for v in (0.05, 0.1, 0.5, 5.0):
        h.observe(v, tags={"route": funky})
    mod.observe_ttft_phase("prefill", 0.02)
    with pytest.raises(ValueError):
        mod.Gauge("tel_depth2", tag_keys=("x",)).set(1, tags={"y": "1"})
    with pytest.raises(ValueError):
        mod.Counter("tel_depth")        # registered as a gauge


def test_registry_snapshot_and_prometheus_text_match_jax():
    """The same metric calls in both registries: equal snapshots and a
    byte-equal Prometheus exposition (+Inf bucket, label escaping,
    the ``source`` label)."""
    for mod in (metrics, jax_metrics):
        _fill(mod)
    assert _snapshot(metrics) == _snapshot(jax_metrics)
    text = metrics.render_prometheus(
        {"me": metrics.registry().snapshot(), "": []})
    assert text == jax_metrics.render_prometheus(
        {"me": jax_metrics.registry().snapshot(), "": []})
    assert 'route="a\\"b\\\\c\\nd"' in text
    inf = next(line for line in text.splitlines()
               if line.startswith("tel_lat_bucket") and "+Inf" in line)
    assert inf.endswith(" 4")


@pytest.mark.parametrize("buckets,count,q", [
    ([3, 5, 0, 2], 10, 0.5), ([3, 5, 0, 2], 10, 0.99),
    ([0, 0, 0, 4], 4, 0.5), ([1, 0, 0, 0], 1, 0.99), ([], 0, 0.5)])
def test_histogram_quantiles_match_jax(buckets, count, q):
    bounds = [0.1, 1.0, 10.0]
    assert telemetry._hist_quantile(bounds, buckets, count, q) == \
        jax_telemetry._hist_quantile(bounds, buckets, count, q)
    hist = {"buckets": buckets, "count": count, "sum": 5.0}
    assert telemetry._hist_stats(bounds, hist) == \
        jax_telemetry._hist_stats(bounds, hist)


def test_cluster_summary_waits_for_the_runtime():
    """Without a runtime (and no address) there is no controller to read:
    a ConnectionError, as the JAX package raises when it finds no
    cluster."""
    from ray_tpu_torch.core import runtime as runtime_mod

    assert runtime_mod.get_runtime_quiet() is None
    with pytest.raises(ConnectionError, match="No cluster"):
        telemetry.cluster_summary()


# ------------------------------------------------ cluster summary (read)
def _recorded_sources(mod):
    """Two sources' snapshots, recorded through ``mod``'s registry, that
    reach every section of the summary: goodput (with a job), train
    gauges and histograms (sharded and blob checkpoints), collectives,
    serve ingress, TTFT and its phases, resilience counters and breaker
    gauges, the LLM engine, the object store, the worker pool and the
    xla programs and device memory."""
    reg = mod.registry()
    out = {}
    for src, k in (("node:a", 1.0), ("worker:b", 2.0)):
        reg.clear()

        def g(name, value, **tags):
            mod.Gauge(name, "", tag_keys=tuple(tags)).set(value, tags=tags)

        def c(name, value, **tags):
            mod.Counter(name, "", tag_keys=tuple(tags)).inc(value,
                                                            tags=tags)

        def h(name, values, **tags):
            hist = mod.Histogram(name, "", tag_keys=tuple(tags))
            for v in values:
                hist.observe(v, tags=tags)

        for phase, sec in (("compute", 40.0), ("compile", 3.0),
                           ("data_stall", 1.5), ("checkpoint", 2.0)):
            g("rt_goodput_seconds", sec * k, phase=phase, job="job-7")
        for name, value in (("rt_train_step", 10 * k),
                            ("rt_train_tokens_per_sec", 1.2e5 * k),
                            ("rt_train_mfu", 0.11 * k),
                            ("rt_train_compile_seconds", 2.5),
                            ("rt_train_achieved_flops_per_sec", 1e14 * k),
                            ("rt_train_workers", 2)):
            g(name, value)
        h("rt_train_step_time_seconds", [0.13, 0.14 * k, 0.15])
        h("rt_train_data_wait_seconds", [0.001, 0.002 * k])
        h("rt_train_checkpoint_save_seconds", [1.2 * k], sharded="1")
        h("rt_train_checkpoint_save_seconds", [0.3], sharded="0")
        h("rt_train_checkpoint_restore_seconds", [0.9], sharded="1")
        c("rt_checkpoint_bytes", 1.5e9 * k)
        c("rt_checkpoint_shards", 4)
        h("rt_collective_latency_seconds", [0.0002, 0.0003 * k],
          op="allreduce", backend="nccl", world="4")
        g("rt_collective_bus_bandwidth_bytes_per_sec", 2e11 * k,
          op="allreduce", backend="nccl", world="4")
        for cls, n in (("2xx", 30 * k), ("4xx", 2), ("5xx", 1 * k),
                       ("shed", 3), ("deadline", 1)):
            c("rt_serve_requests_total", n, deployment="llm",
              status_class=cls)
            h("rt_serve_request_seconds", [0.05 * k, 0.2] * int(n),
              deployment="llm", outcome="ok", status_class=cls)
        h("rt_serve_ttft_seconds", [0.02, 0.04 * k, 0.3],
          deployment="llm")
        for phase in ("proxy", "admission_queue", "engine_waiting",
                      "prefill"):
            h("rt_serve_ttft_phase_seconds", [0.001 * k, 0.01],
              phase=phase)
        g("rt_serve_inflight", 3 * k)
        c("rt_serve_retries_total", 2 * k, deployment="llm")
        c("rt_serve_shed_total", 3, deployment="llm")
        c("rt_serve_deadline_exceeded_total", 1, deployment="llm")
        g("rt_serve_queue_depth", 4 * k, deployment="llm")
        g("rt_serve_breaker_open", 1.0 if k > 1 else 0.0,
          deployment="llm", replica="abcdef123456")
        for name, value in (("rt_llm_kv_pages_used", 12 * k),
                            ("rt_llm_kv_pages_total", 256),
                            ("rt_llm_batch_size", 8),
                            ("rt_llm_waiting", 2 * k)):
            g(name, value)
        for name, value in (("rt_llm_tokens_total", 1024 * k),
                            ("rt_llm_prefill_tokens_total", 512 * k),
                            ("rt_llm_evictions_total", k)):
            c(name, value)
        h("rt_llm_tpot_seconds", [0.018, 0.021 * k])
        g("rt_object_spilled_bytes", 1e6 * k)
        c("rt_object_spill_total", 3 * k)
        c("rt_object_restore_total", 1)
        g("rt_worker_pool_idle", 4 * k)
        g("rt_worker_pool_target", 8)
        c("rt_worker_adoptions_total", 5 * k)
        c("rt_worker_cold_spawn_total", 2)
        c("rt_task_events_dropped_total", k - 1)
        for phase in ("spawn", "import", "connect", "adopt"):
            h("rt_worker_startup_seconds", [0.5 * k, 0.02], phase=phase)
        for fn, flops in (("train_step", 1.7e13), ("llm_decode", 2.1e9),
                          ("llm_prefill[16]", 3.4e10)):
            g("rt_xla_cost_flops", flops * k, fn=fn)
            g("rt_xla_cost_bytes", flops / 70, fn=fn)
            g("rt_xla_memory_bytes", 4.4e9 / k, fn=fn, kind="temp")
            g("rt_xla_collective_bytes", 3e8 * k, fn=fn, axis="data",
              op="all-reduce")
            c("rt_xla_compiles_total", 1, fn=fn)
            c("rt_xla_compile_seconds_total", 0.8 * k, fn=fn)
        for kind, value in (("used", 5e9 * k), ("peak", 9e9), ("limit",
                                                              8e10)):
            g("rt_xla_device_memory_bytes", value, device="0", kind=kind)
        out[src] = json.loads(json.dumps(reg.snapshot()))
    reg.clear()
    return out


def _recorded_history():
    """The controller's flattened history: cumulative status-class
    counters of two proxies (a burst of errors in the last minutes) and
    train gauges."""
    out = {}
    for src, k in (("node:a", 1), ("node:b", 3)):
        rows, ok, bad = [], 0.0, 0.0
        for i in range(40):
            ts = 1000.0 + 60.0 * i
            ok += 50 * k
            bad += (20 if i >= 34 else 0) * k
            rows.append([ts, {
                "rt_serve_requests_total{deployment=llm,"
                "status_class=2xx}": ok,
                "rt_serve_requests_total{deployment=llm,"
                "status_class=5xx}": bad,
                "rt_serve_requests_total{deployment=echo,"
                "status_class=2xx}": ok / 2,
                "rt_train_step": float(i), "rt_goodput_seconds{phase="
                "compute}": 10.0 * i, "rt_object_spill_total": 1.0}])
        out[src] = rows
    return out


_RESILIENCE = {"ts": 3300.0, "deployments": {"llm": {
    "replicas": 2, "target": 2, "draining": 0,
    "replacements": [{"index": 1, "ts": 3000.0, "reason": "health_probe"}],
    "breakers": {"abcdef1234567890": {"state": "open", "ts": 3200.0,
                                      "reporter": "1f.2"}},
    "queue_depth": 4}}}

_SLO_CONFIG = json.dumps({
    "llm": {"availability": 0.999, "ttft_p99_ms": 100,
            "latency_p99_ms": 500, "window_s": 3600},
    "default": {"availability": 0.99}})


@pytest.fixture
def recorded(monkeypatch):
    """Both packages' state readers answer with the same recorded
    payloads; the SLO objectives come from ``RT_SLO_CONFIG``."""
    from ray_tpu.util import state as jax_state
    from ray_tpu_torch.util import state

    sources = _recorded_sources(jax_metrics)
    assert sources == _recorded_sources(metrics)   # the same snapshots
    raw = {"ts": 3400.0, "sources": sources, "flight": [
        {"source": "worker:b", "reason": "SIGTERM", "events": [1, 2],
         "sticky": {"last_task": {"name": "step", "state": "RUNNING"}},
         "path": "/flight/b.json"}]}
    for mod in (state, jax_state):
        monkeypatch.setattr(mod, "telemetry", lambda address=None: raw)
        monkeypatch.setattr(mod, "metrics_history",
                            lambda source=None, address=None:
                            _recorded_history())
        monkeypatch.setattr(mod, "serve_resilience",
                            lambda address=None: _RESILIENCE)
    monkeypatch.setenv("RT_SLO_CONFIG", _SLO_CONFIG)
    return raw


def test_cluster_summary_and_render_text_match_jax(recorded):
    got, want = telemetry.cluster_summary(), jax_telemetry.cluster_summary()
    assert got == want
    for section in ("goodput", "train", "collectives", "serve", "llm",
                    "checkpoints", "object_store", "worker_pool", "xla",
                    "slo", "flight", "train_series"):
        assert want[section], section       # every section was reached
    assert got["serve"]["resilience"] == _RESILIENCE["deployments"]
    assert telemetry.render_text(got) == jax_telemetry.render_text(want)


def test_slo_evaluation_matches_jax(recorded):
    from ray_tpu.util import slo as jax_slo
    from ray_tpu_torch.util import slo

    sources = recorded["sources"]
    reports = []
    for mod in (slo, jax_slo):
        objectives, default = mod.objectives_from_env()
        reports.append(mod.evaluate_all(
            objectives, mod.status_series(_recorded_history()), now=3400.0,
            latency_p99_ms=mod.latency_p99s(sources),
            ttft_p99_ms=mod.latency_p99s(sources, metric=mod.TTFT_METRIC),
            default_spec=default))
    assert reports[0] == reports[1]
    assert {r["status"] for r in reports[0]["objectives"]} != {"ok"}
    assert slo.render_text(reports[0]) == jax_slo.render_text(reports[1])
    assert slo.report(now=3400.0) == jax_slo.report(now=3400.0)


def test_cluster_report_matches_jax(recorded, monkeypatch):
    """The same peaks in both packages (their tables hold an H100's and
    a TPU's): the reports are equal but for the wall-clock "ts" and the
    peaks' label (the port's ``device`` for JAX's TPU ``gen``, the
    rendered peaks line)."""
    from ray_tpu.util import xprof as jax_xprof
    from ray_tpu_torch.util import xprof

    monkeypatch.setenv("RT_PEAK_FLOPS_PER_DEVICE", "989e12")
    monkeypatch.setenv("RT_PEAK_HBM_BYTES_PER_SEC", "3.35e12")
    monkeypatch.setenv("RT_INTERCONNECT_BYTES_PER_SEC", "450e9")
    summary = telemetry.cluster_summary()
    got = xprof.cluster_report(summary=summary)
    want = jax_xprof.cluster_report(summary=summary)
    def rates(report):
        peaks = {k: v for k, v in report["peaks"].items()
                 if k not in ("device", "gen")}
        return {**report, "ts": None, "peaks": peaks}

    assert rates(got) == rates(want)
    assert sorted(got["programs"]) == ["llm_decode", "llm_prefill[16]",
                                       "train_step"]
    assert rates(xprof.cluster_report()) == rates(got)
    text, want_text = (xprof.render_report(got),
                       jax_xprof.render_report(want))
    assert text.splitlines()[1:] == want_text.splitlines()[1:]


def test_cluster_summary_reads_a_live_port_cluster():
    """On a port cluster: a task's gauge, counter and histogram reach
    the controller and come back through ``cluster_summary`` (goodput
    and serve sections included); ``state.load_metrics``,
    ``metrics_history``, ``serve_resilience`` and ``perf`` answer."""
    import time

    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state

    rt.init(mode="cluster", num_cpus=2,
            config={"metrics_report_period_s": 0.5})
    try:
        @rt.remote
        def publish():
            from ray_tpu_torch.util import goodput as gp
            from ray_tpu_torch.util import metrics as m

            m.Gauge("rt_goodput_seconds", "", tag_keys=("phase",)).set(
                7.0, tags={"phase": "compute"})
            m.Counter("rt_serve_requests_total", "",
                      tag_keys=("deployment", "status_class")).inc(
                3, tags={"deployment": "d", "status_class": "2xx"})
            m.Histogram("rt_serve_request_seconds", "",
                        tag_keys=("deployment",)).observe(
                0.25, tags={"deployment": "d"})
            time.sleep(3.0)         # outlive a few report periods
            return gp.GAUGE_NAME

        assert rt.get(publish.remote(), timeout=120) == "rt_goodput_seconds"
        deadline = time.time() + 60
        while time.time() < deadline:
            summary = telemetry.cluster_summary()
            if summary["serve"].get("requests", {}).get("d"):
                break
            time.sleep(0.5)
        assert summary["serve"]["requests"]["d"]["count"] == 1
        assert summary["serve"]["status_classes"]["d"] == {"2xx": 3.0}
        assert summary["goodput"]["seconds"]["compute"] == 7.0
        assert "Serve ingress:" in telemetry.render_text(summary)
        assert "nodes" in state.load_metrics() or state.load_metrics()
        assert state.metrics_history()
        assert state.serve_resilience() == {}
        assert state.perf()["programs"] == {}
    finally:
        rt.shutdown()


# ------------------------------------------------------ flight recorder
def test_flight_recorder_ring_and_dump_match_jax(tmp_path):
    """Bounded ring, sticky slots and the dump's payload: equal except
    the wall-clock stamps ("ts") and the pid."""
    dumps = []
    for mod in (fr, jax_fr):
        rec = mod.FlightRecorder(capacity=4, source="unit")
        for i in range(10):
            rec.record("tick", i=i)
        rec.note("task", name="t1")
        path = rec.dump(reason="unit-test",
                        path=str(tmp_path / f"{mod.__name__}.json"))
        assert path == rec.last_dump_path
        dumps.append(json.loads(open(path).read()))

    def strip(d):
        d = {k: v for k, v in d.items() if k not in ("ts", "pid")}
        d["events"] = [{k: v for k, v in e.items() if k != "ts"}
                       for e in d["events"]]
        d["sticky"] = {k: {f: x for f, x in v.items() if f != "ts"}
                       for k, v in d["sticky"].items()}
        return d

    assert strip(dumps[0]) == strip(dumps[1])
    assert [e["i"] for e in dumps[0]["events"]] == [6, 7, 8, 9]


def test_flight_recorder_dump_on_sigterm(tmp_path):
    """A process killed by SIGTERM leaves a parseable dump and still
    exits as killed (the JAX test's case, on the port's module)."""
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        from ray_tpu_torch.util import flight_recorder
        flight_recorder.install(dump_dir={str(tmp_path)!r},
                                source="victim")
        for i in range(5):
            flight_recorder.record("step", i=i)
        print("READY", flush=True)
        time.sleep(60)
    """)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == -signal.SIGTERM
    finally:
        proc.kill()
    dump = json.loads(open(tmp_path / "victim.json").read())
    assert dump["reason"] == "signal 15"
    assert [e["i"] for e in dump["events"]
            if e["kind"] == "step"] == [0, 1, 2, 3, 4]


# ----------------------------------------------------- spans, tracing
def test_request_scope_tags_spans_like_jax():
    """Spans recorded inside a request scope carry its id; a nested
    ``start_span`` keeps the trace and parent linkage.  Ids are random:
    compared by structure."""
    out = []
    for sp, tr in ((spans, tracing), (jax_spans, jax_tracing)):
        ring = sp.reset()
        assert tr.current_request_id() is None
        with tr.request_scope("rid-1"):
            assert tr.current_request_id() == "rid-1"
            sp.record_span("prefill", 1.0, 2.0, cat="llm",
                           tags={"seq": 1})
            with tr.start_span("inner"):
                sp.record_span("decode", 2.0, 3.0, cat="llm")
        with tr.request_scope(None):
            sp.record_span("untraced", 3.0, 4.0)
        got = ring.snapshot()
        assert got[0]["trace_id"] == "req-rid-1"
        inner = next(s for s in got if s["name"] == "inner")
        decode = next(s for s in got if s["name"] == "decode")
        assert decode["parent_span_id"] == inner["span_id"]
        # The start_span block's endpoints are the wall clock.
        out.append([(s["name"], s["cat"], s.get("tags"), "trace_id" in s)
                    + ((s["start"], s["end"]) if s["name"] != "inner"
                       else ()) for s in got])
    assert out[0] == out[1]
    assert spans.flush() is False


def _span_set():
    """Two requests' hops and a two-rank, two-step training timeline."""
    s = []
    for rid, t0 in (("r1", 10.0), ("r2", 10.5)):
        s += [{"name": "ingress", "cat": "serve", "start": t0,
               "end": t0 + 0.9, "pid": 1, "span_id": f"{rid}i",
               "tags": {"request_id": rid, "deployment": "llm"}},
              {"name": "admission_wait", "cat": "serve",
               "start": t0 + 0.01, "end": t0 + 0.05, "pid": 1,
               "tags": {"request_id": rid}},
              {"name": "engine_waiting", "cat": "llm",
               "start": t0 + 0.1, "end": t0 + 0.2, "pid": 2,
               "parent_span_id": f"{rid}i", "span_id": f"{rid}w",
               "tags": {"request_id": rid, "seq": 1}},
              {"name": "prefill", "cat": "llm", "start": t0 + 0.2,
               "end": t0 + 0.35, "pid": 2,
               "tags": {"request_id": rid, "prompt_tokens": 16}},
              {"name": "decode", "cat": "llm", "start": t0 + 0.35,
               "end": t0 + 0.85, "pid": 2,
               "tags": {"request_id": rid, "tokens": 32}}]
    for step in (1, 2):
        for rank, dt in ((0, 0.5), (1, 0.7)):
            s.append({"name": "step", "cat": "train_step",
                      "start": 20.0 + step, "end": 20.0 + step + dt,
                      "pid": 10 + rank, "source": f"w{rank}",
                      "tags": {"step": step, "rank": rank}})
    s += [{"name": "data_stall", "cat": "phase", "start": 21.1,
           "end": 21.4, "pid": 11, "source": "w1"},
          {"name": "checkpoint", "cat": "phase", "start": 22.0,
           "end": 22.2, "pid": 11, "source": "w1"}]
    return s


def test_trace_assembly_and_timeline_match_jax():
    """``assemble_trace``, ``ttft_phases``, ``find_request_ids``,
    ``render_trace``, ``build_trace`` and ``critical_path_summary`` on
    one span list: equal outputs."""
    s = _span_set()
    tasks = [{"name": "f", "task_id": "t1", "node_id": "abcdef0123",
              "worker_pid": 7, "state": "FINISHED",
              "times": {"RUNNING": 1.0, "FINISHED": 2.0}},
             {"name": "g", "task_id": "t2", "node_id": "abcdef0123",
              "worker_pid": 7, "state": "RUNNING",
              "times": {"RUNNING": 3.0}}]
    history = {"w0": [(21.0, {"rt_train_mfu": 0.3,
                              "rt_goodput_seconds{phase=compute}": 5.0})]}
    for rid in ("r1", "r2", "missing"):
        got = reqtrace.assemble_trace(s, rid)
        assert got == jax_reqtrace.assemble_trace(s, rid)
        assert reqtrace.render_trace(got) == \
            jax_reqtrace.render_trace(got)
    assert reqtrace.ttft_phases(s[:5]) == jax_reqtrace.ttft_phases(s[:5])
    assert reqtrace.find_request_ids(s) == \
        jax_reqtrace.find_request_ids(s) == ["r1", "r2"]
    assert timeline.build_trace(tasks, s, history, now=30.0) == \
        jax_timeline.build_trace(tasks, s, history, now=30.0)
    summary = timeline.critical_path_summary(s)
    assert summary == jax_timeline.critical_path_summary(s)
    assert summary["steps"][0]["dominant_wait"] == "data_stall"
    assert timeline.render_summary(summary) == \
        jax_timeline.render_summary(summary)


# ------------------------------------------------------- collectives
def test_record_op_series_match_jax():
    """``record_op`` with explicit latencies: identical latency
    histograms and bus-bandwidth gauges (nccl-tests factors)."""
    calls = [("allreduce", "nccl", 4, 1 << 20, 0.002),
             ("allgather", "nccl", 4, 1 << 20, 0.001),
             ("broadcast", "cpu", 2, 4096, 0.0005),
             ("barrier", "cpu", 2, 0, 0.0001),
             ("allreduce", "cpu", 1, 64, 0.00002)]
    for mod in (coll_tel, jax_coll_tel):
        for call in calls:
            mod.record_op(*call)
    assert _snapshot(metrics) == _snapshot(jax_metrics)


class _DictStore:
    def __init__(self):
        self.kv = {}

    def set(self, k, v):
        self.kv[k] = v

    def get(self, k):
        return self.kv.get(k)


def test_collective_latency_histogram_tags_match_jax(tmp_path):
    """tests/test_telemetry.py::test_collective_latency_histogram_tags
    on a world-1 gloo ``CPUGroup`` of the port and on JAX's
    ``CPUGroup``: the same series (names, tags, observation counts);
    the latencies themselves are wall-clock times."""
    from ray_tpu.collective.collective_group.cpu_group import \
        CPUGroup as JaxCPUGroup
    from ray_tpu_torch.collective.collective_group.base import \
        standalone_gloo_group
    from ray_tpu_torch.collective.collective_group.cpu_group import \
        CPUGroup

    pg = standalone_gloo_group(f"file://{tmp_path}/g", 1, 0,
                               timedelta(seconds=30))
    port = CPUGroup("telemetry_test", 1, 0, pg)
    jax_group = JaxCPUGroup("telemetry_test", 1, 0, _DictStore())
    try:
        assert float(port.allreduce(torch.ones(8)).sum()) == 8.0
        assert jax_group.allreduce(np.ones(8, np.float32)).sum() == 8.0
        port.barrier()
        jax_group.barrier()
        port.broadcast(torch.ones(16))
        jax_group.broadcast(np.ones(16, np.float32))
    finally:
        port.destroy()
        jax_group.destroy()

    def shape(mod):
        out = {}
        for snap in mod.registry().snapshot():
            for s in snap["series"]:
                key = (snap["name"], tuple(sorted(s["tags"].items())))
                out[key] = s["hist"]["count"] if "hist" in s \
                    else s["value"] > 0
        return out

    got = shape(metrics)
    assert got == shape(jax_metrics)
    assert got[("rt_collective_latency_seconds",
                (("backend", "cpu"), ("op", "allreduce"),
                 ("world", "1")))] == 1
    assert got[("rt_collective_bus_bandwidth_bytes_per_sec",
                (("backend", "cpu"), ("op", "broadcast"),
                 ("world", "1")))] is True
    assert coll_tel.inflight_entries() == []


# Per-call latency and device time (ms) of 256 MiB NCCL ops at world 1
# on an NVIDIA H100 80GB HBM3 at 700 W (tools/nccl_check_spread.py): two
# spans that cover the op, and the allreduce's span with the group's
# completion wait taken out.
_NCCL_CALLS = {
    "allreduce": ([0.5012, 0.2793, 0.2514, 0.228, 0.2145],
                  [0.4106, 0.2368, 0.2194, 0.2048, 0.1936], True),
    "broadcast": ([0.2252, 0.2208, 0.2131, 0.21, 0.2109],
                  [0.1999, 0.1956, 0.1916, 0.1892, 0.1889], True),
    "allreduce-enqueue-only": ([0.1178, 0.0964, 0.1707, 0.1824, 0.2423],
                               [0.1986, 0.1925, 0.2104, 0.2133, 0.227],
                               False),
    "enqueue-only-fast-device": ([0.1178, 0.0964, 0.1707, 0.1824, 0.2423],
                                 [0.1936, 0.1889, 0.1916, 0.1892, 0.1956],
                                 False),
}


@pytest.mark.parametrize("case", sorted(_NCCL_CALLS))
def test_nccl_latency_check_tells_completion_from_launch(case):
    """``chip_smoke.py`` [sharded]'s NCCL check pairs each call's latency
    with the device time of the same call and holds the median
    difference to at least 0.  Spans that end after the op completes
    pass; a span that ends once the op is enqueued fails, also against
    the fastest device times measured."""
    import chip_smoke

    latencies, events, covers = _NCCL_CALLS[case]
    assert (chip_smoke.paired_excess(latencies, events) >= 0) is covers
