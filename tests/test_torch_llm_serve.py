"""``llm_deployment`` behind the port's serve plane, against the JAX
engine.

A tiny GPT-2 (2 layers, d_model 128, vocab 512, float32) is served by
``ray_tpu_torch.serve.run(llm_deployment(..., num_gpus=0,
device="cpu"))`` on one port cluster for the whole file, with the
stdlib HTTP proxy in front.  The reference is the JAX package's
``GenerationEngine`` in this process, on the same weights: the
replica's seed-0 ``gpt2_init`` converted with
``models.convert.gpt2_params_to_numpy``.  (The JAX serve plane with an
LLM replica, ``tests/test_llm_serve.py``, is marked slow and is not the
reference.)

Greedy frames over the handle and over HTTP must equal the JAX
engine's, exactly.  Also: a bad request's error frame (against JAX's
``LLMDeployment`` on the same payload), a client that disconnects
mid-stream leaving every KV page free, the engine's series in
``util.telemetry.cluster_summary`` and ``render_text``, the programs in
``util.xprof.cluster_report``, and ``max_ongoing_requests`` defaulting
to ``max_batch``.
"""

import dataclasses
import json
import socket
import time

import jax
import jax.numpy as jnp
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.llm import engine as jengine
from ray_tpu.llm import sampling as jsampling
from ray_tpu.llm import serving as jserving
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import serve
from ray_tpu_torch.llm import EngineConfig, llm_deployment
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_params_to_numpy

CFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), remat=False,
                          dtype=torch.float32)
JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), remat=False,
                           dtype=jnp.float32)
ENGINE = dict(page_size=4, num_pages=64, max_batch=4,
              prefill_token_budget=64)
PROMPTS = [[5, 100, 23, 77], [9, 4, 300], [1, 2, 3, 4, 5, 6, 7, 8, 9],
           [511, 0, 256, 17, 42]]
MAX_TOKENS = 12
WAIT = 60.0


def _until(cond, timeout: float, what: str, every: float = 0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(every)
    raise TimeoutError(what)


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX engine's frames for every prompt, on the replica's
    weights (seed 0, ``gpt2_init`` on the CPU)."""
    model = tgpt2.gpt2_init(CFG, torch.Generator().manual_seed(0), "cpu")
    params = jax.tree_util.tree_map(
        jnp.asarray, gpt2_params_to_numpy(model.state_dict()))
    eng = jengine.GenerationEngine(
        model_cfg=JCFG, engine_cfg=jengine.EngineConfig(**ENGINE),
        params=params)
    seqs = [eng.submit(p, max_tokens=MAX_TOKENS,
                       params=jsampling.SamplingParams()) for p in PROMPTS]
    for _ in range(400):
        if all(s.finished for s in seqs):
            break
        eng.step()
    assert all(s.finished for s in seqs)
    return [[s.out.get_nowait() for _ in range(s.out.qsize())]
            for s in seqs]


@pytest.fixture(scope="module")
def served():
    """One port cluster; the LLM deployment on the CPU behind the
    handle and the HTTP proxy."""
    rt.init(mode="cluster", num_cpus=4,
            config={"metrics_report_period_s": 1.0})
    try:
        handle = serve.run(llm_deployment(
            name="llm", model_cfg=CFG, engine_cfg=EngineConfig(**ENGINE),
            num_gpus=0, device="cpu"), route_prefix="/llm")
        port = serve.start_http_proxy()
        _until(lambda: _post(port, {"prompt": [1], "max_tokens": 1})[0]
               == 200, WAIT, "the route never reached the proxy", 0.3)
        yield handle, port
    finally:
        serve.shutdown()
        rt.shutdown()


def _post(port, payload, close_after: int = 0, path: str = "/llm"):
    """POST a JSON payload; (status, frames).  ``close_after``: close
    the socket after that many frames."""
    body = json.dumps(payload).encode()
    req = (f"POST {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
           f"Content-Type: application/json\r\n"
           f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT) as s:
        s.sendall(req)
        f = s.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        while (line := f.readline().strip()):
            k, _, v = line.decode().partition(":")
            headers[k.lower()] = v.strip()
        if "chunked" not in headers.get("transfer-encoding", ""):
            return status, json.loads(f.read(int(headers["content-length"])))
        frames = []
        while (size := int(f.readline().strip(), 16)):
            frames += [json.loads(ln) for ln in
                       f.read(size).decode().splitlines()]
            f.readline()
            if close_after and len(frames) >= close_after:
                break
    return status, frames


def _stats(handle):
    return rt.get(handle.method("stats").remote(), timeout=WAIT)


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_handle_frames_equal_jax_engine(served, jax_frames, i):
    handle, _ = served
    got = list(handle.stream({"prompt": PROMPTS[i],
                              "max_tokens": MAX_TOKENS}))
    assert got == jax_frames[i]
    assert got[-1] == {"done": True, "reason": "length",
                       "n_tokens": MAX_TOKENS}


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_http_frames_equal_jax_engine(served, jax_frames, i):
    _, port = served
    status, frames = _post(port, {"prompt": PROMPTS[i],
                                  "max_tokens": MAX_TOKENS})
    assert (status, frames) == (200, jax_frames[i])


def test_bad_request_yields_the_error_frame(served):
    """The same payloads through JAX's ``LLMDeployment`` in process, the
    port's handle and its HTTP proxy: the same single error frame."""
    handle, port = served
    jdep = jserving.LLMDeployment(model_cfg=JCFG,
                                  engine_cfg=jengine.EngineConfig(**ENGINE))
    for payload in ({"prompt": "ab"}, {"max_tokens": 3},
                    {"prompt": [1], "temperature": "hot"}):
        want = list(jdep(payload))
        assert len(want) == 1 and want[0]["error"].startswith(
            "bad request: ")
        assert list(handle.stream(payload)) == want
        assert _post(port, payload) == (200, want)


def test_disconnect_frees_the_pages(served):
    """A client that closes its socket after 4 token frames: the stream
    ends on the replica and every KV page is free again."""
    handle, port = served
    status, frames = _post(port, {"prompt": PROMPTS[2], "max_tokens": 100},
                           close_after=4)
    assert status == 200 and [f["index"] for f in frames] == [0, 1, 2, 3]
    st = _until(lambda: (s := _stats(handle))["kv_pages_used"] == 0
                and s["running"] == 0 and s, WAIT,
                "pages still held after the client left")
    assert st["step_errors"] == 0
    assert _post(port, {"prompt": PROMPTS[0], "max_tokens": 2})[0] == 200


def test_llm_metrics_reach_cluster_summary(served):
    """The replica's engine series reach ``cluster_summary`` through the
    controller: the tokens of one more request, one engine, its pool;
    ``render_text`` shows the LLM and serve sections and
    ``cluster_report`` the engine's programs."""
    from ray_tpu_torch.util import telemetry, xprof

    handle, port = served

    def settled():
        before = telemetry.cluster_summary()["llm"]["tokens"]
        time.sleep(2.5)      # two report periods without a change
        return before if before == telemetry.cluster_summary()[
            "llm"]["tokens"] else None

    before = _until(settled, WAIT, "the token count never settled", 0)
    assert _post(port, {"prompt": PROMPTS[1], "max_tokens": 7})[0] == 200
    summary = _until(
        lambda: (s := telemetry.cluster_summary())["llm"]["tokens"]
        == before + 7 and s, WAIT, "the tokens never reached the summary")
    llm = summary["llm"]
    assert (llm["engines"], llm["kv_pages_total"]) == (1, ENGINE[
        "num_pages"])
    assert summary["serve"]["requests"]["llm"]["count"] >= 1
    assert summary["serve"]["status_classes"]["llm"]["2xx"] >= 1
    text = telemetry.render_text(summary)
    assert "LLM engine (continuous batching):" in text
    assert "Serve ingress:" in text
    report = xprof.cluster_report(summary=summary)
    names = set(report["programs"])
    assert "llm_decode" in names
    assert any(n.startswith("llm_prefill[") for n in names)


def test_control_plane_never_imports_torch(served):
    """The deployment's init arguments hold torch objects (the config's
    dtype).  They reach the replica packed into bytes, so neither the
    runtime's controller, its node agent nor the serve controller's
    worker loads torch; the replica does."""
    from ray_tpu_torch.core import runtime as runtime_mod
    from ray_tpu_torch.util import state

    handle, _ = served

    def has_torch(pid):
        with open(f"/proc/{pid}/maps") as f:
            return "libtorch" in f.read()

    runtime = runtime_mod.get_runtime()
    control = [p.pid for p in runtime._procs]       # controller, agent
    ctl = rt.get_actor(serve.CONTROLLER_NAME)
    replicas = rt.get(ctl.get_replicas.remote("llm"))
    ids = {ctl._actor_id.hex(): "serve controller"}
    ids.update({r._actor_id.hex(): "replica" for r in replicas})
    workers = {}
    for node in state.list_nodes():
        listed = state._agent_call(node["agent_addr"], "list_workers")
        workers.update({ids[w["actor_id"]]: w["pid"]
                        for w in listed["workers"]
                        if w.get("actor_id") in ids})
    assert len(control) == 2 and set(workers) == {"serve controller",
                                                  "replica"}
    assert [has_torch(pid) for pid in control] == [False, False]
    assert not has_torch(workers["serve controller"])
    assert has_torch(workers["replica"])


def test_max_ongoing_requests_defaults_to_max_batch():
    """The application ``llm_deployment`` builds, against the JAX
    package's: the same deployment fields, with ``num_gpus`` in the
    replica's lease where the JAX replica leases CPUs only."""
    from ray_tpu import serve as jserve

    for kw in ({}, {"engine_cfg_kw": {"max_batch": 3},
                    "max_ongoing_requests": 5}):
        ecfg_kw = kw.get("engine_cfg_kw", {})
        auto = dict(min_replicas=1, max_replicas=2)
        app = llm_deployment(
            name="x", engine_cfg=EngineConfig(**ecfg_kw),
            max_ongoing_requests=kw.get("max_ongoing_requests"),
            autoscaling=serve.AutoscalingConfig(**auto))
        japp = jserving.llm_deployment(
            name="x", engine_cfg=jengine.EngineConfig(**ecfg_kw),
            max_ongoing_requests=kw.get("max_ongoing_requests"),
            autoscaling=jserve.AutoscalingConfig(**auto))
        d, jd = app.deployment, japp.deployment
        assert d.max_ongoing_requests == jd.max_ongoing_requests == kw.get(
            "max_ongoing_requests", EngineConfig(**ecfg_kw).max_batch)
        assert (d.name, d.num_replicas, d.route_prefix) == (
            jd.name, jd.num_replicas, jd.route_prefix)
        assert dataclasses.asdict(d.autoscaling_config) == \
            dataclasses.asdict(jd.autoscaling_config)
        assert jd.ray_actor_options == {"num_cpus": 1}
        assert d.ray_actor_options == {"num_cpus": 1, "num_gpus": 1}
        assert sorted(app.init_kwargs) == sorted(
            [*japp.init_kwargs, "device"])
        assert app.init_kwargs["device"] is None
