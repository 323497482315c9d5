"""The port's continuous-batching engine and LLMDeployment.

Three parts, all on the CPU with tiny float32 models:

- the JAX engine and the port's engine on the same converted weights,
  driven step by step with several prompts in flight (greedy and
  sampled with temperature/top-k/top-p and fixed seeds), for GPT-2 and
  the GQA Llama, with a pool large enough and one small enough to force
  recompute preemption: the same tokens, frames and evictions;
- every case of tests/test_llm_engine.py against the port's engine, the
  reference being the port's own non-cached full forward on the same
  weights (held to the JAX model by tests/test_torch_gpt2.py);
- ``LLMDeployment``: streamed frames, the error frame of a bad request
  and pages freed when the consumer closes the stream mid-generation.

Tolerance: tokens and frames equal.  Every wait is bounded
(``frames(timeout_s=...)``) so that a hang fails instead of stalling
the suite.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import engine as jengine
from ray_tpu.llm import sampling as jsampling
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.llm import LLMDeployment, llm_deployment
from ray_tpu_torch.llm import engine as tengine
from ray_tpu_torch.llm.engine import EngineConfig, GenerationEngine, _bucket
from ray_tpu_torch.llm.sampling import SamplingParams
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          llama_params_from_numpy)

WAIT = 60.0          # seconds: the longest gap allowed between frames

CFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), remat=False,
                          dtype=torch.float32)
JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), remat=False,
                           dtype=jnp.float32)


def _jax_params(family):
    if family == "gpt2":
        return JCFG, jgpt2.gpt2_init(JCFG, jax.random.PRNGKey(3))
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), remat=False,
                               dtype=jnp.float32)
    return jcfg, jllama.llama_init(jcfg, jax.random.PRNGKey(4))


def _state_dict(params, family="gpt2"):
    convert = (gpt2_params_from_numpy if family == "gpt2"
               else llama_params_from_numpy)
    return convert(jax.tree_util.tree_map(np.asarray, params))


def _port_cfg(family):
    if family == "gpt2":
        return CFG
    return dataclasses.replace(tllama.LlamaConfig.tiny(), remat=False,
                               dtype=torch.float32)


def _full_model():
    model = tgpt2.GPT2(CFG, device="cpu")
    model.load_state_dict(_state_dict(_jax_params("gpt2")[1]))
    return model


def _reference(model, prompt, steps):
    """Greedy tokens of the non-cached full forward."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(steps):
            logits = model(torch.tensor([toks]))
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _tokens(frames):
    return [f["token"] for f in frames if "token" in f]


@pytest.fixture(scope="module")
def setup():
    """One shared engine (its loop in its own thread) and the full
    model on the same weights."""
    eng = GenerationEngine(
        model_cfg=CFG,
        engine_cfg=EngineConfig(page_size=4, num_pages=64, max_batch=4,
                                prefill_token_budget=64,
                                max_tokens_default=8),
        params=_state_dict(_jax_params("gpt2")[1]), device="cpu").start()
    yield eng, _full_model()
    eng.stop()


# ------------------------------------------------ the JAX engine vs port

_REQUESTS = [
    ([5, 100, 23, 77], {}, None),
    ([9, 4, 300], dict(temperature=0.9, top_k=50), 42),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9], dict(temperature=1.1, top_p=0.8), 7),
    ([8, 8, 8], dict(temperature=0.7, top_k=20, top_p=0.9), 3),
]


def _drive(engine, params_cls, max_tokens=12, max_steps=400):
    """Submit every request at once and step the engine (no thread)
    until all finish; returns each sequence's frames."""
    seqs = [engine.submit(prompt, max_tokens=max_tokens,
                          params=params_cls(**sp), seed=seed)
            for prompt, sp, seed in _REQUESTS]
    for _ in range(max_steps):
        if all(s.finished for s in seqs):
            break
        engine.step()
    assert all(s.finished for s in seqs)
    return [[s.out.get_nowait() for _ in range(s.out.qsize())]
            for s in seqs]


@pytest.mark.parametrize("num_pages", [64, 10])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_engine_matches_jax_engine(family, num_pages):
    """Same weights, same requests, same seeds: the same frames from
    both engines.  10 pages of 4 slots cannot hold four growing
    sequences, so that pool forces recompute preemption."""
    jcfg, params = _jax_params(family)
    ecfg = dict(page_size=4, num_pages=num_pages, max_batch=4,
                prefill_token_budget=64)
    jeng = jengine.GenerationEngine(
        model_cfg=jcfg, engine_cfg=jengine.EngineConfig(**ecfg),
        params=params)
    teng = GenerationEngine(model_cfg=_port_cfg(family),
                            engine_cfg=EngineConfig(**ecfg),
                            params=_state_dict(params, family),
                            device="cpu")
    want = _drive(jeng, jsampling.SamplingParams)
    got = _drive(teng, SamplingParams)
    assert got == want
    assert all(f[-1] == {"done": True, "reason": "length", "n_tokens": 12}
               for f in got)
    tstats, jstats = teng.stats(), jeng.stats()
    assert tstats["evictions"] == jstats["evictions"]
    assert (tstats["evictions"] > 0) == (num_pages == 10)
    assert tstats["kv_pages_used"] == 0 and tstats["step_errors"] == 0


def _llm_series(mod):
    """The engine's and the pool's series: counters and gauges by value,
    histograms by observation count (their values are wall-clock
    gaps)."""
    out = {}
    for snap in mod.registry().snapshot():
        if not snap["name"].startswith(("rt_llm_", "rt_serve_ttft")):
            continue
        for s in snap["series"]:
            key = (snap["name"], tuple(sorted(s["tags"].items())))
            out[key] = s["hist"]["count"] if "hist" in s else s["value"]
    return out


@pytest.mark.parametrize("num_pages", [64, 10])
def test_engine_telemetry_matches_jax_engine(num_pages):
    """The JAX engine and the port's on the same weights and requests,
    each request carrying a request id: equal token, prefill and
    eviction counters, TPOT and TTFT-phase observation counts, batch,
    waiting and KV-page gauges; the same span names for each request id;
    the same programs registered with xprof."""
    from ray_tpu.util import metrics as jmetrics
    from ray_tpu.util import spans as jspans
    from ray_tpu.util import xprof as jxprof
    from ray_tpu_torch.util import metrics, spans, xprof

    for mod in (metrics, jmetrics):
        mod.registry().clear()
    for mod in (spans, jspans):
        mod.reset()
    xprof._reset_local()
    jxprof._reset_local()
    jcfg, params = _jax_params("gpt2")
    ecfg = dict(page_size=4, num_pages=num_pages, max_batch=4,
                prefill_token_budget=64)
    engines = [
        (GenerationEngine(model_cfg=CFG, engine_cfg=EngineConfig(**ecfg),
                          params=_state_dict(params), device="cpu"),
         SamplingParams),
        (jengine.GenerationEngine(model_cfg=jcfg,
                                  engine_cfg=jengine.EngineConfig(**ecfg),
                                  params=params),
         jsampling.SamplingParams)]
    for eng, params_cls in engines:
        seqs = [eng.submit(prompt, max_tokens=12, params=params_cls(**sp),
                           seed=seed, request_id=f"r{i}")
                for i, (prompt, sp, seed) in enumerate(_REQUESTS)]
        for _ in range(400):
            if all(q.finished for q in seqs):
                break
            eng.step()
        assert all(q.finished for q in seqs)
    got, want = _llm_series(metrics), _llm_series(jmetrics)
    assert got == want
    n = len(_REQUESTS)
    assert got[("rt_llm_tokens_total", ())] == 12 * n
    assert got[("rt_llm_tpot_seconds", ())] == 11 * n
    assert got[("rt_llm_kv_pages_used", ())] == 0
    assert got[("rt_llm_kv_pages_total", ())] == num_pages
    assert got[("rt_serve_ttft_phase_seconds", (("phase", "prefill"),))] == n
    assert (("rt_llm_evictions_total", ()) in got) == (num_pages == 10)

    def names(mod):
        by_rid = {}
        for sp in mod.snapshot():
            rid = (sp.get("tags") or {}).get("request_id")
            if rid:
                by_rid.setdefault(rid, set()).add(sp["name"])
        return by_rid

    assert names(spans) == names(jspans) == {
        f"r{i}": {"engine_waiting", "prefill", "decode"} for i in range(n)}
    assert set(xprof.local_programs()) == set(jxprof.local_programs())
    assert "llm_decode" in xprof.local_programs()
    assert xprof.local_programs()["llm_decode"]["flops"] > 0


# ------------------------------- tests/test_llm_engine.py, on the port


def test_engine_smoke_token_identical(setup):
    """Prefill + a few decode steps through the engine produce exactly
    the non-cached full forward's greedy tokens."""
    eng, model = setup
    prompt = [5, 100, 23, 77]
    assert eng.generate(prompt, max_tokens=6, timeout_s=WAIT) == \
        _reference(model, prompt, 6)


def test_mid_flight_admission_no_batch_barrier(setup):
    """A sequence submitted while another is mid-generation runs to
    completion before the first finishes."""
    eng, model = setup
    a = eng.submit([9, 4, 300], max_tokens=40)
    it_a = eng.frames(a, timeout_s=WAIT)
    first_a = [next(it_a) for _ in range(3)]     # a is mid-flight
    assert all("token" in f for f in first_a)
    b = eng.submit([8, 8, 8], max_tokens=3)
    b_frames = list(eng.frames(b, timeout_s=WAIT))
    assert not a.finished
    assert _tokens(b_frames) == _reference(model, [8, 8, 8], 3)
    assert b_frames[-1] == {"done": True, "reason": "length",
                            "n_tokens": 3}
    rest = list(it_a)
    assert rest[-1].get("done")
    assert _tokens(first_a + rest) == _reference(model, [9, 4, 300], 40)


def test_cancel_mid_stream_frees_kv_pages_to_baseline(setup):
    eng, _ = setup
    assert eng.pool.used == 0
    seq = eng.submit([1, 2, 3], max_tokens=500)
    it = eng.frames(seq, timeout_s=WAIT)
    next(it)
    next(it)
    assert eng.pool.used > 0              # pages held mid-stream
    eng.cancel(seq.sid)
    frames = list(it)
    assert frames[-1] == {"done": True, "reason": "cancelled",
                          "n_tokens": seq.generated}
    deadline = time.time() + 10
    while time.time() < deadline and eng.pool.used != 0:
        time.sleep(0.05)
    assert eng.pool.used == 0
    assert eng.stats()["running"] == 0


def test_eviction_recompute_preserves_greedy_output():
    """A pool too small for two full sequences forces recompute
    preemption; both still produce exactly the reference tokens and all
    pages come back."""
    model = _full_model()
    eng = GenerationEngine(
        model_cfg=CFG,
        engine_cfg=EngineConfig(page_size=4, num_pages=10, max_batch=4),
        params=model.state_dict(), device="cpu").start()
    try:
        a = eng.submit([5, 100, 23, 77], max_tokens=20)
        b = eng.submit([9, 4, 300], max_tokens=20)
        toks_a = _tokens(eng.frames(a, timeout_s=WAIT))
        toks_b = _tokens(eng.frames(b, timeout_s=WAIT))
        assert toks_a == _reference(model, [5, 100, 23, 77], 20)
        assert toks_b == _reference(model, [9, 4, 300], 20)
        st = eng.stats()
        assert st["evictions"] > 0
        assert st["kv_pages_used"] == 0
    finally:
        eng.stop()


def test_seeded_sampling_reproducible(setup):
    eng, _ = setup
    p = SamplingParams(temperature=0.9, top_k=50)
    one = eng.generate([10, 20, 30], max_tokens=6, params=p, seed=42,
                       timeout_s=WAIT)
    two = eng.generate([10, 20, 30], max_tokens=6, params=p, seed=42,
                       timeout_s=WAIT)
    assert one == two
    assert len(one) == 6


def test_submit_rejects_bad_requests(setup):
    eng, _ = setup
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit([CFG.vocab_size + 5])
    with pytest.raises(ValueError):
        eng.submit(list(range(eng.max_context)))   # no room to decode
    with pytest.raises(ValueError):
        eng.submit([1], params=SamplingParams(top_p=2.0))


def test_step_failure_poisons_inflight_but_engine_survives(setup):
    """A failing step error-retires the in-flight sequences, the loop
    keeps running, and the next request works."""
    eng, model = setup
    real_fwd = eng._fwd

    def boom(*a, **k):
        raise RuntimeError("injected step failure")

    eng._fwd = boom
    try:
        frames = list(eng.frames(eng.submit([1, 2, 3], max_tokens=5),
                                 timeout_s=WAIT))
        assert "error" in frames[-1]
        assert "injected step failure" in frames[-1]["error"]
    finally:
        eng._fwd = real_fwd
    st = eng.stats()
    assert st["step_errors"] >= 1
    assert st["kv_pages_used"] == 0
    assert eng.generate([5, 100, 23, 77], max_tokens=4, timeout_s=WAIT) \
        == _reference(model, [5, 100, 23, 77], 4)


def test_prefill_bucketing():
    for n in (1, 8, 9, 100):
        assert _bucket(n) == jengine._bucket(n)
    assert [_bucket(n) for n in (1, 8, 9, 100)] == [8, 8, 16, 128]


def test_length_cap_at_max_context():
    """A generation that would outrun the context window retires with
    reason "length" at the cap: 16 - 4 + 1 generated."""
    eng = GenerationEngine(
        model_cfg=CFG,
        engine_cfg=EngineConfig(page_size=4, num_pages=16, max_batch=2,
                                max_context=16),
        params=_full_model().state_dict(), device="cpu").start()
    try:
        frames = list(eng.frames(eng.submit([1, 2, 3, 4], max_tokens=1000),
                                 timeout_s=WAIT))
        assert frames[-1]["reason"] == "length"
        assert frames[-1]["n_tokens"] == 13
        assert eng.stats()["kv_pages_used"] == 0
    finally:
        eng.stop()


def test_engine_step_records_no_autograd_graph():
    """The forward runs under inference mode in the engine's own thread,
    though the parameters require grad."""
    eng = GenerationEngine(model_cfg=CFG, params=_full_model().state_dict(),
                           device="cpu")
    assert all(p.requires_grad for p in eng._params.parameters())
    seen = []
    real_fwd = eng._fwd

    def spy(*args):
        logits, k, v = real_fwd(*args)
        seen.append((torch.is_inference_mode_enabled(), logits.grad_fn))
        return logits, k, v

    eng._fwd = spy
    eng.start()
    try:
        assert len(eng.generate([1, 2], max_tokens=3, timeout_s=WAIT)) == 3
    finally:
        eng.stop()
    assert seen and all(mode and fn is None for mode, fn in seen)


# -------------------------------------------------------- LLMDeployment


@pytest.fixture(scope="module")
def deployment():
    dep = LLMDeployment(model="gpt2", model_cfg=CFG,
                        engine_cfg=EngineConfig(page_size=8, num_pages=32,
                                                max_batch=4,
                                                max_tokens_default=8),
                        seed=0, device="cpu")
    model = tgpt2.gpt2_init(CFG, torch.Generator().manual_seed(0), "cpu")
    yield dep, model
    dep.stop()


def test_deployment_streams_frames(deployment):
    dep, model = deployment
    frames = list(dep({"prompt": [5, 9, 101], "max_tokens": 6}))
    assert _tokens(frames) == _reference(model, [5, 9, 101], 6)
    assert [f["index"] for f in frames if "token" in f] == list(range(6))
    assert frames[-1] == {"done": True, "reason": "length", "n_tokens": 6}
    # The warmup request at init stays out of the TTFT accounting.
    assert dep.stats()["ttft_requests"] == 1


def test_deployment_takes_the_request_id_from_tracing(deployment):
    """A request made inside ``tracing.request_scope`` hands its id to
    the engine: its lifecycle spans carry it."""
    from ray_tpu_torch.util import spans, tracing

    dep, _ = deployment
    spans.reset()
    with tracing.request_scope("req-7"):
        frames = list(dep({"prompt": [5, 9, 101], "max_tokens": 4}))
    assert frames[-1]["done"]
    names = {sp["name"] for sp in spans.snapshot()
             if (sp.get("tags") or {}).get("request_id") == "req-7"}
    assert names == {"engine_waiting", "prefill", "decode"}


def test_deployment_bad_request_yields_error_frame(deployment):
    dep, _ = deployment
    for payload in ({"prompt": []}, {"no_prompt": True},
                    {"prompt": [1], "top_p": 5.0}, None):
        frames = list(dep(payload))
        assert len(frames) == 1 and "bad request" in frames[0]["error"]


def test_deployment_close_mid_stream_frees_pages(deployment):
    dep, _ = deployment
    base = dep.stats()
    assert base["kv_pages_used"] == 0
    it = dep({"prompt": [7, 8, 9], "max_tokens": 2000})
    assert "token" in next(it)
    assert "token" in next(it)
    it.close()                              # consumer gone
    deadline = time.time() + WAIT
    while time.time() < deadline:
        st = dep.stats()
        if st["kv_pages_used"] == 0 and st["running"] == 0:
            break
        time.sleep(0.05)
    assert st["kv_pages_used"] == 0 and st["running"] == 0, st
    assert st["tokens_generated"] - base["tokens_generated"] < 500, st


def test_deployment_reports_init_failure():
    dep = LLMDeployment(model_cfg=object(), device="cpu")
    with pytest.raises(RuntimeError, match="failed to initialize"):
        next(dep({"prompt": [1]}))


def test_llm_deployment_waits_for_the_serve_plane():
    """The serve plane has come: ``llm_deployment`` builds a serve
    application of ``LLMDeployment`` whose replicas lease a GPU
    (``tests/test_torch_llm_serve.py`` serves one)."""
    from ray_tpu_torch import serve

    app = llm_deployment(name="llm")
    assert isinstance(app, serve.Application)
    assert app.deployment.func_or_class is LLMDeployment
    assert app.deployment.ray_actor_options == {"num_cpus": 1,
                                                "num_gpus": 1}
    assert tengine.EngineConfig() == EngineConfig()
