"""The port's engine phase clock (``llm/engine.py`` ``_PhaseClock``) and
the operator's all-threads capture (``util/profiling.py``
``torch_capture``), on the CPU with a tiny float32 GPT-2.

- ``stats()``'s ``phase_wall_s`` accounts for each ``step()``'s wall
  time, and every forward's logits copy is a ``wait``;
- under an all-threads capture the ``engine.*`` scopes come from the
  ``llm-engine`` thread, each phase inside an ``engine.step``; with no
  profiler running no scope is entered;
- ``torch.autograd.profiler._is_profiler_enabled``, which the clock
  reads, flips with a profiler's start and stop, seen from any thread;
- ``torch_capture`` holds a second thread's operators and scopes.

Every wait is bounded.
"""

import dataclasses
import json
import threading
import time

import pytest
import torch

from ray_tpu_torch.llm.engine import PHASES, EngineConfig, GenerationEngine
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.util.profiling import torch_capture

WAIT = 60.0
CFG = dataclasses.replace(GPT2Config.tiny(), remat=False,
                          dtype=torch.float32)
STEP_PHASES = [p for p in PHASES if p != "idle"]


def _engine(max_batch=4):
    return GenerationEngine(
        model_cfg=CFG, device="cpu", seed=1,
        engine_cfg=EngineConfig(page_size=4, num_pages=128,
                                max_batch=max_batch,
                                prefill_token_budget=64))


def _submit(eng, n, max_tokens):
    return [eng.submit([3, 1, 4, 1, 5, 9][:2 + i % 5], max_tokens=max_tokens)
            for i in range(n)]


def _count_forwards(eng):
    """Wrap the engine's forward to count its calls."""
    calls = []
    real = eng._fwd

    def counted(*args):
        calls.append(args[1].shape)
        return real(*args)

    eng._fwd = counted
    return calls


def _delta(a, b, key):
    return {p: b[key][p] - a[key][p] for p in PHASES}


def test_phases_cover_each_step_and_wait_on_every_forward():
    """Six requests on a batch of four: steps with prefills only, with
    prefills and a decode, decodes alone.  The step phases sum to the
    step's wall time within 5%, CPU time never exceeds wall time, and
    every step that ran a forward spent time waiting on its logits."""
    eng = _engine()
    forwards = _count_forwards(eng)
    seqs = _submit(eng, 6, max_tokens=10)
    kinds = set()
    for _ in range(200):
        if all(s.finished for s in seqs):
            break
        before, n_fwd = eng.stats(), len(forwards)
        t0 = time.perf_counter()
        eng.step()
        wall = time.perf_counter() - t0
        after = eng.stats()
        dw = _delta(before, after, "phase_wall_s")
        dc = _delta(before, after, "phase_cpu_s")
        covered = sum(dw[p] for p in STEP_PHASES)
        assert covered == pytest.approx(wall, rel=0.05), (dw, wall)
        assert all(dc[p] <= dw[p] + 1e-4 for p in STEP_PHASES), (dc, dw)
        ran = forwards[n_fwd:]
        if ran:
            assert dw["wait"] > 0, (ran, dw)
            kinds.update("decode" if shape[1] == 1 else "prefill"
                         for shape in ran)
            if any(shape[1] == 1 for shape in ran):
                assert min(dw["tables"], dw["issue"], dw["sample"]) > 0
            if any(shape[1] > 1 for shape in ran):
                assert dw["admit"] > 0
        else:
            assert dw["wait"] == 0
    assert all(s.finished for s in seqs)
    assert kinds == {"prefill", "decode"}
    st = eng.stats()
    assert set(st["phase_wall_s"]) == set(st["phase_cpu_s"]) == set(PHASES)


def _scopes(path, tid):
    """(name, start, end) of the trace's ``engine.*`` events, after
    checking that every one comes from thread ``tid``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("engine.")]
    assert {e["tid"] for e in found} == {tid}
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in found], events


def test_all_threads_capture_names_each_phase_inside_a_step(tmp_path):
    """An all-threads capture while the engine's own thread serves:
    the ``engine.*`` scopes and the forward's operators are that
    thread's, every phase scope lies inside an ``engine.step``, one
    ``engine.wait`` per forward inside the capture, and idle has no
    scope."""
    eng = _engine()
    real = eng._fwd

    def marked(*args):
        with torch.autograd.profiler.record_function("test.forward"):
            return real(*args)

    eng._fwd = marked
    eng.start()
    try:
        seqs = _submit(eng, 8, max_tokens=100)
        deadline = time.time() + WAIT
        while eng.stats()["steps"] < 3 and time.time() < deadline:
            time.sleep(0.005)
        path, _kernels = torch_capture(0.3, str(tmp_path))
        for seq in seqs:
            for fr in eng.frames(seq, timeout_s=WAIT):
                assert "error" not in fr
        tid = eng._thread.native_id
    finally:
        eng.stop()
    scopes, events = _scopes(path, tid)
    names = {n for n, _a, _b in scopes}
    assert names == {"engine.step"} | {f"engine.{p}" for p in STEP_PHASES}
    steps = sorted((a, b) for n, a, b in scopes if n == "engine.step")
    # scopes still open at the capture's stop (the last step's) end
    # where the profiler cut them
    for name, a, b in scopes:
        if name != "engine.step" and a < steps[-1][0]:
            assert any(sa <= a and b <= sb for sa, sb in steps), name
    # the forward's operators are the engine thread's too
    forwards = [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("name") == "test.forward"]
    assert forwards and all(e["tid"] == tid for e in events
                            if e.get("name") == "test.forward")
    assert any(e.get("tid") == tid and e.get("name") == "aten::linear"
               for e in events)
    # inside each step, one logits copy a forward; the capture's first
    # and last steps may hold only a part of theirs
    whole = 0
    for sa, sb in steps:
        inner = sorted((a, n) for n, a, b in scopes
                       if n != "engine.step" and sa <= a and b <= sb)
        if inner[0][1] != "engine.other" or inner[-1][1] != "engine.other":
            continue
        whole += 1
        n_fwd = sum(sa <= a and b <= sb for a, b in forwards)
        n_wait = sum(n == "engine.wait" for _a, n in inner)
        assert n_wait == n_fwd >= 1
    assert whole >= 1


def test_no_scope_without_a_profiler(monkeypatch):
    """With no profiler the clock enters no ``record_function``; under
    one (here a default capture on the stepping thread) it does."""
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    eng = _engine()
    seqs = _submit(eng, 2, max_tokens=4)
    eng.step()
    eng.step()
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.step()
    assert entered[0] == "engine.step"
    assert set(entered[1:]) <= {f"engine.{p}" for p in STEP_PHASES}
    assert not eng._clock._scopes
    n = len(entered)
    for _ in range(20):
        if all(s.finished for s in seqs):
            break
        eng.step()
    assert len(entered) == n


@pytest.mark.parametrize("all_threads", [False, True])
def test_profiler_flag_flips_with_start_and_stop(all_threads):
    """The clock reads ``torch.autograd.profiler._is_profiler_enabled``
    (a torch-internal name): False before a capture, True inside it,
    read on the capturing thread and on another, False after it."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    def read_elsewhere():
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            torch.autograd.profiler._is_profiler_enabled))
        t.start()
        t.join(timeout=WAIT)
        assert not t.is_alive()
        return seen[0]

    kw = ({"experimental_config": _ExperimentalConfig(
        profile_all_threads=True)} if all_threads else {})
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU], **kw):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert read_elsewhere() is True
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert read_elsewhere() is False


def test_torch_capture_holds_a_second_threads_ops_and_scopes(tmp_path):
    """``torch_capture`` (behind ``rt profile --torch``) records what
    another thread runs: its ``record_function`` scope and the operator
    inside it, under that thread's id."""
    stop = threading.Event()

    def loop():
        x = torch.zeros(8)
        while not stop.is_set():
            with torch.autograd.profiler.record_function("train.step"):
                x.add_(1)
            time.sleep(0.002)

    t = threading.Thread(target=loop, name="train-loop")
    t.start()
    try:
        path, kernels = torch_capture(0.2, str(tmp_path))
    finally:
        stop.set()
        t.join(timeout=WAIT)
    assert not t.is_alive()
    assert kernels == {}                         # no card here
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mine = {e["name"] for e in events
            if e.get("ph") == "X" and e.get("tid") == t.native_id}
    assert {"train.step", "aten::add_"} <= mine
