"""Continuous-batching generation engine (Orca-style iteration-level
scheduling over the paged KV cache): counterpart of
``ray_tpu/llm/engine.py``, with the same scheduling.

One engine hosts one model replica and runs a step loop with NO batch
barriers: every step it (1) admits waiting sequences (each admission is
a prefill forward, padded to a power-of-two bucket, that fills the
sequence's KV pages and samples its first token), packing admissions
under a per-step token budget so a long prompt cannot starve running
decodes, (2) runs ONE batched decode forward over every running
sequence, padded to ``max_batch`` rows, and (3) retires finished
sequences and frees their pages immediately.  A request submitted while
others are mid-generation starts decoding on the very next step.

Memory pressure is handled vLLM-style by recompute preemption: when a
running sequence needs a page and the pool is empty, the most recently
admitted OTHER sequence is evicted (pages freed, tokens kept) and
re-prefills (prompt + everything it already generated) when pages free
up, so streamed tokens are never re-emitted and greedy output is
unchanged.

Sampling happens on the host from the last valid position's logits
(``sampling.py``, numpy), as in JAX: one copy of the logits to the host
per forward.  The forward is a plain call of ``self._fwd`` (tests swap
it to inject faults) under ``torch.inference_mode()``, entered by
``step()`` in whatever thread runs it, the ``llm-engine`` thread
included: grad mode is thread-local.  The pool is written in place.

Telemetry, as in the JAX engine: the counters ``rt_llm_tokens_total``,
``rt_llm_prefill_tokens_total`` and ``rt_llm_evictions_total``, the
gauges ``rt_llm_batch_size`` and ``rt_llm_waiting``, the
``rt_llm_tpot_seconds`` histogram and the TTFT-phase histogram
(``engine_waiting``, ``prefill``; warmup sequences excluded), in the
process-local registry (``util/metrics``); a request that carries a
request id gets ``engine_waiting``, ``prefill`` and ``decode`` spans in
the span ring (``util/spans``).  The first forward of each (kind,
shape) runs under ``xprof.harvest_step`` and registers the program
``llm_prefill[T]`` or ``llm_decode`` with xprof.

Beyond the JAX engine, a phase clock splits the engine thread's time
into ``PHASES`` (``_PhaseClock``), read through ``stats()`` as
``phase_wall_s`` and ``phase_cpu_s``:

- ``admit``: cancellations and admissions, each prefill's arrays,
  forward launch and first-token sample, all but its logits copy;
- ``tables``: the decode step's page allocation and its token,
  position and page-table arrays, copied to the device;
- ``issue``: the decode forward's launch (Python issuing its kernels);
- ``wait``: every copy of logits to the host, which waits for the
  device to finish the forward and then to take the interpreter lock
  back;
- ``sample``: sampling the decode rows, their frames and retirements;
- ``other``: the rest of ``step()``;
- ``idle``: from one step's end to the next's start on the same thread
  (``_loop`` waiting for work).

A host phase's wall time less its CPU time is time the thread spent
off the CPU: waiting for the interpreter lock while another thread
held it, or blocked in a call.
While a torch profiler runs, each step is also an ``engine.step``
scope on the profiler's clock with one ``engine.<phase>`` scope per
phase inside it (``idle`` has none), so that a capture of all threads
names the phase under each of the device's idle gaps.  These stay out
of the span ring: a few a step would push out the request spans.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.gpt2 import GPT2, GPT2Config, gpt2_init
from ..models.llama import Llama, LlamaConfig, llama_init
from .kv_cache import PagePool, init_cache, pages_for
from .sampling import SamplingParams, sample


@dataclass(frozen=True)
class EngineConfig:
    page_size: int = 16
    num_pages: int = 512
    max_batch: int = 8              # concurrent decoding sequences
    # Per-step token budget shared by prefill admissions (padded prompt
    # lengths) and the decode batch (1 token per running sequence).
    prefill_token_budget: int = 1024
    max_context: Optional[int] = None   # default: model max_seq
    eos_id: Optional[int] = None
    max_tokens_default: int = 64
    # Max gap between output frames before a consumer gives up on a
    # sequence (covers long recompute-preemption parks under KV
    # pressure; size it to worst-case pool contention).
    stream_idle_timeout_s: float = 300.0


def _bucket(n: int, floor: int = 8) -> int:
    """Pad prefill lengths to power-of-two buckets: a bounded number of
    prefill shapes instead of one per prompt length."""
    b = floor
    while b < n:
        b *= 2
    return b


PHASES = ("admit", "tables", "issue", "wait", "sample", "other", "idle")


class _PhaseClock:
    """The engine thread's time split into ``PHASES``: ``switch(p)``
    reads the wall and thread CPU clocks once, adds the time since the
    last switch to the running phase's totals (seconds, so that
    ``stats()`` only copies them) and makes ``p`` the running phase.

    While a profiler runs (``torch.autograd.profiler._is_profiler_enabled``,
    set for the whole process, unlike the thread-local
    ``torch._C._autograd._profiler_enabled()``), a switch also ends the
    running phase's scope and enters ``engine.<p>``, inside an
    ``engine.step`` scope entered first.  A switch to ``idle``, or any
    switch once the profiler has stopped, ends every scope, so no scope
    outlives the step it belongs to: torch crashes where a scope begun
    under one profiler ends under the next.  With no profiler the
    scopes cost one attribute read a switch."""

    def __init__(self):
        self.wall = dict.fromkeys(PHASES, 0.0)
        self.cpu = dict.fromkeys(PHASES, 0.0)
        self.phase = "idle"
        self._thread: Optional[int] = None
        self._t = self._c = 0
        self._scopes: List[Any] = []        # outermost first

    def begin_step(self) -> None:
        """Close ``idle`` and open ``other``.  A step on another thread
        than the last starts the clocks afresh (CPU time is per
        thread), leaving the gap uncounted."""
        tid = threading.get_ident()
        if tid != self._thread:
            self._thread = tid
            self._t, self._c = time.perf_counter_ns(), time.thread_time_ns()
        self.switch("other")

    def switch(self, phase: str) -> str:
        """Make ``phase`` the running phase; returns the one it ends."""
        prev = self.phase
        if phase == prev:
            return prev
        t, c = time.perf_counter_ns(), time.thread_time_ns()
        self.wall[prev] += (t - self._t) * 1e-9
        self.cpu[prev] += (c - self._c) * 1e-9
        self._t, self._c, self.phase = t, c, phase
        if self._scopes or torch.autograd.profiler._is_profiler_enabled:
            self._rescope(phase)
        return prev

    def _rescope(self, phase: str) -> None:
        if len(self._scopes) > 1:
            self._scopes.pop().__exit__(None, None, None)
        if phase == "idle" \
                or not torch.autograd.profiler._is_profiler_enabled:
            while self._scopes:
                self._scopes.pop().__exit__(None, None, None)
            return
        for name in ([] if self._scopes else ["engine.step"]) \
                + [f"engine.{phase}"]:
            scope = torch.autograd.profiler.record_function(name)
            scope.__enter__()
            self._scopes.append(scope)


class _Sequence:
    """One in-flight generation request (engine-internal)."""

    __slots__ = ("sid", "tokens", "prompt_len", "max_tokens", "params",
                 "rng", "out", "pages", "n_cached", "generated",
                 "finished", "cancelled", "submitted_ts",
                 "request_id", "first_token_ts", "last_token_ts",
                 "warmup")

    def __init__(self, sid: int, prompt: List[int], max_tokens: int,
                 params: SamplingParams, seed: int,
                 request_id: Optional[str] = None,
                 warmup: bool = False):
        self.sid = sid
        self.tokens = list(prompt)      # prompt + generated so far
        self.prompt_len = len(prompt)
        self.max_tokens = max_tokens
        self.params = params
        self.rng = np.random.default_rng(seed)
        self.out: "queue.Queue" = queue.Queue()
        self.pages: List[int] = []
        self.n_cached = 0               # tokens written into KV pages
        self.generated = 0
        self.finished = False
        self.cancelled = False
        self.submitted_ts = time.time()
        self.request_id = request_id
        self.first_token_ts: Optional[float] = None
        self.last_token_ts: Optional[float] = None
        # Warmup sequences stay out of the TTFT/TPOT accounting.
        self.warmup = warmup


class GenerationEngine:
    """Continuous-batching engine for one GPT-2 / Llama replica.

    ``params`` is a port state_dict (``models/convert.py`` gives one
    from a JAX param tree) or None: weights from ``gpt2_init`` /
    ``llama_init`` with a generator on ``device`` seeded with ``seed``.
    ``device=None`` means the CUDA card (or a raise without one)."""

    def __init__(self, model: str = "gpt2", model_cfg: Any = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 params: Any = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = engine_cfg or EngineConfig()
        if model_cfg is None:
            model_cfg = (GPT2Config.tiny() if model == "gpt2"
                         else LlamaConfig.tiny())
        self.model_cfg = model_cfg
        if isinstance(model_cfg, GPT2Config):
            build, init, n_kv = GPT2, gpt2_init, model_cfg.n_head
        elif isinstance(model_cfg, LlamaConfig):
            build, init, n_kv = Llama, llama_init, model_cfg.n_kv_head
        else:
            raise TypeError(f"unsupported model_cfg {type(model_cfg)}")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self._params = init(model_cfg, gen, self.device)
        else:
            self._params = build(model_cfg, self.device)
            self._params.load_state_dict(params)
        head_dim = model_cfg.d_model // model_cfg.n_head
        self.max_context = min(
            self.cfg.max_context or model_cfg.max_seq, model_cfg.max_seq,
            self.cfg.num_pages * self.cfg.page_size)
        self._pages_per_seq = pages_for(self.max_context,
                                        self.cfg.page_size)
        self.pool = PagePool(self.cfg.num_pages, self.cfg.page_size)
        self._kv = init_cache(model_cfg.n_layer, self.cfg.num_pages,
                              self.cfg.page_size, n_kv, head_dim,
                              model_cfg.dtype, self.device)

        def fwd(model, tokens, k_pages, v_pages, page_table, positions):
            logits, new = model(
                tokens,
                kv_cache={"k_pages": k_pages, "v_pages": v_pages,
                          "page_table": page_table},
                positions=positions)
            return logits, new["k_pages"], new["v_pages"]

        # One forward serves prefill ([1, bucket]) and decode
        # ([max_batch, 1]).
        self._fwd = fwd

        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._waiting: "deque[_Sequence]" = deque()
        self._running: List[_Sequence] = []
        self._cancelled: set = set()
        self._seqs: Dict[int, _Sequence] = {}
        self._ids = itertools.count(1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[str] = None
        self._step_errors = 0
        self._steps = 0
        self._last_batch = 0
        self._tokens_total = 0
        self._prefill_tokens_total = 0
        self._evictions = 0
        self._seq_seed = seed
        # TTFT phase accounting (waiting queue + prefill) and TPOT
        # (inter-token gap) sums, read through stats().
        self._waiting_s_total = 0.0
        self._prefill_s_total = 0.0
        self._ttft_requests = 0
        self._tpot_s_total = 0.0
        self._tpot_count = 0
        self._clock = _PhaseClock()
        # (kind, token shape) -> the _fwd its program was registered
        # for: a swapped _fwd (fault injection) registers anew.
        self._programs: Dict[Any, Any] = {}
        # Metric handles cached once: the registry dedupes by name, but
        # re-constructing a Metric per emitted token would pay name
        # validation and the registry lock on every token.
        self._metrics = {}
        try:
            from ..util.metrics import (Counter, Gauge, Histogram,
                                        ttft_phase_histogram)

            self._metrics = {
                "tokens": Counter("rt_llm_tokens_total",
                                  "Tokens generated."),
                "prefill": Counter(
                    "rt_llm_prefill_tokens_total",
                    "Prompt tokens prefilled into the KV cache."),
                "evictions": Counter(
                    "rt_llm_evictions_total",
                    "Sequences evicted for KV-memory pressure "
                    "(recompute preemption)."),
                "batch": Gauge(
                    "rt_llm_batch_size",
                    "Sequences in the decode batch this engine step."),
                "waiting": Gauge("rt_llm_waiting",
                                 "Sequences queued for admission."),
                "tpot": Histogram(
                    "rt_llm_tpot_seconds",
                    "Inter-token (time-per-output-token) gap."),
                "ttft_phase": ttft_phase_histogram(),
            }
        except Exception:
            pass

    # ----------------------------------------------------------- API
    def start(self) -> "GenerationEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="llm-engine")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def submit(self, prompt: List[int],
               max_tokens: Optional[int] = None,
               params: Optional[SamplingParams] = None,
               seed: Optional[int] = None,
               request_id: Optional[str] = None,
               _warmup: bool = False) -> _Sequence:
        """Queue one generation request; returns its sequence handle
        (stream its frames with ``frames()``)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.model_cfg.vocab_size for t in prompt):
            raise ValueError("prompt token out of vocab range")
        if len(prompt) + 1 > self.max_context:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the engine's "
                f"max context {self.max_context}")
        if params is not None:
            params.validate()
        sid = next(self._ids)
        seq = _Sequence(sid, prompt,
                        max_tokens or self.cfg.max_tokens_default,
                        params or SamplingParams(),
                        self._seq_seed + sid if seed is None else seed,
                        request_id=request_id, warmup=_warmup)
        with self._wake:
            self._seqs[sid] = seq
            self._waiting.append(seq)
            self._wake.notify_all()
        return seq

    def cancel(self, sid: int) -> None:
        """Evict a sequence (client disconnect): frees its KV pages and
        removes it from the running batch on the next step."""
        with self._wake:
            if sid in self._seqs and not self._seqs[sid].finished:
                self._cancelled.add(sid)
                self._wake.notify_all()

    def frames(self, seq: _Sequence,
               timeout_s: Optional[float] = None):
        """Yield a sequence's output frames until its terminal frame
        ({"done": ...} or {"error": ...}); ``timeout_s`` bounds the gap
        between frames (default: the engine config's
        stream_idle_timeout_s)."""
        if timeout_s is None:
            timeout_s = self.cfg.stream_idle_timeout_s
        while True:
            deadline = time.time() + timeout_s
            while True:
                try:
                    fr = seq.out.get(timeout=1.0)
                    break
                except queue.Empty:
                    if self._thread is not None \
                            and not self._thread.is_alive() \
                            and not self._stop.is_set():
                        raise RuntimeError(
                            "generation engine thread died"
                            + (f": {self._last_error}"
                               if self._last_error else ""))
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"no frame from sequence {seq.sid} in "
                            f"{timeout_s}s")
            yield fr
            if "done" in fr or "error" in fr:
                return

    def generate(self, prompt: List[int],
                 max_tokens: Optional[int] = None,
                 params: Optional[SamplingParams] = None,
                 seed: Optional[int] = None,
                 request_id: Optional[str] = None,
                 timeout_s: Optional[float] = None) -> List[int]:
        """Blocking convenience: submit and collect all tokens."""
        seq = self.submit(prompt, max_tokens, params, seed,
                          request_id=request_id)
        out: List[int] = []
        for fr in self.frames(seq, timeout_s):
            if "token" in fr:
                out.append(fr["token"])
            if "error" in fr:
                raise RuntimeError(fr["error"])
        return out

    def warmup(self) -> None:
        """Run one short request before real traffic (the serve
        deployment calls this at replica init), so the first request's
        TTFT does not carry first-call costs."""
        running = self._thread is not None and self._thread.is_alive()
        if not running:
            self.start()
        seq = self.submit([0, 1], max_tokens=2, _warmup=True)
        for fr in self.frames(seq):
            if "error" in fr:
                raise RuntimeError(fr["error"])
        if not running:
            self.stop()

    def stats(self) -> Dict[str, Any]:
        """The engine's counters and gauges.  ``phase_wall_s`` and
        ``phase_cpu_s`` map each of ``PHASES`` to the engine thread's
        cumulative wall and CPU seconds in it (see the module's
        docstring), up to the last phase boundary."""
        clock = self._clock
        phases = {"phase_wall_s": dict(clock.wall),
                  "phase_cpu_s": dict(clock.cpu)}
        with self._lock:
            return {
                "kv_pages_used": self.pool.used,
                "kv_pages_total": self.pool.num_pages,
                "running": len(self._running),
                "waiting": len(self._waiting),
                "steps": self._steps,
                "last_batch": self._last_batch,
                "tokens_generated": self._tokens_total,
                "prefill_tokens": self._prefill_tokens_total,
                "evictions": self._evictions,
                "max_context": self.max_context,
                "step_errors": self._step_errors,
                "last_error": self._last_error,
                "ttft_requests": self._ttft_requests,
                "ttft_waiting_s_total": self._waiting_s_total,
                "ttft_prefill_s_total": self._prefill_s_total,
                "tpot_s_total": self._tpot_s_total,
                "tpot_count": self._tpot_count,
                **phases,
            }

    # ------------------------------------------------------ engine loop
    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._wake:
                while (not self._waiting and not self._running
                       and not self._cancelled
                       and not self._stop.is_set()):
                    self._wake.wait(timeout=0.5)
                if self._stop.is_set():
                    break
            try:
                self.step()
            except Exception as e:  # noqa: BLE001
                # Poison the in-flight sequences (their device/pool
                # state may be mid-mutation) but KEEP the engine loop
                # alive: one transient step failure must not brick the
                # replica for every future request.
                self._last_error = repr(e)
                self._step_errors += 1
                with self._wake:
                    seqs = list(self._running) + list(self._waiting)
                    self._running.clear()
                    self._waiting.clear()
                for s in seqs:
                    self._retire(s, error=repr(e))

    def step(self) -> Dict[str, Any]:
        """ONE engine iteration: cancellations -> admissions (prefill)
        -> batched decode -> retirement.  Public for deterministic
        single-step tests."""
        clock = self._clock
        clock.begin_step()
        try:
            with torch.inference_mode():
                clock.switch("admit")
                self._process_cancellations()
                self._admit()
                if self._running:
                    self._decode_step()
                clock.switch("other")
            self._steps += 1
            self._last_batch = len(self._running)
            self._publish_gauges()
            return {"running": len(self._running),
                    "waiting": len(self._waiting)}
        finally:
            clock.switch("idle")

    def _process_cancellations(self) -> None:
        with self._lock:
            cancelled, self._cancelled = self._cancelled, set()
        for sid in cancelled:
            seq = self._seqs.get(sid)
            if seq is None or seq.finished:
                continue
            seq.cancelled = True
            with self._lock:
                if seq in self._running:
                    self._running.remove(seq)
                if seq in self._waiting:
                    self._waiting.remove(seq)
            self._retire(seq, reason="cancelled")

    def _admit(self) -> None:
        """Step-granularity admission: pull waiting sequences into the
        running batch (each admission = one prefill forward), bounded
        by max_batch, the page pool, and the per-step token budget."""
        budget = self.cfg.prefill_token_budget - len(self._running)
        while True:
            with self._lock:
                if not self._waiting or \
                        len(self._running) >= self.cfg.max_batch:
                    return
                seq = self._waiting[0]
                cost = _bucket(len(seq.tokens))
                # Always make progress when nothing is running yet.
                if cost > budget and self._running:
                    return
                n_pages = pages_for(len(seq.tokens), self.cfg.page_size)
                if n_pages > self.pool.num_pages:
                    self._waiting.popleft()
                    oversized = seq
                else:
                    pages = self.pool.alloc(n_pages)
                    if pages is None:
                        return      # wait for frees/retirements
                    self._waiting.popleft()
                    seq.pages = pages
                    oversized = None
            if oversized is not None:
                self._retire(oversized,
                             error="sequence exceeds KV pool capacity")
                continue
            budget -= cost
            try:
                self._prefill(seq)
            except Exception as e:  # noqa: BLE001
                # The seq is out of _waiting but not yet in _running —
                # the loop's poison pass can't see it, so retire it
                # here (frees its pages, delivers the error frame)
                # before re-raising for the step-error accounting.
                self._retire(seq, error=repr(e))
                raise

    def _page_table_row(self, seq: _Sequence) -> np.ndarray:
        row = np.zeros(self._pages_per_seq, np.int64)
        row[:len(seq.pages)] = seq.pages
        return row

    def _forward(self, kind: str, tokens: np.ndarray, table: np.ndarray,
                 positions: np.ndarray) -> torch.Tensor:
        """One forward over host-built int arrays; returns the logits
        and keeps the pool ``_fwd`` hands back.  The first forward of a
        (kind, token shape) for this ``_fwd`` runs under
        ``xprof.harvest_step`` and registers ``llm_prefill[T]`` or
        ``llm_decode``.  A decode forward's launch is the ``issue``
        phase; a prefill's stays in ``admit``."""
        dev = [torch.from_numpy(a).to(self.device)
               for a in (tokens, table, positions)]
        if kind == "decode":
            self._clock.switch("issue")
        args = (self._params, dev[0], self._kv["k_pages"],
                self._kv["v_pages"], dev[1], dev[2])
        key = (kind, tokens.shape)
        if self._programs.get(key) is self._fwd:
            logits, k, v = self._fwd(*args)
        else:
            from ..util import xprof

            t0 = time.perf_counter()
            (logits, k, v), info = xprof.harvest_step(self._fwd, *args)
            self._programs[key] = self._fwd
            name = f"llm_{kind}[{tokens.shape[1]}]" \
                if kind == "prefill" else f"llm_{kind}"
            try:
                xprof.register_program(
                    name, info, compile_seconds=time.perf_counter() - t0)
            except Exception:
                pass  # observability must never fail the request path
        self._kv["k_pages"], self._kv["v_pages"] = k, v
        return logits

    def _prefill(self, seq: _Sequence) -> None:
        n = len(seq.tokens)
        # First admission only (a recompute-preempted sequence
        # re-prefills but already emitted its first token), and never
        # the warmup sequence.
        first_admission = seq.generated == 0 and not seq.warmup
        t_admit = time.time()
        if first_admission:
            waited = max(t_admit - seq.submitted_ts, 0.0)
            self._waiting_s_total += waited
            self._ttft_requests += 1
            self._observe_phase("engine_waiting", waited)
            self._req_span(seq, "engine_waiting", seq.submitted_ts,
                           t_admit)
        pad = _bucket(n)
        tokens = np.zeros((1, pad), np.int64)
        tokens[0, :n] = seq.tokens
        positions = np.full((1, pad), -1, np.int64)
        positions[0, :n] = np.arange(n)
        logits = self._forward("prefill", tokens,
                               self._page_table_row(seq)[None, :], positions)
        seq.n_cached = n
        self._prefill_tokens_total += n
        self._count("prefill", n)
        with self._lock:
            self._running.append(seq)
        phase = self._clock.switch("wait")
        row = logits[0, n - 1].cpu().numpy()
        self._clock.switch(phase)
        self._emit_token(seq, row)
        if first_admission:
            t_first = time.time()
            self._prefill_s_total += t_first - t_admit
            self._observe_phase("prefill", t_first - t_admit)
            self._req_span(seq, "prefill", t_admit, t_first,
                           tags={"prompt_tokens": n})
            seq.first_token_ts = t_first

    def _decode_step(self) -> None:
        """One batched decode forward over every running sequence."""
        B = self.cfg.max_batch
        self._clock.switch("tables")
        for seq in list(self._running):
            if seq in self._running:   # an earlier ensure may evict it
                self._ensure_page(seq)
        batch = list(self._running)
        if not batch:
            return
        tokens = np.zeros((B, 1), np.int64)
        positions = np.full((B, 1), -1, np.int64)
        table = np.zeros((B, self._pages_per_seq), np.int64)
        for i, seq in enumerate(batch):
            tokens[i, 0] = seq.tokens[-1]
            positions[i, 0] = seq.n_cached
            table[i] = self._page_table_row(seq)
        logits = self._forward("decode", tokens, table, positions)
        self._clock.switch("wait")
        logits_np = logits[:len(batch), 0].cpu().numpy()
        self._clock.switch("sample")
        for i, seq in enumerate(batch):
            seq.n_cached += 1
            self._emit_token(seq, logits_np[i])

    def _ensure_page(self, seq: _Sequence) -> bool:
        """Guarantee a KV slot for position ``seq.n_cached``; on pool
        exhaustion evict the most recently admitted other sequence
        (recompute preemption) and retry."""
        needed = seq.n_cached // self.cfg.page_size + 1
        while len(seq.pages) < needed:
            pages = self.pool.alloc(1)
            if pages is not None:
                seq.pages.extend(pages)
                return True
            victim = None
            with self._lock:
                for cand in reversed(self._running):
                    if cand is not seq:
                        victim = cand
                        break
            if victim is None:
                with self._lock:
                    if seq in self._running:
                        self._running.remove(seq)
                self._retire(seq, error="KV pool exhausted with no "
                                        "evictable sequence")
                return False
            self._evict(victim)
        return True

    def _evict(self, victim: _Sequence) -> None:
        """Recompute preemption: drop the victim's pages, keep its
        tokens, park it at the FRONT of the waiting queue — it
        re-prefills (prompt + generated) once pages free up, without
        re-emitting anything already streamed."""
        with self._lock:
            if victim in self._running:
                self._running.remove(victim)
            self._waiting.appendleft(victim)
        self.pool.free(victim.pages)
        victim.pages = []
        victim.n_cached = 0
        self._evictions += 1
        self._count("evictions")

    def _emit_token(self, seq: _Sequence, logits_row: np.ndarray) -> None:
        tok = sample(logits_row, seq.params, seq.rng)
        seq.tokens.append(tok)
        seq.generated += 1
        self._tokens_total += 1
        self._count("tokens")
        now = time.time()
        if seq.generated > 1 and seq.last_token_ts is not None \
                and not seq.warmup:
            gap = max(now - seq.last_token_ts, 0.0)
            self._tpot_s_total += gap
            self._tpot_count += 1
            try:
                if self._metrics:
                    self._metrics["tpot"].observe(gap)
            except Exception:
                pass
        seq.last_token_ts = now
        seq.out.put({"token": tok, "index": seq.generated - 1})
        eos = self.cfg.eos_id is not None and tok == self.cfg.eos_id
        # n_cached is the NEXT write position: continuing needs it
        # inside both the page-table window and the model's max_seq.
        if eos or seq.generated >= seq.max_tokens \
                or seq.n_cached >= self.max_context:
            with self._lock:
                if seq in self._running:
                    self._running.remove(seq)
            self._retire(seq, reason="eos" if eos else "length")

    def _retire(self, seq: _Sequence, reason: str = "",
                error: Optional[str] = None) -> None:
        if seq.finished:
            return
        seq.finished = True
        self.pool.free(seq.pages)
        seq.pages = []
        self._seqs.pop(seq.sid, None)
        if seq.first_token_ts is not None and \
                seq.last_token_ts is not None and seq.generated > 1:
            self._req_span(seq, "decode", seq.first_token_ts,
                           seq.last_token_ts,
                           tags={"tokens": seq.generated,
                                 "reason": error or reason})
        if error is not None:
            seq.out.put({"error": error})
        else:
            seq.out.put({"done": True, "reason": reason,
                         "n_tokens": seq.generated})

    # ------------------------------------------------ spans, metrics
    def _req_span(self, seq: _Sequence, name: str, start: float,
                  end: float, tags: Optional[Dict[str, Any]] = None
                  ) -> None:
        """Record one lifecycle span of a request-traced sequence
        (no-op otherwise: untraced traffic pays nothing)."""
        if not seq.request_id:
            return
        try:
            from ..util import spans

            spans.record_span(
                name, start, end, cat="llm",
                tags={"request_id": seq.request_id, "seq": seq.sid,
                      **(tags or {})})
        except Exception:
            pass

    def _observe_phase(self, phase: str, seconds: float) -> None:
        try:
            if self._metrics:
                self._metrics["ttft_phase"].observe(
                    seconds, tags={"phase": phase})
        except Exception:
            pass

    def _publish_gauges(self) -> None:
        try:
            if self._metrics:
                self._metrics["batch"].set(float(self._last_batch))
                self._metrics["waiting"].set(
                    float(len(self._waiting)))
        except Exception:
            pass

    def _count(self, key: str, n: float = 1.0) -> None:
        try:
            if self._metrics:
                self._metrics[key].inc(n)
        except Exception:
            pass
