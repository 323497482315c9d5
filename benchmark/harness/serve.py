"""Serving cells: the port's ``GenerationEngine`` under closed-loop
clients, in process, through ``submit`` and ``frames`` (the calls that
``LLMDeployment``'s replica makes).

Set-up builds the engine on the seed's weights, runs one request of
every prefill bucket the mix can produce (so every forward shape has
had its first call), starts the clients (all in one thread, see
``Clients``) and waits until every client's first request has its
first token.  The window then runs for the given seconds; each token
frame is timestamped as its client reads it.  At the close the clients stop, the requests still
running are cancelled, and a sample of the finished requests, the
longest among them, is held against the reference's full forward over
each prompt and its served tokens.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import env
from . import trace as tracing
from . import weights as W
from .traffic import ClosedLoopMix


class Record:
    __slots__ = ("prompt", "max_tokens", "tokens", "t", "reason", "error",
                 "done_t")

    def __init__(self, prompt: List[int], max_tokens: int):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.tokens: List[int] = []
        self.t: List[float] = []
        self.reason: Optional[str] = None
        self.error: Optional[str] = None
        self.done_t: Optional[float] = None


def make_engine(cfg: dict, seed: int, device):
    from ray_tpu_torch.llm.engine import EngineConfig, GenerationEngine

    return GenerationEngine(
        model="gpt2", model_cfg=W.port_config(cfg, remat=False),
        engine_cfg=EngineConfig(**cfg["serve"]["engine"]),
        params=W.gpt2_weights(cfg, seed, device), device=device)


class Clients:
    """Every client in one thread, so that the clients take as little
    of the interpreter as the process's real callers would: after each
    engine step (its ``stats()["steps"]`` moves) the thread reads every
    frame that the step produced, stamps it, and submits a client's
    next request when its last one ends."""

    def __init__(self, engine, mix: ClosedLoopMix, timeout_s: float):
        from ray_tpu_torch.llm.sampling import SamplingParams

        self.engine, self.mix, self.timeout_s = engine, mix, timeout_s
        self.greedy = SamplingParams()
        self.records: List[Record] = []
        self.active: Dict[int, Any] = {}      # client -> (sequence, record)
        self.stop = threading.Event()
        self.all_started = threading.Event()
        self.error: Optional[BaseException] = None
        self._first = mix.first_requests()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="clients")

    def _submit(self, c: int, req) -> None:
        rec = Record(*req)
        seq = self.engine.submit(rec.prompt, max_tokens=rec.max_tokens,
                                 params=self.greedy)
        self.records.append(rec)
        self.active[c] = (seq, rec)

    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 -- reported by close()
            self.error = e
            self.all_started.set()

    def _loop(self) -> None:
        import queue

        for c, req in enumerate(self._first):
            self._submit(c, req)
        started = set()
        seen_step, last_read = -1, time.perf_counter()
        while self.active:
            step = self.engine.stats()["steps"]
            now = time.perf_counter()
            if step == seen_step and now - last_read < 0.05:
                time.sleep(0.0005)
                continue
            seen_step, last_read = step, now
            for c, (seq, rec) in list(self.active.items()):
                while True:
                    try:
                        fr = seq.out.get_nowait()
                    except queue.Empty:
                        break
                    if "token" in fr:
                        rec.tokens.append(fr["token"])
                        rec.t.append(now)
                        started.add(c)
                        continue
                    if "error" in fr:
                        rec.error = fr["error"]
                    else:
                        rec.reason = fr["reason"]
                    rec.done_t = now
                    started.add(c)
                    del self.active[c]
                    if not self.stop.is_set() and rec.error is None:
                        self._submit(c, self.mix.next_request())
                    break
            if len(started) == len(self._first):
                self.all_started.set()
            if any(now - (rec.t[-1] if rec.t else now) > self.timeout_s
                   for _seq, rec in self.active.values()):
                raise TimeoutError(f"no frame in {self.timeout_s} s")

    def start(self) -> None:
        self.thread.start()

    def close(self) -> None:
        """Stop the clients, cancelling what runs until the thread has
        ended."""
        self.stop.set()
        deadline = time.perf_counter() + 120
        while self.thread.is_alive():
            if time.perf_counter() > deadline:
                raise RuntimeError("clients did not stop")
            for seq, _rec in list(self.active.values()):
                self.engine.cancel(seq.sid)
            self.thread.join(timeout=0.2)
        if self.error is not None:
            raise self.error


def warm_up(engine, mix: ClosedLoopMix) -> None:
    """One two-token request of every prefill bucket the mix can
    produce, together: every prefill shape and the decode shape get
    their first call here."""
    vocab = engine.model_cfg.vocab_size
    seqs = [engine.submit([i % vocab for i in range(n)], max_tokens=2)
            for n in mix.prompt_lengths_to_warm(engine.max_context)]
    for seq in seqs:
        for fr in engine.frames(seq):
            if "error" in fr:
                raise RuntimeError(f"warm-up request failed: {fr['error']}")


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: Optional[str] = None) -> Dict[str, Any]:
    cfg, mix_cfg = dict(cell.config), cell.traffic
    engine = make_engine(cfg, seed, device).start()
    env.phase(t_start, "engine built")
    mix = ClosedLoopMix(mix_cfg, cfg["vocab_size"], seed)
    warm_up(engine, mix)
    env.phase(t_start, "prefill buckets and decode warmed")
    if traced:
        tracing.warm(device)
    clients = Clients(engine, mix, timeout_s=mix_cfg["frame_timeout_s"])
    clients.start()
    if not clients.all_started.wait(timeout=mix_cfg["ramp_timeout_s"]) \
            or clients.error is not None:
        raise RuntimeError("the clients' first requests were not all "
                           f"admitted in {mix_cfg['ramp_timeout_s']} s: "
                           f"{clients.error!r}")
    stats_open = engine.stats()
    t_open = time.perf_counter()
    env.phase(t_start, f"{mix_cfg['clients']} clients admitted")
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    summary = None
    if traced:
        time.sleep(max(0.0, (seconds - mix_cfg["traced_seconds"]) / 2))
        summary = tracing.complete_capture(
            device, lambda: time.sleep(mix_cfg["traced_seconds"]))
    time.sleep(max(0.0, t_open + seconds - time.perf_counter()))
    t_close = time.perf_counter()
    stats_close = engine.stats()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    env.after_window(device)
    clients.close()
    engine.stop()
    records = clients.records
    inside = [r for r in records
              if any(t_open <= t <= t_close for t in r.t)
              or (r.done_t is not None and t_open <= r.done_t <= t_close)]
    out = {
        "kind": "serve", "setup_s": setup_s, "window_s": t_close - t_open,
        "t_open": t_open, "t_close": t_close, "records": records,
        "stats_open": stats_open, "stats_close": stats_close,
        "trace": summary,
        "attempted": len(inside),
        "failed": sum(r.error is not None for r in inside),
        "memory_peak_bytes": peak,
    }
    evictions = stats_close["evictions"] - stats_open["evictions"]
    print(f"engine: evictions {evictions}"
          + (" (FLAGGED: the cell is sized to evict nothing)"
             if evictions else "")
          + f", step_errors {stats_close['step_errors']}", file=sys.stderr)
    steps = stats_close["steps"] - stats_open["steps"]
    print(f"window: {steps} engine steps, "
          f"{1e3 * (t_close - t_open) / max(steps, 1):.1f} ms a step, "
          f"{len(window_prefills(out))} prefills", file=sys.stderr)
    sample = choose(records, t_open, t_close, seed,
                    mix_cfg["compare_requests"])
    del engine, clients
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"program freed: {env.device_memory(device)}", file=sys.stderr)
    t_ref = time.perf_counter()
    gaps = served_gaps(cfg, seed, sample, device, control)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    out["checks"] = {"logit_gap": gaps["program"]}
    if control is not None:
        out["control_gap"] = gaps["control"]
    out["info"] = {"requests_compared": len(sample),
                   "tokens_compared": gaps["tokens"]}
    return out


def choose(records: List[Record], t_open: float, t_close: float,
           seed: int, k: int) -> List[Record]:
    """The longest request finished inside the window, and up to k - 1
    others drawn from the seed.  Requests that finished during the ramp
    ran at a partial batch and are not the window's."""
    done = sorted((r for r in records if r.reason == "length"
                   and r.done_t is not None
                   and t_open <= r.done_t <= t_close),
                  key=lambda r: (len(r.tokens), r.prompt))
    if not done:
        return []
    longest, rest = done[-1], done[:-1]
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 5])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def served_gaps(cfg: dict, seed: int, sample: List[Record], device,
                control: Optional[str] = None) -> Dict[str, Any]:
    """For each served token of the sample, by how much its logit lies
    under the best one in the float32 reference's full forward over the
    prompt and the served tokens; the widest such gap.  With
    ``control`` ("fp8"), also the widest gap of the token that the
    reference in that precision puts first at each position."""
    from ..reference import gpt2 as ref

    ref.exact_float32()
    p = W.gpt2_weights(cfg, seed, device)
    worst, worst_control, n = 0.0, 0.0, 0
    with torch.no_grad():
        for rec in sample:
            ids = torch.tensor(rec.prompt + rec.tokens[:-1], device=device)
            start = len(rec.prompt) - 1
            rows = torch.arange(start, start + len(rec.tokens),
                                device=device)
            logits = ref.logits_at(p, ids, rows, cfg)
            best = logits.max(-1).values
            served = torch.tensor(rec.tokens, device=device)
            gap = best - logits.gather(-1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            n += len(rec.tokens)
            if control is not None:
                top = ref.logits_at(p, ids, rows, cfg, control).argmax(-1)
                gap = best - logits.gather(-1, top[:, None])[:, 0]
                worst_control = max(worst_control, float(gap.max()))
    del p
    out = {"program": worst if sample else float("inf"), "tokens": n}
    if control is not None:
        out["control"] = worst_control
    return out


def window_tokens(run: Dict[str, Any]) -> int:
    """Tokens that clients received inside the window."""
    a, b = run["t_open"], run["t_close"]
    return sum(a <= t <= b for r in run["records"] for t in r.t)


def window_gaps(run: Dict[str, Any]) -> List[float]:
    """Every gap between consecutive tokens of a request, both received
    inside the window, in seconds."""
    a, b = run["t_open"], run["t_close"]
    return [t1 - t0 for r in run["records"] for t0, t1 in zip(r.t, r.t[1:])
            if a <= t0 and t1 <= b]


def window_decodes(run: Dict[str, Any]):
    """(context, count) of the tokens that decode steps produced inside
    the window: the n-th token of a request (n >= 1) attends to its
    prompt and n tokens more."""
    a, b = run["t_open"], run["t_close"]
    for r in run["records"]:
        for n, t in enumerate(r.t):
            if n >= 1 and a <= t <= b:
                yield len(r.prompt) + n


def window_prefills(run: Dict[str, Any]) -> List[int]:
    """Prompt lengths of the requests whose first token (their prefill)
    came inside the window."""
    a, b = run["t_open"], run["t_close"]
    return [len(r.prompt) for r in run["records"] if r.t and a <= r.t[0] <= b]
