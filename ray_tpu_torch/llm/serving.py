"""LLM serving: counterpart of ``ray_tpu/llm/serving.py``.

``LLMDeployment`` hosts ONE GenerationEngine per replica and its
``__call__`` is a generator of token frames.  Construction returns at
once and a background thread builds and warms the engine (weight init
and first calls can take longer than a serve health probe allows);
requests wait for readiness.  A consumer that closes the stream
mid-generation runs the generator's ``finally``, which cancels the
sequence and frees its KV pages.

Each request runs under the request id of the caller's tracing context
(``util.tracing.request_scope``; the serve plane opens one for every
request it routes), so the engine records its waiting/prefill/decode
spans under it.  ``llm_deployment`` builds the serve application: its
replicas lease a GPU (``num_gpus``, default 1) where the JAX package's
lease CPUs and see the TPU anyway, since the port's runtime gives a
CPU-only lease an empty ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .engine import EngineConfig, GenerationEngine
from .sampling import SamplingParams


class LLMDeployment:
    """Serve deployment class: one engine per replica, streaming token
    frames per request.

    Request payload (JSON-able dict):
      {"prompt": [token ids], "max_tokens": int?, "temperature": f?,
       "top_k": int?, "top_p": f?, "seed": int?, "warmup": bool?}
    Response frames: {"token": id, "index": i} per token, then
      {"done": true, "reason": "eos"|"length", "n_tokens": n}
    (or {"error": "..."} for a rejected/failed request).
    """

    def __init__(self, model: str = "gpt2", model_cfg: Any = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 seed: int = 0, warmup: bool = True, device=None):
        self._ready = threading.Event()
        self._init_error: Optional[str] = None
        self._engine: Optional[GenerationEngine] = None

        def _build() -> None:
            try:
                engine = GenerationEngine(
                    model=model, model_cfg=model_cfg,
                    engine_cfg=engine_cfg, seed=seed,
                    device=device).start()
                if warmup:
                    engine.warmup()
                self._engine = engine
            except Exception as e:  # noqa: BLE001 — surfaced per call
                self._init_error = repr(e)
            finally:
                self._ready.set()

        threading.Thread(target=_build, daemon=True,
                         name="llm-engine-init").start()

    def _engine_or_raise(self, timeout_s: float = 600.0
                         ) -> GenerationEngine:
        if not self._ready.wait(timeout_s):
            raise RuntimeError("LLM engine initialization timed out")
        if self._init_error is not None:
            raise RuntimeError(
                f"LLM engine failed to initialize: {self._init_error}")
        return self._engine

    def __call__(self, payload: Optional[Dict[str, Any]]):
        engine = self._engine_or_raise()
        payload = payload or {}
        # The request id of the caller's tracing context opts this
        # sequence into lifecycle spans.
        from ..util import tracing

        rid = tracing.current_request_id()
        try:
            prompt = [int(t) for t in payload["prompt"]]
            params = SamplingParams(
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)))
            seq = engine.submit(
                prompt,
                max_tokens=payload.get("max_tokens"),
                params=params,
                seed=payload.get("seed"),
                request_id=rid,
                # {"warmup": true} keeps a client's priming request out
                # of the TTFT/TPOT accounting.
                _warmup=bool(payload.get("warmup")))
        except (KeyError, TypeError, ValueError) as e:
            yield {"error": f"bad request: {e!r}"}
            return
        try:
            for frame in engine.frames(seq):
                yield frame
        finally:
            # Consumer gone (GeneratorExit) or stream complete: cancel
            # is a no-op on finished sequences and frees the pages of a
            # live one.
            engine.cancel(seq.sid)

    def stats(self) -> Dict[str, Any]:
        return self._engine_or_raise().stats()

    def stop(self) -> None:
        """Stop the replica's engine thread once its build has ended (a
        no-op if the build failed)."""
        self._ready.wait(600.0)
        if self._engine is not None:
            self._engine.stop()


def llm_deployment(name: str = "llm", model: str = "gpt2",
                   model_cfg: Any = None,
                   engine_cfg: Optional[EngineConfig] = None,
                   num_replicas: int = 1,
                   autoscaling: Any = None,
                   max_ongoing_requests: Optional[int] = None,
                   num_cpus: float = 1, num_gpus: float = 1,
                   seed: int = 0, warmup: bool = True,
                   route_prefix: Optional[str] = None, device=None):
    """Build the serve Application for an LLM deployment.

    Each replica leases ``num_gpus`` (0.5 puts two replicas on one
    card) and builds its engine on ``device`` (None: the card its lease
    exposes; the CPU tests pass ``num_gpus=0, device="cpu"``).
    ``autoscaling`` takes a serve.AutoscalingConfig: replica count then
    follows engine load — streams in flight plus handle queue depth —
    through the existing request autoscaler.  ``max_ongoing_requests``
    defaults to the engine's max_batch so admission control saturates
    exactly when the continuous batch does.
    """
    from .. import serve

    engine_cfg = engine_cfg or EngineConfig()
    if max_ongoing_requests is None:
        max_ongoing_requests = engine_cfg.max_batch
    dep = serve.deployment(
        LLMDeployment, name=name, num_replicas=num_replicas,
        ray_actor_options={"num_cpus": num_cpus, "num_gpus": num_gpus},
        autoscaling_config=autoscaling,
        route_prefix=route_prefix,
        max_ongoing_requests=max_ongoing_requests)
    return dep.bind(model=model, model_cfg=model_cfg,
                    engine_cfg=engine_cfg, seed=seed, warmup=warmup,
                    device=device)
