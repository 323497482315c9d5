"""LLM inference plane (counterpart of ``ray_tpu.llm``).

Continuous-batching generation engine (Orca-style iteration-level
scheduling) over a vLLM-style paged KV cache, with host-side sampling
and the ``LLMDeployment`` streaming front end.
"""

from __future__ import annotations

from .engine import EngineConfig, GenerationEngine  # noqa: F401
from .sampling import SamplingParams, sample  # noqa: F401
from .serving import LLMDeployment, llm_deployment  # noqa: F401

__all__ = [
    "EngineConfig", "GenerationEngine", "LLMDeployment",
    "SamplingParams", "llm_deployment", "sample",
]
