"""Token sampling: greedy, temperature, top-k, top-p (nucleus).

The port's own copy of ``ray_tpu/llm/sampling.py``.  numpy only: the
engine samples on the host, in float64, from the last position's logits
(one [V] row per sequence per step) with the sequence's
``np.random.Generator``, so sampling never enters the forward and the
same logits and seed give the same token as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature == 0 means greedy (argmax; top_k/top_p ignored).
    top_k == 0 disables top-k; top_p == 1.0 disables nucleus filtering.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def validate(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def greedy(logits: np.ndarray) -> int:
    return int(np.argmax(logits))


def apply_temperature(logits: np.ndarray, temperature: float) -> np.ndarray:
    return np.asarray(logits, np.float64) / max(temperature, 1e-8)


def top_k_mask(logits: np.ndarray, k: int) -> np.ndarray:
    """Keep the k highest logits, -inf the rest (k<=0: no-op)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    out = np.array(logits, np.float64)
    kth = np.partition(out, -k)[-k]
    out[out < kth] = -np.inf
    return out


def top_p_mask(logits: np.ndarray, p: float) -> np.ndarray:
    """Nucleus filtering: keep the smallest set of tokens whose
    probability mass reaches ``p`` (always at least one)."""
    if p >= 1.0:
        return logits
    out = np.array(logits, np.float64)
    probs = softmax(out)
    order = np.argsort(-probs, kind="stable")
    cum = np.cumsum(probs[order])
    # Token i survives if the mass BEFORE it is < p (the first token
    # always survives; the one crossing the threshold is included).
    cut = cum - probs[order] >= p
    out[order[cut]] = -np.inf
    return out


def softmax(logits: np.ndarray) -> np.ndarray:
    x = np.asarray(logits, np.float64)
    x = x - np.max(x)
    e = np.exp(x)
    return e / np.sum(e)


def sample(logits: np.ndarray,
           params: Optional[SamplingParams] = None,
           rng: Optional[np.random.Generator] = None) -> int:
    """Sample one token id from a [V] logits row."""
    params = params or SamplingParams()
    if params.temperature <= 0.0:
        return greedy(logits)
    x = apply_temperature(logits, params.temperature)
    x = top_k_mask(x, params.top_k)
    x = top_p_mask(x, params.top_p)
    probs = softmax(x)
    rng = rng or np.random.default_rng()
    return int(rng.choice(probs.shape[-1], p=probs))
