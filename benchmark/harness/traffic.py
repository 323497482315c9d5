"""The general generator of closed-loop serving traffic.

A mix file gives the clients and the prompt and output length
distributions (every request greedy, with no end token); this module
makes the requests from the seed.  Every seed gets the same set of sizes in another order: the
requests come in blocks, and each block holds the same quantiles of
both distributions, shuffled by the seed, so any run of whole blocks
does the same work.  Token ids are uniform over the vocabulary.

Each client's first request stands for a request already under way
when the window opens: its length L is drawn from the length-biased
output distribution and the part R still to come uniformly in 1..L
(the stationary residual of a closed loop); its prompt carries the
L - R tokens it has already generated, so contexts are as long as in a
steady state from the start.
"""

from __future__ import annotations

import math
import threading
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

Request = Tuple[List[int], int]            # (prompt ids, max_tokens)


def lengths(dist: dict, n: int) -> List[int]:
    """The n quantiles (i + 0.5) / n of a length distribution."""
    qs = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "lognormal":
        nd = NormalDist()
        vals = [dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf(q))
                for q in qs]
    elif dist["dist"] == "uniform":
        vals = [dist["min"] + q * (dist["max"] - dist["min"] + 1) - 0.5
                for q in qs]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(min(max(round(v), dist["min"]), dist["max"])) for v in vals]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), *stream])


class ClosedLoopMix:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed
        self.block = int(mix["block"])
        self._prompts = lengths(mix["prompt"], self.block)
        self._outputs = lengths(mix["output"], self.block)
        self._next = 0
        self._lock = threading.Lock()

    def _tokens(self, n: int, *stream: int) -> List[int]:
        return _rng(self.seed, *stream).integers(
            0, self.vocab, n).tolist()

    def request(self, i: int) -> Request:
        """The pool's ``i``-th request."""
        k, j = divmod(i, self.block)
        rng = _rng(self.seed, 1, k)
        prompt = self._prompts[rng.permutation(self.block)[j]]
        out = self._outputs[rng.permutation(self.block)[j]]
        return self._tokens(prompt, 2, i), out

    def next_request(self) -> Request:
        with self._lock:
            i = self._next
            self._next += 1
        return self.request(i)

    def first_requests(self) -> List[Request]:
        """One request a client, under way (see the module docstring)."""
        n = int(self.mix["clients"])
        lo, hi = self.mix["output"]["min"], self.mix["output"]["max"]
        ls = np.arange(lo, hi + 1)
        cdf = np.cumsum(ls / ls.sum())
        qs = (np.arange(n) + 0.5) / n
        full = ls[np.searchsorted(cdf, qs)]
        rng = _rng(self.seed, 3)
        full = full[rng.permutation(n)]
        done_share = qs[rng.permutation(n)]
        prompts = np.array(lengths(self.mix["prompt"], n))[rng.permutation(n)]
        out = []
        for c in range(n):
            rest = 1 + int(done_share[c] * full[c])       # 1..L
            history = int(full[c]) - rest
            out.append((self._tokens(int(prompts[c]) + history, 4, c), rest))
        return out

    def prompt_lengths_to_warm(self, max_context: int) -> List[int]:
        """One prompt length for every prefill bucket (powers of two
        from 8) that the mix's prompts fall into."""
        lo = self.mix["prompt"]["min"]
        hi = min(self.mix["prompt"]["max"] + self.mix["output"]["max"] - 1,
                 max_context - 1)
        out, b = [], 8
        while b < lo:
            b *= 2
        while True:
            out.append(min(b, hi))
            if b >= hi:
                return out
            b *= 2
