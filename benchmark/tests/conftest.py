"""Shared fixtures of the benchmark's tests: a cell cut to a CPU size,
and the card, decided inside a fixture."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SEED = 2**31 + 77
# Limits for the CPU size, a little above what sound tiny runs read
# (the cells' own limits are set for their published widths).
TINY_LIMITS = {"loss_gap": 1e-3, "grad_norm_gap": 0.02,
               "change_norm_gap": 0.02, "logit_gap": 0.05}


def tiny_cell(name: str):
    """The cell ``name`` at a size the CPU runs in seconds: every width
    cut, the same code paths."""
    from benchmark.harness.spec import load_cell

    cell = copy.deepcopy(load_cell(name))
    # initializer_range 0.1 keeps std^2 * width near the full models'
    # (0.02^2 * 768 or 1600): at 0.02 and width 128 the residual stream
    # is all embedding, attention moves no logit, and a broken cache
    # would serve the same greedy tokens.
    cell.config.update(n_layer=2, n_embd=128, n_head=2, vocab_size=512,
                       n_positions=128, initializer_range=0.1)
    cell.config["train"]["reference_rows"] = 2
    cell.limits = {k: TINY_LIMITS[k] for k in cell.limits}
    cell.config["serve"]["engine"] = {
        "page_size": 16, "num_pages": 64, "max_batch": 4,
        "prefill_token_budget": 256, "max_context": 128}
    if cell.traffic["kind"] == "train":
        cell.traffic.update(batch=4, seq=128)
    else:
        cell.traffic.update(
            clients=4, block=8, compare_requests=12,
            prompt={"dist": "lognormal", "median": 20, "sigma": 0.7,
                    "min": 8, "max": 40},
            output={"dist": "uniform", "min": 4, "max": 12})
    return cell


@pytest.fixture
def cpu():
    import torch

    torch.manual_seed(0)
    return torch.device("cpu")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
