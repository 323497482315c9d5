"""The controls at a CPU size: the reference in float8 (the 124M
training and both serving cells) or int8 (the XL training cell) in the
program's place has to come out not correct, on every seed, while the
program does (the same comparison the card runs at the cells' sizes)."""

import pytest

from benchmark import control

from .conftest import TINY_LIMITS, tiny_cell


def fails(readings):
    return any(v > TINY_LIMITS[k] for k, v in readings.items()
               if k in TINY_LIMITS)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,precision", [("train-gpt2-124m-b64", "fp8"),
                                            ("train-gpt2-xl-b16", "int8")])
def test_training_control_is_not_correct(name, precision, seed, cpu):
    out = control.train_readings(tiny_cell(name), seed, cpu, precision, "")
    assert not fails(out["program"])
    assert fails(out["control_readings"])


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", ["serve-gpt2-xl-longchat",
                                  "serve-gpt2-124m-longchat"])
def test_serving_control_is_not_correct(name, seed, cpu):
    out = control.serve_readings(tiny_cell(name), seed, cpu, "fp8", "", 2.0)
    assert out["tokens_compared"] > 0
    assert not fails(out["program"])
    assert fails(out["control_readings"])


def test_state_unchanged_reads_one(cpu):
    out = control.train_readings(tiny_cell("train-gpt2-124m-b64"), 4, cpu,
                                 "", "state_unchanged")
    assert out["program"]["change_norm_gap"] == pytest.approx(1.0)
