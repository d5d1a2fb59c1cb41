"""The lower-precision control has to come out as not correct: the
reference in the program's place with its embedding products in float8
e4m3 (the step below the configuration's bfloat16), the program with its
own bf16-DFT log-mel (the step below the configuration's float32 mel), and
for the trainer the reference with TF32 on (the step below float32 with
TF32 off, which only a card has). The limits hold the program and fail the
control."""

from __future__ import annotations

import pytest
import torch

from hbbench import run, spec
from program_controls import bf16_mel
from small import MEL_CONTROL, SMALL

BENCH = spec.benchmark()


def _controls(cell: str, device: torch.device, seed: int) -> dict:
    result = run.run_cell(cell, seed, 0.5, False, device, control=True, overrides=SMALL[cell])
    assert result["correct"], result["checks"]
    return result


@pytest.mark.parametrize("cell", ["gen-fused.v8-mlp", "listen.v8-mlp"])
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_the_fp8_control_fails(cell, seed):
    result = _controls(cell, torch.device("cpu"), seed)
    limits = spec.cell(BENCH, cell)["limits"]
    assert any(result["controls"][name] > limit for name, limit in limits.items() if name in result["controls"])


@pytest.mark.card
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_the_tf32_control_fails(cuda_device, seed):
    cell = "train.v8-transformer"
    result = _controls(cell, cuda_device, seed)
    limits = spec.cell(BENCH, cell)["limits"]
    assert any(result["controls"][name] > limit for name, limit in limits.items() if name in result["controls"])


@pytest.mark.parametrize("cell", ["gen-fused.v8-mlp", "listen.v8-mlp"])
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_the_programs_bf16_mel_fails(cell, seed):
    with bf16_mel():
        result = run.run_cell(cell, seed, 0.5, False, torch.device("cpu"), overrides=MEL_CONTROL[cell])
    assert not result["correct"]
    assert result["checks"]["mel_gap"]["value"] > result["checks"]["mel_gap"]["limit"]
