"""The yardstick's work functions against hand-computed values."""

from __future__ import annotations

import pytest

from hbbench import spec, work

EMB = spec.config("v8-mlp")["embedding"]


def test_k1_bytes_at_2048_clips():
    ops, nbytes = work.k1_work(2048, 23040)
    # audio 2048 x 23040 x 4, patches 2048 x 40 x 128 x 4, constants (400 x 256 + 128 x 32) x 4
    assert nbytes == 2048 * 23040 * 4 + 2048 * 40 * 128 * 4 + (400 * 256 + 128 * 32) * 4
    assert nbytes / work.PEAK_BYTES * 1e3 == pytest.approx(0.0690, abs=5e-5)
    assert ops / work.PEAK_FP32 < nbytes / work.PEAK_BYTES  # K1 is bound by its bytes


def test_k2_operations_at_2048_clips():
    ops, _ = work.k2_work(2048, 23040, EMB)
    per_clip = 35 * (128 * 192 + 2 * 2 * 192 * 384 + 192 * 4) * 2 + 16 * 4 * 19 * 192 * 4 + 16 * 4 * 192 * 96 * 2
    assert ops == 2048 * per_clip
    assert ops / 1e9 == pytest.approx(52.66, abs=0.01)
    assert per_clip / 1e6 == pytest.approx(25.71, abs=0.01)


def test_embedding_parameter_count():
    assert work.embedding_param_count(EMB) == 128 * 192 + 192 + 2 * (192 * 384 + 384 + 384 * 192 + 192) \
        + 19 * 192 + 192 * 4 + 768 * 96 + 96


def test_head_row_flops():
    head = spec.config("v8-transformer")["head"]
    block = 4 * 16 * 96 * 96 * 2 + 2 * 16 * 16 * 96 * 2 + 3 * 16 * 96 * 270 * 2
    assert work.transformer_row_flops(head) == 16 * 96 * 96 * 2 + 2 * block + 96 * 16 * 2
    mlp = spec.config("v8-mlp")["head"]
    assert work.perceptron_row_flops(mlp) == (2 * 1536 * 64 + 64 * 96) * 2 + 2 * (2 * 96 * 64 + 64 * 96) * 2 \
        + (2 * 96 * 64 + 64) * 2


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(67e12, 0.0, work.PEAK_FP32) == 1.0
    assert work.least_seconds(0.0, 3.35e12, work.PEAK_FP32) == 1.0
