"""The trace reduction on a made-up timeline: busy time is the union of the
device's operations, idle gaps are named by the innermost host span."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import torch

from hbbench import tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _event(name, device, start, end):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def test_summary():
    events = [
        _event("hbbench/window", CPU, 0, 1000),
        _event("hbbench/step", CPU, 0, 600),
        _event("hbbench/eval", CPU, 600, 1000),
        _event("kernel_a", CUDA, 100, 300),
        _event("kernel_b", CUDA, 250, 400),  # overlaps a: counted once
        _event("kernel_a", CUDA, 700, 800),
        _event("hbbench/step", CUDA, 100, 400),  # a device-side annotation is not an operation
    ]
    t = tracing.summary(events, 1e-3)
    assert t["busy_s"] == pytest.approx(400e-6)
    assert t["kernel_seconds"] == pytest.approx({"kernel_a": 300e-6, "kernel_b": 150e-6})
    assert t["idle_by_span"] == pytest.approx({"step": 400e-6, "eval": 200e-6})
    assert tracing.idle_percent(t) == pytest.approx(60.0)
    assert tracing.kernel_seconds(t, "kernel_a") == pytest.approx((300e-6, 2))
    b = tracing.breakdown(t)
    assert b["device_ops"][0][0] == "kernel_a" and len(b["idle_gaps"]) == 2


def test_no_device_work_reads_nothing():
    t = tracing.summary([_event("hbbench/window", CPU, 0, 10)], 1e-5)
    assert tracing.idle_percent(t) is None
