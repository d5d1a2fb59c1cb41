"""
Device timing for the chip scripts: CUDA-event medians and the card's name
and power limit, which every kept time is written beside.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

__all__ = ["cuda_ms", "elapsed_ms", "nvidia_smi_line"]


def cuda_ms(fn: Callable[[], object], warmup: int = 3, runs: int = 11) -> float:
    """Median milliseconds of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def elapsed_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Milliseconds of ``iters`` calls of ``fn``: CUDA events on a card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3


def nvidia_smi_line() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
