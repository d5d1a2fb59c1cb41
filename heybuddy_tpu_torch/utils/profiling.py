"""
Tracing and timing utilities.

Counterpart of the JAX package's ``utils/profiling.py``: ``stage_timer``
wraps a pipeline stage with an EMA-tracked wall-clock span, and ``trace``
names the same span in a device trace (``torch.profiler.record_function``
where the JAX package uses ``jax.profiler.TraceAnnotation``).
``start_profiler`` / ``stop_profiler`` bracket a ``torch.profiler.profile``
of the CPU and, where there is one, the CUDA device, and write its Chrome
trace into ``HEYBUDDY_PROFILE_DIR`` (default ``heybuddy-profile`` in the
temporary directory). As in the JAX package, a profiler that cannot start
logs a warning and returns None.

A stage time is host wall clock: a span around asynchronous CUDA work ends
when the work is queued, unless the stage waits for it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, Optional

import torch

from heybuddy_tpu_torch.utils.log import logger
from heybuddy_tpu_torch.utils.strings import human_duration

__all__ = [
    "StageTimes", "GLOBAL_STAGE_TIMES", "stage_timer", "trace", "start_profiler", "stop_profiler",
]


class StageTimes:
    """EMA + total wall-clock per named stage."""

    def __init__(self, ema_weight: float = 0.1) -> None:
        self.ema_weight = ema_weight
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    def record(self, name: str, seconds: float) -> None:
        self.total[name] = self.total.get(name, 0.0) + seconds
        self.count[name] = self.count.get(name, 0) + 1
        if name in self.ema:
            self.ema[name] = self.ema_weight * seconds + (1 - self.ema_weight) * self.ema[name]
        else:
            self.ema[name] = seconds

    def summary(self) -> str:
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            lines.append(
                f"{name}: total {human_duration(self.total[name])} "
                f"({self.count[name]}x, ema {self.ema[name] * 1000:.1f}ms)"
            )
        return "\n".join(lines)


GLOBAL_STAGE_TIMES = StageTimes()


@contextlib.contextmanager
def stage_timer(name: str, times: Optional[StageTimes] = None) -> Iterator[None]:
    """Time a stage and name the same span in the device trace."""
    times = times or GLOBAL_STAGE_TIMES
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    times.record(name, time.perf_counter() - start)


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """A span in the device trace alone (no host timing)."""
    with torch.profiler.record_function(name):
        yield


_PROFILER: Optional[torch.profiler.profile] = None
_PROFILER_DIR: Optional[str] = None


def start_profiler(log_dir: Optional[str] = None) -> Optional[str]:
    """Start a ``torch.profiler`` trace; returns the log dir (None on failure)."""
    global _PROFILER, _PROFILER_DIR
    log_dir = log_dir or os.environ.get(
        "HEYBUDDY_PROFILE_DIR", os.path.join(tempfile.gettempdir(), "heybuddy-profile"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        os.makedirs(log_dir, exist_ok=True)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    except (OSError, RuntimeError) as ex:
        logger.warning(f"Could not start profiler: {ex}")
        return None
    _PROFILER, _PROFILER_DIR = profiler, log_dir
    logger.info(f"Profiler trace started -> {log_dir}")
    return log_dir


def stop_profiler() -> Optional[str]:
    """Stop the trace ``start_profiler`` began and write it; returns the trace's path."""
    global _PROFILER, _PROFILER_DIR
    if _PROFILER is None:
        return None
    profiler, log_dir = _PROFILER, _PROFILER_DIR
    _PROFILER = _PROFILER_DIR = None
    profiler.stop()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    profiler.export_chrome_trace(path)
    logger.info(f"Profiler trace stopped -> {path}")
    return path
