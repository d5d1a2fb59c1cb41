"""
Tracing and timing utilities.

``span(name)`` marks one layer's work as a named range of a
``torch.profiler`` trace. It costs a flag check when no profiler runs: the
program's ranges appear exactly when an operator runs a command under
``torch.profiler`` (CPU and, where there is one, CUDA activity), on the
profiler's clock, nested as the calls nest, beside the kernels they launch.
A span never synchronises and never touches the device.

``stage_timer`` is a span that also times its stage on the host clock into
``StageTimes`` (an EMA and a total per name), the counterpart of the JAX
package's ``utils/profiling.py``. A stage time is host wall clock: a span
around asynchronous CUDA work ends when the work is queued, unless the stage
waits for it.
"""

from __future__ import annotations

import contextlib
import time
from typing import ContextManager, Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from heybuddy_tpu_torch.utils.strings import human_duration

__all__ = ["StageTimes", "GLOBAL_STAGE_TIMES", "span", "stage_timer"]


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

_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager[None]:
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs; otherwise one shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage_timer(name: str, times: Optional[StageTimes] = None) -> Iterator[None]:
    """Time a stage on the host clock and mark it as ``span(name)``."""
    times = times or GLOBAL_STAGE_TIMES
    start = time.perf_counter()
    with span(name):
        yield
    times.record(name, time.perf_counter() - start)
