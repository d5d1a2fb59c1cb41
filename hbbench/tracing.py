"""Spans, counters and the device trace, all taken from the benchmark's side.

``Recorder.wrap`` puts a span around a call into one layer of the program
(a module function or a method, restored by ``close``): the host clock of
every call, and under the profiler a ``record_function`` range named
``hbbench/<span>``. ``start_trace`` / ``stop_trace`` bracket the traced part
of the window with ``torch.profiler`` (CPU and CUDA activity); ``summary``
reduces the trace to the device's busy time (the union of its kernels and
copies), kernel time by name, and the idle gaps named by the innermost span
the host was in when each gap began.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "hbbench/"


class Recorder:
    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.values: Dict[str, List[float]] = collections.defaultdict(list)
        self._restore: List[Tuple[Any, str, Any]] = []
        self.profiler: Optional[Any] = None
        self.trace: Optional[Dict[str, Any]] = None
        self.stop_seconds = 0.0  # host time spent stopping the profiler, inside the window
        self._trace_t0 = 0.0
        self._stopped: Optional[Tuple[Any, float]] = None

    @property
    def tracing(self) -> bool:
        return self.profiler is not None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.profiler is not None:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, owner: Any, attr: str, span: Optional[str] = None,
             around: Optional[Callable[..., Any]] = None) -> None:
        """Replace ``owner.attr`` by a wrapper that times each call under
        ``span`` and, with ``around(call, *args, **kwargs)``, lets the caller
        see or record the call (``call()`` runs the original)."""
        original = getattr(owner, attr)
        recorder = self

        @functools.wraps(original)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            def call() -> Any:
                return original(*args, **kwargs)

            ctx = recorder.span(span) if span else contextlib.nullcontext()
            with ctx:
                return around(call, *args, **kwargs) if around else call()

        self._restore.append((owner, attr, owner.__dict__.get(attr, _MISSING) if hasattr(owner, "__dict__")
                              else _MISSING))
        setattr(owner, attr, wrapper)

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.stop()
            self.profiler = None
        while self._restore:
            owner, attr, value = self._restore.pop()
            if value is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, value)

    def start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.profiler = profile(activities=activities)
        self.profiler.start()
        self._window = torch.profiler.record_function(PREFIX + "window")
        self._window.__enter__()
        self._trace_t0 = time.perf_counter()

    def stop_trace(self) -> None:
        """End the traced part (after a synchronise); ``reduce`` reads it later,
        outside the window. The time the profiler takes to stop is kept in
        ``stop_seconds`` so that the window can leave it out."""
        if self.profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_stop = time.perf_counter()
        window_s = t_stop - self._trace_t0
        self._window.__exit__(None, None, None)
        prof, self.profiler = self.profiler, None
        prof.stop()
        self._stopped = (prof, window_s)
        self.stop_seconds += time.perf_counter() - t_stop

    def reduce(self) -> None:
        """Reduce the stopped trace to ``self.trace``."""
        self.stop_trace()
        if self._stopped is not None:
            prof, window_s = self._stopped
            self._stopped = None
            self.trace = summary(prof.events(), window_s)


class _Missing:
    pass


_MISSING = _Missing()


def _is_device(event: Any) -> bool:
    return event.device_type == torch.autograd.DeviceType.CUDA and not getattr(event, "is_user_annotation", False) \
        and not event.name.startswith(PREFIX)


def summary(events: Any, window_s: float) -> Dict[str, Any]:
    """busy_s, window_s, kernels [(name, start_us, end_us)], kernel time by name, and idle gaps by host span."""
    kernels = sorted((e.name, e.time_range.start, e.time_range.end) for e in events if _is_device(e))
    kernels.sort(key=lambda k: k[1])
    host = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(PREFIX)]
    window = [h for h in host if h[0] == "window"]
    spans = [h for h in host if h[0] != "window"]
    lo = window[0][1] if window else (kernels[0][1] if kernels else 0.0)
    hi = window[0][2] if window else (kernels[-1][2] if kernels else 0.0)
    merged: List[List[float]] = []
    for _, start, end in kernels:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_us = sum(e - s for s, e in merged)
    gaps: List[Tuple[float, float]] = []
    cursor = lo
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    by_span: collections.Counter = collections.Counter()
    for s, e in gaps:
        inside = [h for h in spans if h[1] <= s < h[2]]
        name = min(inside, key=lambda h: h[2] - h[1])[0] if inside else "outside any span"
        by_span[name] += (e - s) / 1e6
    by_kernel: collections.Counter = collections.Counter()
    for name, s, e in kernels:
        by_kernel[name] += (e - s) / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "kernels": kernels,
        "kernel_seconds": dict(by_kernel),
        "idle_by_span": dict(by_span),
    }


def kernel_seconds(trace: Optional[Dict[str, Any]], pattern: str) -> Tuple[float, int]:
    """Total device seconds and launches of the kernels whose name holds ``pattern``."""
    if not trace:
        return 0.0, 0
    hits = [(s, e) for name, s, e in trace["kernels"] if pattern in name]
    return sum(e - s for s, e in hits) / 1e6, len(hits)


def breakdown(trace: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if not trace:
        return None

    def top(counter: Dict[str, float]) -> List[List[Any]]:
        return [[name[:120], seconds] for name, seconds in
                sorted(counter.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(trace["kernel_seconds"]), "idle_gaps": top(trace["idle_by_span"])}


def idle_percent(trace: Optional[Dict[str, Any]]) -> Optional[float]:
    """100 x (1 - busy / window) of a trace that holds device work; None otherwise."""
    if not trace or not trace["kernels"] or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
