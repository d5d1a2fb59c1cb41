"""
The program's own spans in a trace, and the per-layer metrics that read them.

The port marks each layer's work with ``heybuddy_tpu_torch.utils.profiling.span``
ranges, named ``<module>/<what>`` (``features/batch``, ``trainer/step``,
``listen/score``, ...), which appear in a ``torch.profiler`` trace as CPU user
annotations. ``reduce`` turns the events of a trace into ``program_spans``:
for each range name the host seconds of each range (``host_s``), its self
seconds (its duration less its child program ranges, ``self_s``), and the
launches and device seconds of the kernels and copies put down to it. A
device operation is put down to the innermost program range, on the thread
of the runtime call that launched it, that holds that call's host time (the
profiler's correlation id pairs the call with the operation; an operation
with no such call counts as ``unattributed_launches``). ``idle_by_program_span`` names each idle gap of the
device by the innermost program range the host was in when the gap began,
the rule ``tracing.summary`` applies to the benchmark's own spans;
``idle_in_program_span`` splits every idle second by the innermost program
range open while it passed (a long gap that began as the host finished a
copy is mostly the host's next work).

The keys are additions to ``tracing.summary``'s, which keep their values.
``python3 -m hbbench.program_spans --workload <cell> --seed <n> --seconds <s>``
runs one traced run of a cell with them: its result line holds the metrics
of ``METRICS`` beside the cell's others and ``breakdown.idle_gaps_program``.
``METRICS`` are ``per_layer`` entries of the form ``BENCHMARK.json`` takes;
their readers are ``metrics/<name>.py``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from hbbench import run, spec, tracing

OUTSIDE = "outside any span"

METRICS: List[Dict[str, Any]] = [
    {"name": "drain_wait_ms.gen", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "data/features drain", "moves": "gen_clips_per_s", "workloads": ["gen-fused.v8-mlp"]},
    {"name": "render_launches.gen", "unit": "launches", "better": "lower", "source": "program_span",
     "layer": "models/formant_device render", "moves": "gen_clips_per_s", "workloads": ["gen-fused.v8-mlp"]},
    {"name": "step_host_ms_p50.train", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "training/trainer step", "moves": "train_eval_rows_per_s", "workloads": ["train.v8-transformer"]},
    {"name": "head_ms_p50.listen", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "models/wakeword head", "moves": "listen_chunk_ms_p95", "workloads": ["listen.v8-mlp"]},
    {"name": "score_self_ms_p50.listen", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "runtime/listen -> wakeword _predict_scores", "moves": "listen_chunk_ms_p95",
     "workloads": ["listen.v8-mlp"]},
]


def _is_range(event: Any) -> bool:
    return event.device_type == torch.autograd.DeviceType.CPU and getattr(event, "is_user_annotation", False) \
        and not event.name.startswith(tracing.PREFIX)


def _is_launch(event: Any) -> bool:
    """A CUDA API call on the host (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``...)."""
    return event.device_type == torch.autograd.DeviceType.CPU and not getattr(event, "is_user_annotation", False) \
        and event.name.startswith("cu")


def _gaps(kernels: Sequence[Tuple[str, float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The device's idle intervals in [lo, hi] between the union of ``kernels``."""
    gaps: List[Tuple[float, float]] = []
    cursor = lo
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi))
    return gaps


def reduce(events: Sequence[Any], trace: Dict[str, Any]) -> Dict[str, Any]:
    """``program_spans``, ``idle_by_program_span`` and ``idle_in_program_span``
    of a trace's events; ``trace`` is ``tracing.summary`` of the same events."""
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end, getattr(e, "thread", 0))
                     for e in events if _is_range(e)), key=lambda r: (r[1], -r[2]))
    device = [e for e in events if tracing._is_device(e)]
    launches = {e.id: (e.time_range.start, getattr(e, "thread", 0)) for e in events if _is_launch(e)}
    window = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
              and e.name == tracing.PREFIX + "window"]
    kernels = trace["kernels"]
    lo = window[0].time_range.start if window else (kernels[0][1] if kernels else 0.0)
    hi = window[0].time_range.end if window else (kernels[-1][2] if kernels else 0.0)

    # one sweep over time: at each instant range closings (0), openings (1), then probes
    # (2), so that a range holds [start, end); a probe is a device operation's launch (on
    # its thread) or an idle gap's start (any thread)
    points: List[Tuple[float, int, int, Any]] = []
    for i, (_, start, end, _) in enumerate(ranges):
        if end > start:
            points += [(end, 0, i, None), (start, 1, i, None)]
    unattributed = 0
    for k, e in enumerate(device):
        at = launches.get(e.id)
        if at is None:
            unattributed += 1
        else:
            points.append((at[0], 2, k, ("launch", at[1])))
    gaps = _gaps(kernels, lo, hi)
    for g, (start, _) in enumerate(gaps):
        points.append((start, 2, g, ("gap", None)))
    points.sort(key=lambda p: (p[0], p[1]))

    stacks: Dict[Any, List[int]] = collections.defaultdict(list)
    child_s = [0.0] * len(ranges)
    launched = collections.Counter()
    device_s: Dict[str, float] = collections.defaultdict(float)
    idle: Dict[str, float] = collections.defaultdict(float)
    host = [(lo, OUTSIDE)]  # (from when, the innermost program range open on any thread)

    def innermost() -> str:
        open_ = [ranges[s[-1]] for s in stacks.values() if s]
        return min(open_, key=lambda r: r[2] - r[1])[0] if open_ else OUTSIDE

    for t, kind, i, probe in points:
        if kind == 0:
            stacks[ranges[i][3]].remove(i)
            host.append((t, innermost()))
        elif kind == 1:
            stack = stacks[ranges[i][3]]
            if stack:
                child_s[stack[-1]] += (ranges[i][2] - ranges[i][1]) / 1e6
            stack.append(i)
            host.append((t, innermost()))
        elif probe[0] == "launch":
            # on its own thread's innermost range; a thread that opened none (no thread to
            # match) takes any thread's
            stack = stacks.get(probe[1])
            name = innermost() if stack is None else ranges[stack[-1]][0] if stack else OUTSIDE
            launched[name] += 1
            device_s[name] += (device[i].time_range.end - device[i].time_range.start) / 1e6
        else:
            idle[innermost()] += (gaps[i][1] - gaps[i][0]) / 1e6

    # every idle second, named by the innermost range open while it passed
    during: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for start, end in gaps:
        while j + 1 < len(host) and host[j + 1][0] <= start:
            j += 1
        k, t = j, start
        while t < end:
            until = min(end, host[k + 1][0]) if k + 1 < len(host) else end
            during[host[k][1]] += (until - t) / 1e6
            t, k = until, k + 1

    spans: Dict[str, Dict[str, Any]] = {}
    for i, (name, start, end, _) in enumerate(ranges):
        entry = spans.setdefault(name, {"host_s": [], "self_s": [], "launches": 0, "device_s": 0.0})
        entry["host_s"].append((end - start) / 1e6)
        entry["self_s"].append((end - start) / 1e6 - child_s[i])
    for name, count in launched.items():
        entry = spans.setdefault(name, {"host_s": [], "self_s": [], "launches": 0, "device_s": 0.0})
        entry["launches"], entry["device_s"] = count, device_s[name]
    if unattributed:
        spans.setdefault(OUTSIDE, {"host_s": [], "self_s": [], "launches": 0, "device_s": 0.0})
        spans[OUTSIDE]["unattributed_launches"] = unattributed
    return {"program_spans": spans, "idle_by_program_span": dict(idle), "idle_in_program_span": dict(during)}


def summary(events: Sequence[Any], window_s: float) -> Dict[str, Any]:
    """``tracing.summary`` with the program's spans added."""
    trace = _ORIGINAL["summary"](events, window_s)
    trace.update(reduce(events, trace))
    return trace


def breakdown(trace: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """``tracing.breakdown`` with ``idle_gaps_program`` (gaps by the range where
    each began) and ``idle_time_program`` (idle seconds by the range open while
    they passed) beside ``idle_gaps``."""
    out = _ORIGINAL["breakdown"](trace)
    if out is not None and "idle_by_program_span" in trace:
        for key, idle in (("idle_gaps_program", "idle_by_program_span"), ("idle_time_program", "idle_in_program_span")):
            top = sorted(trace[idle].items(), key=lambda kv: -kv[1])[:10]
            out[key] = [[name[:120], seconds] for name, seconds in top]
    return out


_ORIGINAL = {"summary": tracing.summary, "breakdown": tracing.breakdown}


@contextlib.contextmanager
def added() -> Iterator[List[Dict[str, Any]]]:
    """Within the block, a cell's traced run reduces its trace with the
    program's spans too; yields the list of the traces reduced."""
    traces: List[Dict[str, Any]] = []

    def kept(events: Sequence[Any], window_s: float) -> Dict[str, Any]:
        traces.append(summary(events, window_s))
        return traces[-1]

    saved = tracing.summary, run.breakdown
    tracing.summary, run.breakdown = kept, breakdown
    try:
        yield traces
    finally:
        tracing.summary, run.breakdown = saved


def spans(ctx: Any, name: str) -> Optional[Dict[str, Any]]:
    """The ``program_spans`` entry of ``name`` in the cell's trace; None where it has none."""
    trace = ctx.recorder.trace
    entry = (trace or {}).get("program_spans", {}).get(name)
    return entry if entry and entry["host_s"] else None


def median_ms(values: Sequence[float]) -> float:
    return 1e3 * statistics.median(values)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = run.parse_args(argv)
    bench = spec.benchmark()
    known = {m["name"] for m in bench["per_layer"]}
    bench = dict(bench, per_layer=bench["per_layer"] + [m for m in METRICS if m["name"] not in known])
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hbbench: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    with added() as traces:
        result = run.run_cell(args.workload, args.seed, args.seconds, True, torch.device("cuda", 0), bench=bench)
    for name, entry in sorted(traces[-1]["program_spans"].items() if traces else ()):
        host_ms, self_ms = (1e3 * statistics.fmean(entry[k] or [0]) for k in ("host_s", "self_s"))
        print(f"span {name}: {len(entry['host_s'])} ranges, host ms mean {host_ms:.4f}, self {self_ms:.4f}, "
              f"{entry['launches']} launches, {entry['device_s']:.6f} device s, "
              f"{entry.get('unattributed_launches', 0)} unattributed", file=sys.stderr)
    for name, value in result.pop("diagnostics").items():
        print(f"diagnostic {name} = {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
