"""
Run one cell of the benchmark and print its result as the last line of
standard output.

    python -m hbbench.run --workload gen-fused.v8-mlp --seed 7 --seconds 20 --trace 0

Needs as many CUDA devices as the cell asks for and exits with 2 (and no
result) without them. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` runs the window under ``torch.profiler`` and reports its
per-layer metrics with the device's busy time. The numbers compared with the
reference are the last lines on standard error and the ``checks`` key, last
in the result line. ``run_cell(..., control=True)`` also computes the
lower-precision control's numbers beside the program's, for setting the
limits.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict, List, Optional, Sequence  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hbbench import spec  # noqa: E402
from hbbench.tracing import Recorder, breakdown  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "heybuddy_tpu")


class Context:
    """What a traffic kind's ``setup`` / ``window`` / ``check`` share, and what the metric readers read."""

    def __init__(self, cell: Dict[str, Any], config: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                 seconds: float, traced: bool, control: bool, device: torch.device, workdir: str) -> None:
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.traced, self.control = seed, seconds, traced, control
        self.device, self.workdir = device, workdir
        words = np.random.SeedSequence(seed).generate_state(8)
        self.seeds = [int(w) for w in words]  # independent 32-bit seeds for each use
        self.recorder = Recorder(device)
        self.results: Dict[str, Any] = {}  # end-to-end values and window counts
        self.checks: Dict[str, Dict[str, float]] = {}
        self.controls: Dict[str, float] = {}
        self.diagnostics: Dict[str, Any] = {}  # printed on standard error
        self.extra: Dict[str, Any] = {}  # a kind's state between its phases


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
             control: bool = False, bench: Optional[Dict[str, Any]] = None,
             overrides: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict[str, Any]:
    """One run of cell ``name`` on ``device``; returns the result object (without
    the import check). ``overrides`` replaces keys of the configuration and the
    traffic mix (``{"config": {...}, "traffic": {...}}``): the tests' small sizes."""
    bench = bench or spec.benchmark()
    cell = spec.cell(bench, name)
    config = dict(spec.config(cell["config"]), **(overrides or {}).get("config", {}))
    traffic = dict(spec.traffic(cell["traffic"]), **(overrides or {}).get("traffic", {}))
    kind = spec.kind(traffic["kind"])
    os.environ["HEYBUDDY_OFFLINE"] = "1"  # nothing is fetched
    workdir = tempfile.mkdtemp(prefix="hbbench-")
    ctx = Context(cell, config, traffic, seed, seconds, traced, control, device, workdir)
    try:
        kind.setup(ctx)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - PROCESS_START
        kind.window(ctx)
        ctx.recorder.reduce()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        ctx.recorder.close()
        gc.collect()
        kind.check(ctx)
    finally:
        ctx.recorder.close()
        shutil.rmtree(workdir, ignore_errors=True)
    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        for m in spec.metrics_for(bench, name, traced=True):
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(ctx.results, setup_s=setup_s)
        for m in spec.metrics_for(bench, name, traced=False):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev_info: Dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    if device.type == "cuda":
        dev_info["power"] = power_limit()
    if traced and ctx.recorder.trace:
        dev_info["busy_s"] = ctx.recorder.trace["busy_s"]
        dev_info["window_s"] = ctx.recorder.trace["window_s"]
    result: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in ctx.checks.values()) and bool(ctx.checks),
        "attempted": int(ctx.results.get("attempted", 0)),
        "failed": int(ctx.results.get("failed", 0)),
        "metrics": metrics,
        "device": dev_info,
    }
    if traced:
        result["breakdown"] = breakdown(ctx.recorder.trace)
    result["diagnostics"] = ctx.diagnostics
    if control:
        result["controls"] = ctx.controls
    result["checks"] = ctx.checks
    return result


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    bench = spec.benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hbbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      bench=bench)
    found = forbidden_modules()
    if found:
        print(f"hbbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value in result.pop("diagnostics").items():
        print(f"diagnostic {name} = {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
