"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's root,
``configs/<name>.json``, ``traffic/<name>.json`` (its ``kind`` names the
generator ``traffic/<kind>.py``), ``workloads/<cell>.json`` (the limits of
the cell's correctness check) and ``metrics/<metric>.py``. A cell's
configuration, traffic mix and chips are its entry in ``BENCHMARK.json``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def checked(name: str) -> str:
    """``name`` if it is a valid benchmark name, else ValueError (it becomes a file name)."""
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The workload entry of ``name`` with the limits of its file under ``workloads/``."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    limits = _load_json(os.path.join(HERE, "workloads", checked(name) + ".json"))["limits"]
    return dict(entries[0], limits=limits)


def config(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(HERE, "configs", checked(name) + ".json"))


def traffic(name: str) -> Dict[str, Any]:
    return _load_json(os.path.join(HERE, "traffic", checked(name) + ".json"))


def kind(name: str) -> ModuleType:
    """The generator module of a traffic kind."""
    return importlib.import_module(f"hbbench.traffic.{checked(name)}")


def metrics_for(bench: Dict[str, Any], cell_name: str, traced: bool) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (``traced`` false) or per-layer metrics."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``, loaded by its path (metric names hold dots)."""
    path = os.path.join(HERE, "metrics", checked(metric) + ".py")
    module_spec = importlib.util.spec_from_file_location(f"hbbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module
