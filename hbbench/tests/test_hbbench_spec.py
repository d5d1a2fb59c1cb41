"""BENCHMARK.json against the contract, and every cell's files found by name."""

from __future__ import annotations

import json
import os

import pytest

from hbbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hbbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.cell(BENCH, name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    kind = spec.kind(traffic["kind"])
    assert all(hasattr(kind, phase) for phase in ("setup", "window", "check"))
    assert config["name"] == cell["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert os.path.exists(os.path.join(spec.ROOT, entry["file"]))
    assert entry["reduced"] == config["reduced"]
    assert cell["chips"] == 1
    assert cell["limits"], "a cell compares at least one number"
    e2e = spec.metrics_for(BENCH, name, traced=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert spec.metrics_for(BENCH, name, traced=True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(spec.reader(metric).read)


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert spec.NAME.match(name), name
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock") and 0.01 <= m["bound"] <= 0.25
    moved = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moved and "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200


def test_a_bad_name_is_refused():
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")
