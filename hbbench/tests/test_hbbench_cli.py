"""The entry point refuses to run without a card, and from a directory that
holds only the benchmark, printing no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import torch

from hbbench import run, spec


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        return  # the refusal is for a machine without a card
    rc = run.main(["--workload", "listen.v8-mlp", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "hbbench"), tmp_path / "hbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "hbbench.run", "--workload", "listen.v8-mlp", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
