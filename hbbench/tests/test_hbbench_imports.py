"""Nothing the benchmark runs loads JAX or the JAX package: a cell's set-up,
window and check run on the CPU in a fresh process, then every loaded
module's top-level name is compared whole (the port's name begins with the
JAX package's, so a prefix test would flag it)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

from hbbench import run, spec

SCRIPT = """
import json, sys, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from hbbench import run
from small import SMALL
run.run_cell("listen.v8-mlp", 3, 0.3, False, torch.device("cpu"), overrides=SMALL["listen.v8-mlp"])
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"forbidden": run.forbidden_modules(), "tops": tops}}))
"""


def test_a_cell_loads_no_jax():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, HEYBUDDY_OFFLINE="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=spec.ROOT, tests=here)], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found["forbidden"] == []
    assert "heybuddy_tpu_torch" in found["tops"]
    assert not {"jax", "jaxlib", "flax", "heybuddy_tpu"} & set(found["tops"])


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "heybuddy_tpu_torch_like", types.ModuleType("heybuddy_tpu_torch_like"))
    assert "heybuddy_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "heybuddy_tpu.models", types.ModuleType("heybuddy_tpu.models"))
    assert run.forbidden_modules() == ["heybuddy_tpu.models"]
