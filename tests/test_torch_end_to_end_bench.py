"""The port's end-to-end bench against the JAX package's script.

The script (``scripts/end_to_end_bench.py``, its ``jax`` imports inside its
functions) is loaded by path; with every stage's rate fixed, both ``main``s
must give the same JSON (the port adds ``device``). A tiny CPU run of the
port checks the stages run and the key set.
"""

import importlib.util
import json
import os
import tempfile

import jax
import pytest

from heybuddy_tpu_torch.tools import end_to_end_bench as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATES = {"tts": 31.25, "tts_device": 455.5, "pipeline": 27.4, "pipeline_device": 612.3, "featurize": 987654.3,
         "train": 181.7}


@pytest.fixture()
def script():
    spec = importlib.util.spec_from_file_location("jax_end_to_end_bench", os.path.join(ROOT, "scripts",
                                                                                         "end_to_end_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fixed(monkeypatch, module, with_tmpdir: bool) -> None:
    """Every stage of ``module`` returns its rate in ``RATES``."""
    monkeypatch.setattr(module, "time_tts", lambda n, seed, backend="formant", batch_size=8, **kw: (
        RATES["tts"] if backend == "formant" else RATES["tts_device"]))

    if with_tmpdir:
        def pipeline(n, seed, tmpdir, backend="formant", warm=8):
            return RATES["pipeline"] if backend == "formant" else RATES["pipeline_device"]
    else:
        def pipeline(n, seed, backend="formant", warm=8, **kw):
            return RATES["pipeline"] if backend == "formant" else RATES["pipeline_device"]
    monkeypatch.setattr(module, "time_pipeline", pipeline)
    monkeypatch.setattr(module, "time_featurize", lambda *a, **kw: RATES["featurize"])
    monkeypatch.setattr(module, "time_training", lambda *a, **kw: RATES["train"])


def test_ref_scale_equals_the_scripts(script):
    assert port.REF_SCALE == script.REF_SCALE


def test_json_equals_the_scripts_with_the_same_rates(script, tmp_path, monkeypatch):
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a, **kw: None)  # the script's compilation cache
    _fixed(monkeypatch, script, with_tmpdir=True)
    _fixed(monkeypatch, port, with_tmpdir=False)
    monkeypatch.setattr("sys.argv", ["end_to_end_bench.py", "--json", str(tmp_path / "jax.json")])
    script.main()
    assert port.main(["--json", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got.pop("device") == "cpu"
    assert set(got) == set(ref)
    del got["probe_wall_s"], ref["probe_wall_s"]
    assert got == ref
    assert got["extrapolated"] == port.extrapolate(got)


def test_tiny_cpu_run_gives_the_scripts_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_DATASET_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("HEYBUDDY_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("HEYBUDDY_FUSED_TTS_BATCH", "8")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for name, value in (("TTS_DEVICE_BATCH", 8), ("PIPELINE_DEVICE_CLIPS", 8), ("PIPELINE_DEVICE_WARM", 8),
                        ("FEATURIZE_BATCH", 4), ("FEATURIZE_ITERS", 1)):
        monkeypatch.setattr(port, name, value)
    out = tmp_path / "e2e.json"
    md = tmp_path / "e2e.md"
    assert port.main(["--clips", "8", "--train-steps", "3", "--device", "cpu", "--json", str(out),
                      "--md", str(md)]) == 0
    got = json.loads(out.read_text())
    keys = {"tts_clips_per_s", "tts_device_clips_per_s", "pipeline_clips_per_s", "pipeline_device_clips_per_s",
            "featurize_clips_per_s", "train_steps_per_s", "probe_wall_s", "extrapolated"}
    assert set(got) == keys | {"device"}
    assert set(got["extrapolated"]) == {"total_clips", "pipeline_clips_per_s", "feature_generation_s",
                                        "training_s", "end_to_end_s", "end_to_end_h"}
    for key in keys - {"probe_wall_s", "extrapolated"}:
        assert got[key] > 0, key
    assert "TPU" not in md.read_text() and "cpu" in md.read_text()
