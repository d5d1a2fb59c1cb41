"""The port's runtime against the JAX package's: reference ``.pt`` and
exported ``.onnx`` heads (scores as the npz head's), ``_load_any_model`` and
``predict`` on each, the model thread, and ``listen`` on a wav (detection
times as JAX's, the VAD gate skipping silence), as tests/test_runtime.py holds
JAX's runtime."""

import logging
import os
import re

import jax
import numpy as np
import pytest
import torch

import heybuddy_tpu.models.featurizer as jax_featurizer
import heybuddy_tpu.models.vad as jax_vad
from heybuddy_tpu.cli import _load_any_model as jax_load_any_model
from heybuddy_tpu.models.wakeword import WakeWordMLPModel as JaxMLP
from heybuddy_tpu.runtime.listen import run_listen as jax_run_listen
from heybuddy_tpu.runtime.onnx_model import WakeWordONNXModel as JaxONNXModel
from heybuddy_tpu_torch.cli import _load_any_model
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.convert import wakeword_params_to_numpy
from heybuddy_tpu_torch.models import featurizer, vad
from heybuddy_tpu_torch.models.formant import FormantSynthesizer
from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel, save_model
from heybuddy_tpu_torch.runtime import listen
from heybuddy_tpu_torch.runtime.listen import run_listen
from heybuddy_tpu_torch.runtime.model_thread import WakeWordModelThread
from heybuddy_tpu_torch.runtime.onnx_model import WakeWordONNXModel
from heybuddy_tpu_torch.utils.audio_io import write_wav
from heybuddy_tpu_torch.utils.log import logger

PT_ATOL = 1e-6  # the .pt head: the JAX import of the same file, on the same features
ONNX_ATOL = 1e-5  # the numpy ONNX runner against the torch head
# The listen head (seed 26, output layer x4) scores each 4096-sample chunk of
# the wav below; measured on the CPU, the nearest chunk score lies 0.0515
# from this threshold in the port and 0.0522 in JAX, whose scores lie up to
# 0.0197 from the port's (its CPU featurizer runs the bf16 banded path). The
# test holds every chunk of the port at least LISTEN_MARGIN from it.
LISTEN_THRESHOLD = 0.444
LISTEN_MARGIN = 0.02


@pytest.fixture(autouse=True)
def runtime_env(monkeypatch):
    monkeypatch.setenv("HEYBUDDY_LISTEN_SERIAL", "1")
    monkeypatch.delenv("HEYBUDDY_LISTEN_THREADS", raising=False)
    monkeypatch.delenv("HEYBUDDY_VAD_ONNX", raising=False)
    monkeypatch.delenv("HEYBUDDY_VAD_WEIGHTS", raising=False)
    monkeypatch.setattr(vad, "_GLOBAL_VAD", {})
    monkeypatch.setattr(jax_vad, "_GLOBAL_VAD", None)
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)


def _reference_state(model: WakeWordMLPModel) -> dict:
    """The head as the reference implementation's torch state dict (weights (out, in))."""
    tree = wakeword_params_to_numpy(model)
    state = {}

    def mlp(prefix, p):
        for part in ("hidden", "output", "gate"):
            if part in p:
                state[f"{prefix}.{part}.weight"] = torch.from_numpy(p[part]["w"].T.copy())
                state[f"{prefix}.{part}.bias"] = torch.from_numpy(p[part]["b"])

    def norm(prefix, p):
        state[f"{prefix}.weight"], state[f"{prefix}.bias"] = torch.from_numpy(p["g"]), torch.from_numpy(p["b"])

    norm("norm_in", tree["norm_in"])
    mlp("mlp_in", tree["mlp_in"])
    for group in ("half_layers", "layers"):
        for i, layer in enumerate(tree[group]):
            norm(f"{group}.{i}.0", layer["norm"])
            mlp(f"{group}.{i}.1", layer["mlp"])
    norm("norm_out", tree["norm_out"])
    mlp("mlp_out", tree["mlp_out"])
    return state


@pytest.fixture(scope="module")
def heads(tmp_path_factory):
    """One head as npz, reference .pt and exported .onnx."""
    root = tmp_path_factory.mktemp("heads")
    model = WakeWordMLPModel(num_layers=1, use_half_layers=True, seed=4, device="cpu")
    paths = {ext: str(root / f"head.{ext}") for ext in ("npz", "pt", "onnx")}
    save_model(model, paths["npz"])
    torch.save(_reference_state(model), paths["pt"])
    assert cli_main(["convert", paths["npz"], paths["onnx"]]) == 0
    return model, paths


def _features(n: int = 6) -> np.ndarray:
    return np.random.default_rng(5).normal(0, 1, (n, 16, 96)).astype(np.float32)


def test_pt_head_equals_the_npz_head_and_jax_import(heads):
    model, paths = heads
    got = WakeWordMLPModel.from_torch_file(paths["pt"], device="cpu")
    assert got.config() == model.config() and len(got.half_layers) == 16 and len(got.layers) == 1
    x = _features()
    scores = got.scores(x)
    np.testing.assert_array_equal(scores, model.scores(x))
    ref = np.asarray(JaxMLP.from_torch_file(paths["pt"])(x)).reshape(-1)
    np.testing.assert_allclose(scores, ref, rtol=0, atol=PT_ATOL)
    # no gating, no half layers: the options follow the keys present
    plain = WakeWordMLPModel(num_layers=0, use_gating=False, seed=2, device="cpu")
    pt = os.path.join(os.path.dirname(paths["pt"]), "plain.pt")
    torch.save(_reference_state(plain), pt)
    loaded = WakeWordMLPModel.from_torch_file(pt, device="cpu")
    assert not loaded.use_gating and not loaded.use_half_layers and loaded.num_layers == 0
    np.testing.assert_array_equal(loaded.scores(x), plain.scores(x))


def test_onnx_head_equals_the_npz_head_and_jax(heads):
    model, paths = heads
    onnx = WakeWordONNXModel(paths["onnx"], device="cpu")
    x = _features()
    scores = onnx.scores(x)
    assert onnx._batch_ok  # the batched graph walk was checked against one row
    np.testing.assert_allclose(scores, model.scores(x), rtol=0, atol=ONNX_ATOL)
    np.testing.assert_allclose(scores, np.asarray(JaxONNXModel(paths["onnx"])(x)).reshape(-1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(onnx.scores(x[:1]), scores[:1], rtol=0, atol=1e-6)  # the row walk


def test_load_any_model_and_predict_on_each_format(heads, tmp_path, capsys):
    model, paths = heads
    kinds = {"npz": WakeWordMLPModel, "pt": WakeWordMLPModel, "onnx": WakeWordONNXModel}
    audio = np.random.default_rng(2).normal(0, 0.1, (2, 32000)).astype(np.float32)
    want = model.predict(audio, return_scores=True)
    for ext, path in paths.items():
        loaded = _load_any_model(path, device="cpu")
        assert isinstance(loaded, kinds[ext]) and loaded.device == torch.device("cpu")
        assert type(jax_load_any_model(path)).__name__ == kinds[ext].__name__
        np.testing.assert_allclose(loaded.predict(audio, return_scores=True), want, rtol=0, atol=ONNX_ATOL)
    wav = str(tmp_path / "speech.wav")
    write_wav(wav, np.random.default_rng(3).normal(0, 0.1, 48000).astype(np.float32))
    outputs = []
    for path in paths.values():
        assert cli_main(["predict", path, wav, "--device", "cpu", "--threshold", "0.0"]) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] == outputs[2] and "Wake word detected" in outputs[0]


def test_default_device_is_the_card(heads, tmp_path):
    """No fallback: without a GPU every head format and listen raise on the default device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, paths = heads
    for path in paths.values():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _load_any_model(path)
    wav = str(tmp_path / "audio.wav")
    write_wav(wav, np.zeros(8000, np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_listen([paths["npz"]], input_wav=wav)


def test_model_thread_roundtrip(heads):
    model, paths = heads
    audio = np.random.default_rng(1).normal(0, 0.1, 23040).astype(np.float32)
    thread = WakeWordModelThread(paths["npz"], device="cpu")
    try:
        thread.put(audio)
        score, duration = thread.get(timeout=60)
        assert score == model.predict(audio, return_scores=True)[0] and duration > 0
        thread.put(audio * 0.5)
        thread.put(audio)  # a result of an earlier put is dropped by its sequence tag
        assert thread.get(timeout=60)[0] == score
    finally:
        thread.stop()
    broken = WakeWordModelThread(paths["npz"] + ".missing", device="cpu")
    broken._thread.join(timeout=30)
    with pytest.raises(RuntimeError, match="failed to load"):
        broken.get(timeout=1)


def test_listen_on_wav(heads, tmp_path):
    _, paths = heads
    wav = str(tmp_path / "audio.wav")
    write_wav(wav, np.random.default_rng(2).normal(0, 0.1, 64000).astype(np.float32))
    detections = run_listen([paths["npz"]], threshold=0.0, buffer_size=16000, input_wav=wav, max_chunks=3,
                            device="cpu")
    assert len(detections) == 3 and all(d.startswith("head @ ") for d in detections)
    with pytest.raises(RuntimeError, match="pyaudio"):
        next(listen._mic_chunks(1024))


def test_listen_vad_gate_skips_silence(heads, tmp_path):
    _, paths = heads
    clip = FormantSynthesizer().synthesize("hey buddy how are you", speaker=3)
    rng = np.random.default_rng(0)
    ambient = rng.normal(0, 3e-4, 32000).astype(np.float32)
    wav = str(tmp_path / "gated.wav")
    write_wav(wav, np.concatenate([ambient, clip, ambient]), 16000)
    silent_wav = str(tmp_path / "silent.wav")
    write_wav(silent_wav, rng.normal(0, 3e-4, 64000).astype(np.float32), 16000)
    assert run_listen([paths["npz"]], threshold=0.0, buffer_size=8000, input_wav=silent_wav, use_vad=True,
                      device="cpu") == []
    assert len(run_listen([paths["npz"]], threshold=0.0, buffer_size=8000, input_wav=wav, use_vad=True,
                          device="cpu")) >= 1


class _ChunkLog(logging.Handler):
    """The per-chunk debug records of ``run_listen``."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.scores, self.skipped = [], 0

    def emit(self, record):
        msg = record.getMessage()
        m = re.match(r"listen chunk \d+: scores \[(.*)\] in", msg)
        if m:
            self.scores.append(float(m.group(1)))
        elif re.match(r"listen chunk \d+: skipped", msg):
            self.skipped += 1


@pytest.fixture(scope="module")
def listen_case(tmp_path_factory):
    """Three phrases between silences, and the listen head."""
    root = tmp_path_factory.mktemp("listen")
    synth = FormantSynthesizer()
    parts = []
    for i, text in enumerate(["hey buddy", "what time is it", "hey buddy how are you"]):
        parts += [np.zeros(40000, np.float32), np.asarray(synth.synthesize(text, speaker=i + 1), np.float32)]
    wav = str(root / "phrases.wav")
    audio = np.concatenate(parts + [np.zeros(40000, np.float32)])
    write_wav(wav, audio)
    model = WakeWordMLPModel(num_layers=0, seed=26, device="cpu")
    with torch.no_grad():
        model.mlp_out.output.w.mul_(4.0)
        model.mlp_out.output.b.mul_(4.0)
    ckpt = str(root / "listen-head.npz")
    save_model(model, ckpt)
    return wav, ckpt, -(-len(audio) // 4096)


def _stamps(lines):
    return [line.split(" score=")[0] for line in lines]


@pytest.mark.parametrize("use_vad,consecutive", [(False, 1), (True, 2)])
def test_listen_detections_equal_jax(listen_case, use_vad, consecutive, monkeypatch, capsys):
    wav, ckpt, chunks = listen_case
    log = _ChunkLog()
    logger.addHandler(log)
    level = logger.level
    try:
        assert cli_main(["listen", ckpt, "--input-wav", wav, "--threshold", str(LISTEN_THRESHOLD),
                         "--consecutive", str(consecutive), "--device", "cpu", "--debug",
                         *(["--vad"] if use_vad else [])]) == 0
    finally:
        logger.removeHandler(log)
        logger.setLevel(level)
    got = capsys.readouterr().out.strip().splitlines()
    scores = np.array(log.scores)
    assert len(scores) + log.skipped == chunks and (log.skipped > 0) == use_vad
    assert np.abs(scores - LISTEN_THRESHOLD).min() >= LISTEN_MARGIN
    assert 0 < (scores >= LISTEN_THRESHOLD).sum() < len(scores)
    jax.config.update("jax_platforms", "cpu")
    want = jax_run_listen([ckpt], threshold=LISTEN_THRESHOLD, input_wav=wav, use_vad=use_vad,
                          consecutive=consecutive)
    capsys.readouterr()
    assert len(got) > 0 and _stamps(got) == _stamps(want)
    # threaded inference gives the same detections
    monkeypatch.setenv("HEYBUDDY_LISTEN_SERIAL", "0")
    monkeypatch.setenv("HEYBUDDY_LISTEN_THREADS", "1")
    monkeypatch.setattr(vad, "_GLOBAL_VAD", {})
    threaded = run_listen([ckpt], threshold=LISTEN_THRESHOLD, input_wav=wav, use_vad=use_vad,
                          consecutive=consecutive, device="cpu")
    assert _stamps(threaded) == _stamps(got)
