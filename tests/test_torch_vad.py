"""The port's VAD against the JAX package's: ``EnergyVAD``, ``VADGate`` and
``trim`` bit for bit on formant speech with an ambient lead-in, the gate's
hysteresis on speech (as tests/test_vad_gate.py holds JAX's), and
``SileroStyleVAD``'s seeded parameters, state carried across chunks, npz
weights and ``get_vad_model``'s resolution."""

import numpy as np
import pytest

import heybuddy_tpu.models.vad as jax_vad
from heybuddy_tpu.models.formant import FormantSynthesizer as JaxSynth
from heybuddy_tpu_torch.models import vad
from heybuddy_tpu_torch.models.formant import FormantSynthesizer
from torch_fixtures import silero_v4_graph

FRAME = 320  # 20 ms at 16 kHz, the runtime's VAD frame
SR = 16000
# SileroStyleVAD against JAX's on the CPU, state carried over the chunks
# below twice: the largest gap of the probability, h and c measured 3.5e-7
SILERO_ATOL = 1e-5
CHUNKS = (320, 480, 100, 4096)


@pytest.fixture(autouse=True)
def fresh_vads(monkeypatch):
    monkeypatch.setattr(vad, "_GLOBAL_VAD", {})
    monkeypatch.setattr(jax_vad, "_GLOBAL_VAD", None)
    monkeypatch.delenv("HEYBUDDY_VAD_ONNX", raising=False)
    monkeypatch.delenv("HEYBUDDY_VAD_WEIGHTS", raising=False)


@pytest.fixture(scope="module")
def speech():
    """Formant speech (bit-equal in both packages) after 1 s of ambient noise and before 1 s more."""
    clip = FormantSynthesizer().synthesize("hey buddy how are you", speaker=1)
    np.testing.assert_array_equal(clip, JaxSynth().synthesize("hey buddy how are you", speaker=1))
    rng = np.random.default_rng(1)
    lead, tail = (rng.normal(0, 3e-4, SR).astype(np.float32) for _ in range(2))
    return np.concatenate([lead, np.asarray(clip, np.float32), tail])


def _gate_states(gate, audio: np.ndarray, noise_frames: int = 50):
    rng = np.random.default_rng(0)
    for _ in range(noise_frames):  # settle the adaptive floor on ambient noise first
        gate.update(rng.normal(0, 3e-4, FRAME).astype(np.float32))
    return np.array([gate.update(audio[i : i + FRAME]) for i in range(0, len(audio) - FRAME + 1, FRAME)])


def test_energy_vad_and_gate_equal_jax(speech):
    port, ref = vad.EnergyVAD(), jax_vad.EnergyVAD()
    got = [port(speech[i : i + FRAME]) for i in range(0, len(speech) - FRAME + 1, FRAME)]
    want = [ref(speech[i : i + FRAME]) for i in range(0, len(speech) - FRAME + 1, FRAME)]
    assert got == want and max(got) == 1.0 and min(got) == 0.0
    assert port(np.zeros(0, np.float32)) == ref(np.zeros(0, np.float32)) == 0.0
    stereo = np.stack([speech[:FRAME], -0.5 * speech[:FRAME]])
    assert port(stereo) == ref(stereo)
    port.reset()
    assert port._noise_floor == 1e-4
    states = _gate_states(vad.VADGate(vad.EnergyVAD(), 0.5, 0.25), speech)
    want_states = _gate_states(jax_vad.VADGate(jax_vad.EnergyVAD(), 0.5, 0.25), speech)
    np.testing.assert_array_equal(states, want_states)
    # onset within 10 frames of the speech's start at 1 s; closed again at the end
    assert abs(int(np.argmax(states)) - SR // FRAME) <= 10 and not states[-1]
    opened = np.flatnonzero(states)
    assert states[opened[0] : opened[-1] + 1].all()  # held through the phrase's word gaps


def test_gate_passthrough_and_click_equal_jax():
    seq = [0.2, 0.7, 0.5, 0.39, 0.39, 0.45, 0.3, 0.3, 0.3, 0.1]
    port, ref = vad.VADGate(silent_frames_to_stop=3), jax_vad.VADGate(silent_frames_to_stop=3)
    out = [port.update(p) for p in seq]
    assert out == [ref.update(p) for p in seq] == [False, True, True, True, True, True, True, True, False, False]
    port.reset()
    assert not port.speaking and port.silent_frames == 0
    audio = np.random.default_rng(3).normal(0, 3e-4, 3 * SR).astype(np.float32)
    audio[SR : SR + FRAME] += (0.5 * np.sin(2 * np.pi * 1000 * np.arange(FRAME) / SR)).astype(np.float32)
    states = _gate_states(vad.VADGate(vad.EnergyVAD(), 0.5, 0.25), audio)
    np.testing.assert_array_equal(states, _gate_states(jax_vad.VADGate(jax_vad.EnergyVAD(), 0.5, 0.25), audio))
    assert states.sum() <= 9  # a one-frame click: open at most for itself and the 8-frame hold


@pytest.mark.parametrize("pad_s", [None, 0.1, (0.05, 0.2)])
def test_trim_equals_jax(speech, pad_s):
    got = vad.EnergyVAD().trim(speech, pad_s=pad_s)
    want = jax_vad.EnergyVAD().trim(speech, pad_s=pad_s)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    batch = np.stack([speech, 0.5 * speech])
    cut = vad.EnergyVAD().trim(batch, threshold=0.3, pad_s=pad_s)
    np.testing.assert_array_equal(cut, jax_vad.EnergyVAD().trim(batch, threshold=0.3, pad_s=pad_s))
    # the ambient lead-in and tail (the first 2000 samples kept) are cut
    assert cut.shape[1] < len(speech) - SR


def _jax_state(model):
    return np.asarray(model.h), np.asarray(model.c)


def test_silero_style_vad_equals_jax_with_state_carried(speech):
    port = vad.SileroStyleVAD(seed=3, device="cpu")
    ref = jax_vad.SileroStyleVAD(seed=3)
    params = port.params_numpy()
    assert sorted(params) == sorted(ref.params)
    for name, value in params.items():
        np.testing.assert_array_equal(value, np.asarray(ref.params[name]))  # numpy draws: bit-equal
    start = SR - 600  # across the lead-in's end into speech
    gaps = []
    for n in CHUNKS * 2:
        chunk = speech[start : start + n]
        start += n
        p, q = port(chunk), ref(chunk)
        h, c = _jax_state(ref)
        gaps.append(max(abs(p - q), np.abs(port.h.numpy() - h).max(), np.abs(port.c.numpy() - c).max()))
    assert max(gaps) <= SILERO_ATOL, gaps
    assert np.abs(port.h.numpy()).max() > 0.01  # the state moved
    port.reset()
    ref.reset()
    assert not port.h.any() and not port.c.any()
    assert abs(port(speech[:FRAME]) - ref(speech[:FRAME])) <= SILERO_ATOL
    # trim over the model's own frames
    np.testing.assert_array_equal(vad.SileroStyleVAD(seed=3, device="cpu").trim(speech, threshold=0.5),
                                  jax_vad.SileroStyleVAD(seed=3).trim(speech, threshold=0.5))


def test_silero_weights_load_in_both_packages(tmp_path, monkeypatch):
    path = str(tmp_path / "vad.npz")
    np.savez(path, **vad.SileroStyleVAD(seed=9, device="cpu").params_numpy())
    monkeypatch.setenv("HEYBUDDY_VAD_WEIGHTS", path)
    port = vad.get_vad_model(device="cpu")
    assert isinstance(port, vad.SileroStyleVAD) and vad.get_vad_model(device="cpu") is port
    ref = jax_vad.get_vad_model()
    assert isinstance(ref, jax_vad.SileroStyleVAD)
    for name, value in port.params_numpy().items():
        np.testing.assert_array_equal(value, np.asarray(ref.params[name]))
    chunk = np.random.default_rng(4).normal(0, 0.1, 700).astype(np.float32)
    assert abs(port(chunk) - ref(chunk)) <= SILERO_ATOL


def test_get_vad_model_resolution(tmp_path, monkeypatch):
    assert isinstance(vad.get_vad_model(device="cpu"), vad.EnergyVAD)
    missing = str(tmp_path / "missing.onnx")
    monkeypatch.setenv("HEYBUDDY_VAD_ONNX", missing)  # no such file: the next backend, as in JAX
    monkeypatch.setattr(vad, "_GLOBAL_VAD", {})
    assert isinstance(vad.get_vad_model(device="cpu"), vad.EnergyVAD)
    onnx, _ = silero_v4_graph(str(tmp_path / "silero.onnx"))
    monkeypatch.setenv("HEYBUDDY_VAD_ONNX", onnx)
    monkeypatch.setattr(vad, "_GLOBAL_VAD", {})
    onnx_vad = vad.get_vad_model(device="cpu")
    assert isinstance(onnx_vad, vad.SileroOnnxVAD) and onnx_vad.device.type == "cpu"
