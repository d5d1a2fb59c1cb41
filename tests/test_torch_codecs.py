"""The port's codec, loudness and profiling utilities against the JAX package's.

The loudness functions are numpy and scipy on both sides, so they are held
bit for bit. There is no ffmpeg on the test machine: the error path is held
to JAX's message, and the round trips skip as ``tests/test_codecs.py``
skips them.
"""

import numpy as np
import pytest
import torch

from heybuddy_tpu.utils import codecs as jax_codecs
from heybuddy_tpu.utils.audio_io import audio_to_bct_array as jax_audio_to_bct_array
from heybuddy_tpu_torch.utils import codecs, profiling
from heybuddy_tpu_torch.utils.audio_io import audio_to_bct_array


def _signals():
    rng = np.random.default_rng(0)
    t = np.arange(16000 * 2) / 16000.0
    speechy = (0.4 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)).astype(np.float32)
    return {
        "sine": (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
        "gated": speechy,
        "noise": rng.normal(0.0, 0.1, t.shape).astype(np.float32),
        "stereo": rng.normal(0.0, 0.05, (2, 24000)).astype(np.float32),
        "short": rng.normal(0.0, 0.2, 3000).astype(np.float32),
        "silent": np.zeros(16000, np.float32),
    }


@pytest.mark.parametrize("rate", [16000, 22050, 48000])
def test_k_weighting_coefficients_bit_equal_jax(rate):
    for got, want in zip(codecs._k_weighting_coefficients(rate), jax_codecs._k_weighting_coefficients(rate)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(_signals()))
def test_loudness_bit_equal_jax(name):
    audio = _signals()[name]
    assert codecs.measure_loudness(audio) == jax_codecs.measure_loudness(audio)
    for target in (-23.0, -14.0):
        got = codecs.normalize_loudness(audio, target_lufs=target)
        want = jax_codecs.normalize_loudness(audio, target_lufs=target)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def test_decode_without_ffmpeg_raises_jax_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg on this PATH
    assert not codecs.ffmpeg_available() and not jax_codecs.ffmpeg_available()
    path = str(tmp_path / "clip.mp3")
    with open(path, "wb") as f:
        f.write(b"\xff\xfb\x90\x00" * 100)
    messages = []
    for fn in (codecs.decode_audio, jax_codecs.decode_audio):
        with pytest.raises(RuntimeError, match="ffmpeg") as err:
            fn(path)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    # the universal loader sends non-WAV paths to the codec layer, as JAX's does
    for loader in (audio_to_bct_array, jax_audio_to_bct_array):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            loader(path, sample_rate=16000)
    for fn in (codecs.compress_roundtrip, jax_codecs.compress_roundtrip):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            fn(np.zeros(1600, np.float32))
    with pytest.raises(RuntimeError, match="ffmpeg"):
        codecs.encode_audio(str(tmp_path / "out.mp3"), np.zeros(1600, np.float32))


def test_wav_decode_and_encode_match_jax(tmp_path):
    audio = _signals()["sine"][:8000]
    paths = [str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")]
    codecs.encode_audio(paths[0], audio, 16000)
    jax_codecs.encode_audio(paths[1], audio, 16000)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    for rate in (None, 8000):
        got, got_rate = codecs.decode_audio(paths[0], sample_rate=rate)
        want, want_rate = jax_codecs.decode_audio(paths[1], sample_rate=rate)
        assert got_rate == want_rate and np.array_equal(got, want)
    with open(paths[0], "rb") as f:
        raw = f.read()
    got, _ = codecs.decode_audio(raw)
    want, _ = jax_codecs.decode_audio(raw)
    assert np.array_equal(got, want)


@pytest.mark.skipif(not jax_codecs.ffmpeg_available(), reason="ffmpeg not on PATH")
def test_mp3_roundtrip_matches_jax():
    audio = _signals()["sine"][:8000]
    got = codecs.compress_roundtrip(audio, 16000, codec="mp3", bitrate="128k")
    want = jax_codecs.compress_roundtrip(audio, 16000, codec="mp3", bitrate="128k")
    assert got.shape == want.shape == audio.shape
    assert np.array_equal(got, want)


def test_stage_times_follow_jax():
    from heybuddy_tpu.utils.profiling import StageTimes as JaxStageTimes

    port, ref = profiling.StageTimes(), JaxStageTimes()
    for name, seconds in (("a", 0.5), ("b", 0.25), ("a", 1.5), ("a", 0.1)):
        port.record(name, seconds)
        ref.record(name, seconds)
    assert port.total == ref.total and port.count == ref.count and port.ema == ref.ema
    assert port.summary() == ref.summary()


def test_stage_timer_records_and_names_the_trace_span():
    times = profiling.StageTimes()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage_timer("pretrain/test-stage", times):
            torch.ones(8).sum()
        with profiling.span("pretrain/test-span"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"pretrain/test-stage", "pretrain/test-span"} <= names
    assert times.count == {"pretrain/test-stage": 1} and times.total["pretrain/test-stage"] > 0.0
