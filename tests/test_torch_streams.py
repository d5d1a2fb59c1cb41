"""The stream path of the port against the JAX package's: the synthesised
streams (bit-equal on the host ``formant`` backend, schedules included), the
window geometry, the stream-window feature caches (generated, topped up, by
JAX's rule), ``featurize_stream_device`` on its row-strided window view, and
K1's row-strided audio (and the other audio kernels' refusal of it)."""

import os

import numpy as np
import pytest
import torch

import heybuddy_tpu.data.streams as jax_streams
import heybuddy_tpu.models.featurizer as jax_featurizer
import heybuddy_tpu.models.tts as jax_tts
from heybuddy_tpu.data.features import TrainingFeaturesGenerator as JaxGenerator
from heybuddy_tpu_torch.constants import CLIP_SAMPLES, RUNTIME_WINDOW_STRIDE
from heybuddy_tpu_torch.data import streams
from heybuddy_tpu_torch.data import tts_generator as port_tts_generator
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
from heybuddy_tpu_torch.models import featurizer, tts
from heybuddy_tpu_torch.models.featurizer import featurize_batch, get_speech_embeddings
from heybuddy_tpu_torch.ops.kernels import melspec_kernel as mk
from heybuddy_tpu_torch.ops.kernels.featurize_kernel import fused_featurize
from heybuddy_tpu_torch.ops.windows import embedding_window_starts

from torch_fixtures import assert_features_close

MINUTES = 0.1
# windows a stream segment holds in the cache tests: 6 rows come in two
# segments, so the double buffer (segment 2 synthesised while segment 1 is
# featurized) runs
SEGMENT = 3


@pytest.fixture(autouse=True)
def stream_env(monkeypatch):
    """Offline, the rule G2P, fresh shared TTS / featurizer instances in both packages."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.delenv("HEYBUDDY_TTS_BACKEND", raising=False)
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(jax_tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)


def _port_stream(kind: str, minutes: float, seed: int, **kw):
    if kind == "speech":
        return streams.synth_speech_stream(minutes, seed, exclude_phrase="hey buddy", device="cpu", **kw)
    if kind == "adversarial":
        return streams.synth_adversarial_stream("hey buddy", minutes, seed, device="cpu", **kw)
    return streams.synth_collision_salad_stream("hey buddy", minutes, seed, device="cpu", **kw)


def _jax_stream(kind: str, minutes: float, seed: int, **kw):
    if kind == "speech":
        return jax_streams.synth_speech_stream(minutes, seed, exclude_phrase="hey buddy", **kw)
    if kind == "adversarial":
        return jax_streams.synth_adversarial_stream("hey buddy", minutes, seed, **kw)
    return jax_streams.synth_collision_salad_stream("hey buddy", minutes, seed, **kw)


@pytest.mark.parametrize("kind", ["speech", "adversarial", "collision"])
def test_streams_equal_jax_bit_for_bit(kind):
    kw = {"tts_backend": "formant"}
    if kind != "adversarial":
        kw["return_schedule"] = True
    got, want = _port_stream(kind, MINUTES, 5, **kw), _jax_stream(kind, MINUTES, 5, **kw)
    if kind != "adversarial":
        assert got[1] == want[1] and len(got[1]) >= 3
        got, want = got[0], want[0]
    assert got.dtype == want.dtype == np.float32 and len(got) == int(MINUTES * 60 * 16000)
    np.testing.assert_array_equal(got, want)
    assert 0.05 < np.abs(got).max() <= 1.0


def test_stream_generator_batch_size_follows_the_backend(monkeypatch):
    """The TTS batch sets the speaker offsets: 128 for the device backends
    (argument or HEYBUDDY_TTS_BACKEND), 8 otherwise, as in JAX."""
    seen = []

    class Recorder(port_tts_generator.SpeechSampleGenerator):
        def __init__(self, *args, **kwargs):
            seen.append((kwargs["batch_size"], kwargs["tts_backend"], str(kwargs["device"])))
            super().__init__(*args, **kwargs)

        def __call__(self, num_samples, **kwargs):
            return iter(())

    monkeypatch.setattr(port_tts_generator, "SpeechSampleGenerator", Recorder)
    streams.texts_to_stream(["a b"], 0.01, 1, tts_backend="formant-device", device="cpu")
    streams.texts_to_stream(["a b"], 0.01, 1, device="cpu")
    monkeypatch.setenv("HEYBUDDY_TTS_BACKEND", "device")
    streams.texts_to_stream(["a b"], 0.01, 1, device="cpu")
    assert seen == [(128, "formant-device", "cpu"), (8, None, "cpu"), (128, None, "cpu")]


def test_window_geometry_equals_jax():
    assert streams.RUNTIME_WINDOW_STRIDE == jax_streams.RUNTIME_WINDOW_STRIDE == 1920
    stream = np.random.default_rng(0).normal(0, 0.1, CLIP_SAMPLES + 5 * 1920 + 77).astype(np.float32)
    for length in (0, 10, CLIP_SAMPLES - 1, CLIP_SAMPLES, CLIP_SAMPLES + 1919, CLIP_SAMPLES + 1920, len(stream)):
        part = stream[:length]
        assert streams.stream_window_count(part) == jax_streams.stream_window_count(part)
        for start, count in ((0, None), (2, None), (1, 3), (4, 10), (9, 1)):
            got = streams.stream_window_clips(part, start=start, count=count)
            want = jax_streams.stream_window_clips(part, start=start, count=count)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    assert streams.stream_window_count(stream, window=1000, stride=300) == jax_streams.stream_window_count(
        stream, window=1000, stride=300)


@pytest.mark.parametrize("kind", ["speech", "adversarial", "collision"])
def test_stream_window_features_match_jax(kind, tmp_path, monkeypatch):
    """6 rows in two segments in both packages: the same cache name and
    stride; the port's rows held to JAX's float32 features of the same
    windows by the generated-feature rule (JAX's own rows are its CPU bf16
    path's). JAX pads a segment to its window count, which only adds rows it
    drops, so its count is cut to SEGMENT too."""
    monkeypatch.setattr(featurizer, "STREAM_SEGMENT_WINDOWS", SEGMENT)
    monkeypatch.setattr(jax_featurizer, "STREAM_SEGMENT_WINDOWS", SEGMENT)
    kw = {"adversarial": kind == "adversarial", "collision": kind == "collision", "seed": 4}
    port = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path / "port"), tts_backend="formant",
                                     device="cpu").get_stream_window_features(6, **kw)
    ref = JaxGenerator("hey buddy", directory=str(tmp_path / "jax"), tts_backend="formant"
                       ).get_stream_window_features(6, **kw)
    assert port.name == ref.name and port.stream_stride_seconds == ref.stream_stride_seconds == 0.12
    got = np.load(tmp_path / "port" / f"{port.name}.npy")
    want = np.load(tmp_path / "jax" / f"{ref.name}.npy")
    # the windows: two segments seeded by their row offsets
    clips = []
    for offset in (0, SEGMENT):
        seconds = (SEGMENT * RUNTIME_WINDOW_STRIDE + CLIP_SAMPLES) / 16000.0
        stream = _jax_stream(kind, seconds / 60.0, 4 + 7919 * offset, tts_backend="formant")
        clips.append(jax_streams.stream_window_clips(stream)[:SEGMENT])
    assert_features_close(got, want, np.concatenate(clips) * 32767.0)


def test_featurize_stream_device_equals_the_materialised_windows():
    """The row-strided view through featurize_batch equals the copied windows,
    at the same batch size, bit for bit; the count is the real one (no padding)."""
    stream = streams.synth_speech_stream(0.05, 2, exclude_phrase="hey buddy", tts_backend="formant", device="cpu")
    embeddings = get_speech_embeddings(device="cpu")
    n = 5
    out, count = embeddings.featurize_stream_device(stream, n, RUNTIME_WINDOW_STRIDE)
    assert count == n and out.shape == (n, 16, 96)
    windows = torch.from_numpy(streams.stream_window_clips(stream)[:n] * 32767.0)
    assert torch.equal(out, featurize_batch(embeddings.net, windows))
    # a stream shorter than the windows' span is zero-filled, as in JAX
    short = stream[: CLIP_SAMPLES + 1000]
    out, count = embeddings.featurize_stream_device(short, 3, RUNTIME_WINDOW_STRIDE)
    padded = np.zeros(2 * RUNTIME_WINDOW_STRIDE + CLIP_SAMPLES, np.float32)
    padded[: len(short)] = short
    windows = torch.from_numpy(streams.stream_window_clips(padded) * 32767.0)
    assert count == 3 and torch.equal(out, featurize_batch(embeddings.net, windows))
    with pytest.raises(ValueError, match="no window"):
        embeddings.featurize_stream_device(stream, 0, RUNTIME_WINDOW_STRIDE)


def test_stream_cache_top_up_equals_whole(tmp_path, monkeypatch):
    """JAX's rule, extend and never regenerate: 3 rows topped up to 6 equal 6
    generated at once (segments seeded by their absolute row offsets)."""
    monkeypatch.setattr(featurizer, "STREAM_SEGMENT_WINDOWS", SEGMENT)
    whole = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path / "whole"), tts_backend="formant",
                                      device="cpu")
    it = whole.get_stream_window_features(6, collision=True)
    grown = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path / "grown"), tts_backend="formant",
                                      device="cpu")
    grown.get_stream_window_features(3, collision=True)
    first = np.load(tmp_path / "grown" / f"{it.name}.npy")
    grown.get_stream_window_features(6, collision=True)
    a = np.load(tmp_path / "whole" / f"{it.name}.npy")
    b = np.load(tmp_path / "grown" / f"{it.name}.npy")
    assert a.shape == (6, 16, 96) and np.isfinite(a).all()
    np.testing.assert_array_equal(b[:3], first)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mutually exclusive"):
        whole.get_stream_window_features(2, adversarial=True, collision=True)


def _window_view(rows: int, stride: int, t: int, seed: int = 0) -> torch.Tensor:
    seg = torch.from_numpy(np.random.default_rng(seed).normal(0, 1000.0, (rows - 1) * stride + t).astype(np.float32))
    return seg.as_strided((rows, t), (stride, 1))


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16])
def test_strided_mel_patches_equal_contiguous(dft_dtype):
    """K1's plain version on overlapping rows 1920 apart equals it on their copy, bit for bit."""
    view = _window_view(4, RUNTIME_WINDOW_STRIDE, CLIP_SAMPLES)
    assert not view.is_contiguous()
    got, n = mk.mel_patches(view, dft_dtype=dft_dtype)
    want, n2 = mk.mel_patches(view.contiguous(), dft_dtype=dft_dtype)
    assert n == n2 == 35 and torch.equal(got, want)
    # a single row and a column slice of a wider batch are row-strided too
    wide = _window_view(3, 30000, 30000).contiguous()[:, :CLIP_SAMPLES]
    assert torch.equal(mk.mel_patches(wide)[0], mk.mel_patches(wide.contiguous())[0])


def test_mel_patches_refuses_a_view_past_its_storage():
    seg = torch.zeros(3 * RUNTIME_WINDOW_STRIDE + CLIP_SAMPLES)
    view = seg.as_strided((4, CLIP_SAMPLES), (RUNTIME_WINDOW_STRIDE, 1))
    assert mk.mel_patches(view)[1] == 35
    # as_strided checks the storage, but a storage can shrink under its views
    view.untyped_storage().resize_((3 * RUNTIME_WINDOW_STRIDE + CLIP_SAMPLES - 1) * 4)
    with pytest.raises(ValueError, match="last row"):
        mk.mel_patches(view)
    backwards = torch.zeros(2 * CLIP_SAMPLES).as_strided((2, CLIP_SAMPLES), (1, 2))
    with pytest.raises(ValueError, match="rows of contiguous samples"):
        mk.mel_patches(backwards)


def test_other_audio_kernels_refuse_strided_views():
    """K1b, K3 and K4 derive their loads from clip * t: contiguous audio only."""
    view = _window_view(2, RUNTIME_WINDOW_STRIDE, CLIP_SAMPLES)
    net = get_speech_embeddings(device="cpu").net
    with pytest.raises(ValueError, match="contiguous"):
        mk.mel_patches(view, dft_mode="fat")
    with pytest.raises(ValueError, match="contiguous"):
        mk.mel_patches(view, dft_mode="fat", dft_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mel_spectrogram(view)
    with pytest.raises(ValueError, match="contiguous"):
        fused_featurize(net, view, embedding_window_starts(CLIP_SAMPLES))
    # featurize_batch gives the other formulations a contiguous copy
    for pooling in ("mega", "banded"):
        out = featurize_batch(net, view, pooling=pooling)
        assert torch.equal(out, featurize_batch(net, view.contiguous(), pooling=pooling))


@pytest.mark.parametrize("half", [False, True])
def test_combine_equals_jax_byte_for_byte(tmp_path, half, capsys):
    """``combine`` of a path and a glob (found in --directory), in batches of
    7 rows, then once more without --reset (appending): the same .npy bytes
    and output line as JAX's command through click's CliRunner."""
    from click.testing import CliRunner

    from heybuddy_tpu.cli import main as jax_main
    from heybuddy_tpu_torch.cli import main as cli_main

    rng = np.random.default_rng(8)
    parts = [rng.normal(0, 1, (n, 16, 96)).astype(np.float32) for n in (5, 16, 9)]
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        for i, part in enumerate(parts):
            np.save(tmp_path / pkg / f"part-{i}.npy", part)
    half_flag = ["--half"] if half else []
    lines = {}
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        argv = ["combine", os.path.join(d, "part-0.npy"), "part-[12].npy", "merged", "--directory", d,
                "--batch-size", "7", *half_flag]
        again = ["combine", os.path.join(d, "part-2.npy"), os.path.join(d, "merged.npy"), "--no-reset",
                 "--delete", *half_flag]
        if pkg == "port":
            assert cli_main(argv) == 0 and cli_main(again) == 0
            lines[pkg] = capsys.readouterr().out
        else:
            runner = CliRunner()
            first, second = runner.invoke(jax_main, argv), runner.invoke(jax_main, again)
            assert first.exit_code == second.exit_code == 0, first.output + second.output
            lines[pkg] = first.output + second.output
    assert lines["port"].replace(str(tmp_path / "port"), "D") == lines["jax"].replace(str(tmp_path / "jax"), "D")
    assert "Combined 30 rows from 3 shard(s) into" in lines["port"]
    got = (tmp_path / "port" / "merged.npy").read_bytes()
    assert got == (tmp_path / "jax" / "merged.npy").read_bytes()
    merged = np.load(tmp_path / "port" / "merged.npy")
    np.testing.assert_array_equal(merged, np.concatenate(parts + parts[2:]).astype(merged.dtype))
    assert merged.dtype == (np.float16 if half else np.float32)
    assert not (tmp_path / "port" / "part-2.npy").exists()
    assert cli_main(["combine", "nothing-*.npy", "out", "--directory", str(tmp_path / "port")]) == 1
    assert "No source shards found" in capsys.readouterr().err


def test_stream_path_default_device_is_the_card(tmp_path):
    """No fallback: without a GPU the stream path raises on the default device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), tts_backend="formant")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gen.get_stream_window_features(2)
