"""The port's audio tools against the JAX package's scripts on the CPU (the
scripts loaded by path, their Pallas kernels in interpret mode):
``tools/mel_precision_probe``, ``tools/diagnose_stream_fps`` and
``tools/embedding_separation_probe``."""

import contextlib
import functools
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heybuddy_tpu.models.featurizer as jax_featurizer
import heybuddy_tpu.ops.pallas.embedding_kernel as jax_ek
import heybuddy_tpu.ops.pallas.melspec_kernel as jax_mk
from heybuddy_tpu.data import streams as jax_streams
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.models import tts as jax_tts
from heybuddy_tpu.models.wakeword import WakeWordMLPModel as JaxMLPModel
from heybuddy_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from heybuddy_tpu.text.adversarial import single_swap_collision_texts as jax_swap_texts
from heybuddy_tpu_torch.data import streams
from heybuddy_tpu_torch.models import featurizer, tts
from heybuddy_tpu_torch.tools import diagnose_stream_fps as dsf
from heybuddy_tpu_torch.tools import embedding_separation_probe as esp
from heybuddy_tpu_torch.tools import mel_precision_probe as mpp
from heybuddy_tpu_torch.tools import quality_eval as qe

from torch_fixtures import assert_features_close, jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
CHECKPOINT = os.path.join(ROOT, "reports", "quality-v26-embedv8.npz")
# the log-mel against JAX's interpret-mode Pallas kernels: the JAX suite's bounds (tests/test_melspec.py)
MEL_ATOL, MEL_RTOL, BF16_DFT_ATOL = 5e-3, 1e-4, 1e-2
F64_ATOL = 1e-9  # the float64 reference, summed over other slices of the same basis
SCORE_ATOL = 0.02  # the head on the port's features against it on JAX's float32 features (predict's bound)
AUGMENT_ATOL = 1e-4  # the augmentation chain against JAX's with JAX's draws (test_torch_augment.py)
# a probe cosine against the same cosine of JAX's float32 features: the generated-feature rule
# carried through the mean and the normalisation, max(COSINE_ATOL, COSINE_MARGIN x JAX's own
# bf16 path's distance); measured on the clips below (clean and augmented): the port 1.9e-4 -
# 8.5e-4, JAX's own bf16 path 5.7e-4 - 2.0e-3
COSINE_ATOL, COSINE_MARGIN = 2e-3, 1.25


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def tools_env(monkeypatch, tmp_path):
    """Offline, the rule G2P, fresh shared TTS / featurizer instances in both packages."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.setenv("HEYBUDDY_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("HEYBUDDY_TTS_BACKEND", raising=False)
    monkeypatch.delenv("HEYBUDDY_EMBEDDING_WEIGHTS", raising=False)
    monkeypatch.delenv("HEYBUDDY_PROBE_PHRASE", raising=False)
    monkeypatch.setattr(tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(jax_tts, "_GLOBAL_TTS", {})
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lines(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue().splitlines()


def _jax_f32_features(mono):
    """JAX's float32 features of int16-range clips (the reference of the generated-feature rule)."""
    return np.asarray(jax_featurizer.featurize_batch(
        jax_net.default_params(), jnp.asarray(mono), pooling="banded", compute_dtype=jnp.float32))


# --- mel_precision_probe ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mel_script():
    return _script("mel_precision_probe")


def test_realistic_clips_and_f64_logmel_equal_the_scripts(mel_script):
    clips = mpp.realistic_clips(4)
    np.testing.assert_array_equal(clips, mel_script.realistic_clips(4))
    assert clips.dtype == np.float32 and np.abs(clips).max() == 32768.0
    got, want = mpp.f64_logmel(clips), mel_script.f64_logmel(clips)
    assert got.shape == want.shape == (4, 141, 32)
    assert np.abs(got - want).max() <= F64_ATOL


def test_logmel_arrays_are_within_jaxs_pallas_kernels():
    """The records' arrays (K3 and its bf16 DFT through their plain
    versions here) against JAX's ``mel_spectrogram_pallas`` in interpret mode."""
    clips = mpp.realistic_clips(2)
    got = {k: v.numpy() for k, v in mpp.mel_arrays(torch.from_numpy(clips)).items()}
    ref = np.asarray(jax_mk.mel_spectrogram_pallas(jnp.asarray(clips), interpret=True))
    ref16 = np.asarray(jax_mk.mel_spectrogram_pallas(jnp.asarray(clips), dft_dtype=jnp.bfloat16, interpret=True))
    for name in ("xla_melspec", "pallas_f32"):
        assert got[name].shape == ref.shape
        assert (np.abs(got[name] - ref) <= MEL_ATOL + MEL_RTOL * np.abs(ref)).all(), name
    assert np.abs(got["pallas_bf16"] - ref16).max() <= BF16_DFT_ATOL


def test_accuracy_records_follow_the_scripts(mel_script, monkeypatch):
    """The script's ``accuracy()`` (its Pallas kernels in interpret mode) and
    the port's on 2 clips: the same records in order with the same keys
    (the port's add ``kernel``); the bf16 DFT reads farther from float64."""
    real = mel_script.realistic_clips
    monkeypatch.setattr(mel_script, "realistic_clips", lambda n: real(2))
    monkeypatch.setattr(mel_script, "mel_spectrogram_pallas",
                        functools.partial(jax_mk.mel_spectrogram_pallas, interpret=True))
    monkeypatch.setattr(mel_script, "mel_patches_pallas", functools.partial(jax_mk.mel_patches_pallas, interpret=True))
    monkeypatch.setattr(jax_ek, "fused_embedding_from_patches",
                        functools.partial(jax_ek.fused_embedding_from_patches, interpret=True))
    want = [json.loads(line) for line in _lines(mel_script.accuracy)[1]]
    got = mpp.accuracy("cpu", clips=2, emit=lambda line: None)
    assert [r["probe"] for r in got] == [r["probe"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(list(w) + ["kernel"]), g["probe"]
        assert g["kernel"] == mpp.ACCURACY_KERNELS[g["probe"]]
    rec = {r["probe"]: r for r in got}
    jax_rec = {r["probe"]: r for r in want}
    assert rec["pallas_bf16"]["max_abs_err"] > rec["pallas_f32"]["max_abs_err"]
    for name in ("xla_melspec", "pallas_f32"):
        assert abs(rec[name]["max_abs_err"] - jax_rec[name]["max_abs_err"]) <= MEL_ATOL
    assert abs(rec["pallas_bf16"]["max_abs_err"] - jax_rec["pallas_bf16"]["max_abs_err"]) <= BF16_DFT_ATOL


def test_timing_prints_the_five_records():
    rc, lines = _lines(mpp.main, ["--skip-accuracy", "--batch", "4", "--iters", "1", "--passes", "1", "--cpu"])
    assert rc == 0
    assert json.loads(lines[0]) == {"devices": ["cpu"], "card": "cpu"}
    records = [json.loads(line) for line in lines if line.startswith("{") and "ms_per_batch" in line]
    assert [r["probe"] for r in records] == ["mel_patches_f32", "mel_patches_bf16", "emb_from_patches",
                                             "full_f32", "full_bf16"]
    for r in records:
        assert sorted(r) == ["batch", "card", "clips_per_s", "kernel", "ms_per_batch", "probe"]
        assert r["ms_per_batch"] > 0 and r["clips_per_s"] > 0 and r["batch"] == 4 and r["card"] == "cpu"


# --- diagnose_stream_fps ----------------------------------------------------------------------

class _CachedFeaturizer:
    """JAX's float32 ``SpeechEmbeddings`` with its results kept per input, so
    the script can run twice on one featurization."""

    def __init__(self):
        self.inner = jax_featurizer.SpeechEmbeddings(compute_dtype=jnp.float32)
        self.cache = {}

    def __call__(self, clips, **kwargs):
        key = clips.tobytes()
        if key not in self.cache:
            self.cache[key] = np.asarray(self.inner(clips, **kwargs))
        return self.cache[key]


def test_stream_diagnosis_follows_the_script(tmp_path, monkeypatch):
    """A 0.5-minute stream: the stream and its schedule bit-equal to JAX's;
    the scores of the shipped MLP head within SCORE_ATOL of the head on JAX's
    float32 features; the script's JSON and the port's equal in hit times,
    phrases and ``by_phrase`` at a threshold SCORE_ATOL clear of every
    score; the printed report line for line."""
    stream, schedule = dsf.stream_and_schedule(0.5, 31, "hey buddy", "cpu")
    want_stream, want_schedule = jax_streams.synth_speech_stream(0.5, 31, exclude_phrase="hey buddy",
                                                                 tts_backend="formant", return_schedule=True)
    np.testing.assert_array_equal(stream, want_stream)
    assert [tuple(s) for s in schedule] == [tuple(s) for s in want_schedule]

    cached = _CachedFeaturizer()
    monkeypatch.setattr(jax_featurizer, "get_speech_embeddings", lambda **kwargs: cached)
    script = _script("diagnose_stream_fps")

    def run_script(threshold, out):
        monkeypatch.setattr(sys, "argv", ["diagnose_stream_fps.py", "--checkpoint", CHECKPOINT, "--cpu",
                                          "--minutes", "0.5", "--threshold", str(threshold), "--out", out])
        return _lines(script.main)[1]

    run_script(0.5, str(tmp_path / "first.json"))
    head = JaxMLPModel.from_file(CHECKPOINT)
    feats = np.concatenate([cached.cache[k] for k in cached.cache])
    exact = np.asarray(head(feats)).reshape(-1)
    scores = qe.sliding_scores(_port_head(), stream, device="cpu")
    n = streams.stream_window_count(stream)
    assert scores.shape == exact.shape == (n,)
    assert np.abs(scores - exact).max() <= SCORE_ATOL
    both = np.concatenate([scores, exact])
    grid = np.round(np.arange(0.05, 0.96, 0.01), 2)
    clear = [float(t) for t in grid if np.abs(both - t).min() > SCORE_ATOL and (scores >= t).any()]
    assert clear, (scores.max(), exact.max())
    threshold = clear[0]
    want_lines = run_script(threshold, str(tmp_path / "jax.json"))
    rc, got_lines = _lines(dsf.main, ["--checkpoint", CHECKPOINT, "--cpu", "--minutes", "0.5", "--threshold",
                                      str(threshold), "--out", str(tmp_path / "port.json")])
    assert rc == 0 and got_lines == want_lines
    got, want = (json.loads((tmp_path / f"{k}.json").read_text()) for k in ("port", "jax"))
    assert got["by_phrase"] == want["by_phrase"] and len(got["hits"]) >= 1
    assert [(h["t"], h["phrases"]) for h in got["hits"]] == [(h["t"], h["phrases"]) for h in want["hits"]]
    for g, w in zip(got["hits"], want["hits"]):
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL


def test_stream_diagnosis_embedding_is_not_shadowed_by_a_shared_featurizer(tmp_path, monkeypatch):
    """``--embedding`` with another embedding (the bundled one's features
    negated) after the shared featurizer of the CPU was built on the
    default one, scored by a seeded random head whose scores spread: the
    hits (threshold 0, every window) carry the candidate embedding's
    scores, not the default's."""
    bundled = os.path.join(ROOT, "heybuddy_tpu", "assets", "embedding-pretrained.npz")
    with np.load(bundled) as data:
        flat = {k: np.asarray(data[k]) for k in data.files}
    flat["head/w"], flat["head/b"] = -flat["head/w"], -flat["head/b"]
    candidate, head_path = str(tmp_path / "candidate.npz"), str(tmp_path / "head.npz")
    np.savez(candidate, **flat)
    JaxMLPModel(layer_dim=32, num_layers=1, seed=4).save(head_path)
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_WEIGHTS", bundled)  # restored after the tool overrides it
    shared = featurizer.get_speech_embeddings(device="cpu")
    out = str(tmp_path / "fps.json")
    assert _lines(dsf.main, ["--checkpoint", head_path, "--cpu", "--minutes", "0.1", "--threshold", "0",
                             "--embedding", candidate, "--out", out])[0] == 0
    got = np.array([h["score"] for h in json.loads(open(out).read())["hits"]])
    stream, _ = dsf.stream_and_schedule(0.1, 31, "hey buddy", "cpu")
    from heybuddy_tpu_torch.models import embedding_net
    from heybuddy_tpu_torch.models.wakeword import load_model

    head = load_model(head_path, device="cpu")
    want = qe.sliding_scores(head, stream, device="cpu", emb=featurizer.SpeechEmbeddings(
        params=embedding_net.load_params(candidate), device="cpu"))
    default = qe.sliding_scores(head, stream, device="cpu", emb=shared)
    assert got.shape == want.shape == (streams.stream_window_count(stream),)
    np.testing.assert_array_equal(got, [round(float(x), 4) for x in want])
    assert np.abs(want - default).max() > 0.02  # the default embedding scores otherwise


def _port_head():
    from heybuddy_tpu_torch.models.wakeword import WakeWordMLPModel

    return WakeWordMLPModel.from_file(CHECKPOINT, device="cpu")


# --- embedding_separation_probe ---------------------------------------------------------------

@pytest.fixture(scope="module")
def probe_script():
    return _script("embedding_separation_probe")


def _cosines_close(pos, neg, jax_pos, jax_neg, f32_pos, f32_neg):
    got, bf16, f32 = esp.separation(pos, neg), esp.separation(jax_pos, jax_neg), esp.separation(f32_pos, f32_neg)
    for key in got:
        limit = max(COSINE_ATOL, COSINE_MARGIN * abs(bf16[key] - f32[key]))
        assert abs(got[key] - f32[key]) <= limit, (key, got[key], f32[key], bf16[key])
    return got


def _unit_mean(feats):
    mean = feats.mean(axis=1)
    return mean / (np.linalg.norm(mean, axis=1, keepdims=True) + 1e-9)


@pytest.mark.parametrize("augmented", [False, True])
def test_separation_probe_follows_the_script(probe_script, augmented):
    """2 swap texts, 2 renders a text, 4 renders of the phrase: texts and
    renders equal to the script's; with ``augmented`` the chain with JAX's
    draws injected within AUGMENT_ATOL of the script's ``_augment``; the
    pooled features by the generated-feature rule and the three cosines
    and the margin within the cosine rule of JAX's float32 features."""
    swaps = esp.swap_texts("hey buddy", 2)
    assert swaps == jax_swap_texts("hey buddy", num_samples=2, seed=31337, max_swaps=2)
    pos_audio = esp.render_pool(["hey buddy"], 4, esp.PHRASE_SEED)
    swap_audio = esp.render_pool(swaps, 2, esp.SWAP_RENDER_SEED)
    np.testing.assert_array_equal(pos_audio, probe_script._render_pool(["hey buddy"], 4, seed=7))
    np.testing.assert_array_equal(swap_audio, probe_script._render_pool(swaps, 2, seed=11))
    if augmented:
        cfg = JaxAugmentConfig()
        pieces = []
        for audio, seed in ((pos_audio, 5), (swap_audio, 6)):
            want = probe_script._augment(audio, seed=seed)
            got = esp.augment(audio, seed, "cpu", draws=jax_draws(jax.random.PRNGKey(seed), audio.shape[0],
                                                                  audio.shape[1], cfg))
            assert np.abs(got / 32768.0 - want / 32768.0).max() <= AUGMENT_ATOL
            pieces.append(got)
        pos_audio, swap_audio = pieces
    port = {k: featurizer.SpeechEmbeddings(device="cpu")(a) for k, a in (("pos", pos_audio), ("neg", swap_audio))}
    for k, audio in (("pos", pos_audio), ("neg", swap_audio)):
        assert_features_close(port[k], np.asarray(jax_featurizer.SpeechEmbeddings()(audio)), audio * 32767.0)
        np.testing.assert_array_equal(esp.pooled(None, audio, "cpu"), _unit_mean(port[k]))
    jax_pos, jax_neg = probe_script._pooled(None, pos_audio), probe_script._pooled(None, swap_audio)
    f32_pos, f32_neg = (_unit_mean(_jax_f32_features(a * 32767.0)) for a in (pos_audio, swap_audio))
    got = _cosines_close(_unit_mean(port["pos"]), _unit_mean(port["neg"]), jax_pos, jax_neg, f32_pos, f32_neg)
    assert 0.0 < got["phrase_swap_cosine_mean"] < got["phrase_phrase_cosine"] <= 1.0


def test_separation_probe_prints_the_scripts_line(probe_script, monkeypatch, tmp_path):
    """``main`` at the cut sizes with the bundled npz as a candidate: two
    lines in the script's format, the candidate's equal to the default's."""
    bundled = os.path.join(ROOT, "heybuddy_tpu", "assets", "embedding-pretrained.npz")
    rc, lines = _lines(esp.main, [bundled, "--swaps", "2", "--per-text", "2", "--phrase-renders", "3", "--cpu"])
    assert rc == 0 and len(lines) == 2
    assert lines[0].startswith("bundled-default: phrase<->phrase ") and lines[1].startswith(f"{bundled}: ")
    assert lines[0].split(": ", 1)[1] == lines[1].split(": ", 1)[1]
