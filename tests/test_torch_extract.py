"""The port's ``extract`` command and its helpers (WAV decoding, appendable
.npy shards, transcript tokens) against the JAX package.

The port runs on the CPU (``--device cpu``), where its kernels take their
plain versions; the JAX extractor runs its fused Pallas path in interpret
mode.
"""

import functools
import glob
import os
import struct
import sys
import types
import unittest.mock as mock

import numpy as np
import pytest

import heybuddy_tpu.ops.pallas.embedding_kernel as jax_ek
import heybuddy_tpu.ops.pallas.melspec_kernel as jax_mk
from heybuddy_tpu.data import extract as jax_extract
from heybuddy_tpu.models import featurizer as jax_featurizer
from heybuddy_tpu.text import tokens as jax_tokens
from heybuddy_tpu.utils import codecs as jax_codecs
from heybuddy_tpu.utils import npy as jax_npy
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.data import extract
from heybuddy_tpu_torch.text import tokens
from heybuddy_tpu_torch.utils import codecs, npy
from heybuddy_tpu_torch.utils.audio_io import audio_to_bct_array, write_wav

TEXTS = ["Hello there, general Kenobi!", "good   MORNING everyone", "", "it's 5 o'clock"]


def _float_wav_bytes(audio: np.ndarray, rate: int, extensible: bool = False) -> bytes:
    """IEEE-float WAV bytes of a (channels, time) float32 array."""
    channels = audio.shape[0]
    data = np.ascontiguousarray(audio.T, dtype=np.float32).tobytes()
    tag = 0xFFFE if extensible else 3
    fmt = struct.pack("<HHIIHH", tag, channels, rate, rate * 4 * channels, 4 * channels, 32)
    if extensible:
        fmt += struct.pack("<HHI", 22, 32, 0) + b"\x03\x00" + b"\x00" * 14
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _signal(seed: int, n: int, channels: int = 1) -> np.ndarray:
    """Noise at the level the featurizer tests use (std 0.03 of full scale)."""
    return np.random.default_rng(seed).normal(0.0, 0.03, (channels, n)).astype(np.float32)


@pytest.fixture()
def wav_dir(tmp_path):
    """Four wavs: int16 PCM, IEEE-float stereo, too short to window, 22.05 kHz."""
    write_wav(str(tmp_path / "a0.wav"), _signal(0, 32000)[0])
    (tmp_path / "a1.wav").write_bytes(_float_wav_bytes(_signal(1, 16000, channels=2), 16000))
    write_wav(str(tmp_path / "a2.wav"), _signal(2, 4800)[0])
    write_wav(str(tmp_path / "a3.wav"), _signal(3, 44100)[0], sample_rate=22050)
    for i, text in enumerate(TEXTS[:3]):  # a3 has no sidecar: empty transcript
        (tmp_path / f"a{i}.txt").write_text(text)
    return tmp_path


def _jax_shards(wav_glob: str, directory: str):
    """The JAX extractor on the same files, its featurizer forced onto the fused Pallas path."""
    fused = functools.partial(jax_featurizer.featurize_batch, pooling="fused")
    with mock.patch.object(
        jax_mk, "mel_patches_pallas", functools.partial(jax_mk.mel_patches_pallas, interpret=True)
    ), mock.patch.object(
        jax_ek,
        "fused_embedding_from_patches",
        functools.partial(jax_ek.fused_embedding_from_patches, interpret=True),
    ), mock.patch.object(
        jax_featurizer, "_jitted_featurize", lambda name: functools.partial(fused, compute_dtype=name)
    ), mock.patch.object(jax_featurizer, "_GLOBAL_EMBEDDINGS", None):
        extractor = jax_extract.LabeledFeatureExtractor(
            directory, "set", samples_per_file=2, process_batch_size=2
        )
        return extractor(jax_extract.iter_wav_files(sorted(glob.glob(wav_glob))))


def test_cli_extract_local_files_matches_jax(wav_dir, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("HEYBUDDY_TOKENIZER", raising=False)
    wav_glob = str(wav_dir / "a*.wav")
    out_dir = str(tmp_path / "torch-shards")
    rc = cli_main([
        "extract", "set", wav_glob, "--local-files", "--directory", out_dir,
        "--samples-per-file", "2", "--process-batch-size", "2", "--device", "cpu",
    ])
    assert rc == 0
    printed = capsys.readouterr().out.splitlines()
    paths = [os.path.join(out_dir, f"set-{i}.npy") for i in range(3)]
    assert printed == ["Wrote 3 shard(s):"] + [f"  {p}" for p in paths]

    ref_paths = _jax_shards(wav_glob, str(tmp_path / "jax-shards"))
    assert [os.path.basename(p) for p in ref_paths] == [os.path.basename(p) for p in paths]
    got = [np.load(p) for p in paths]
    ref = [np.load(p) for p in ref_paths]
    # 2 + 1 + 0 + 2 windows (a2 is under a quarter clip), two per shard
    assert [g.shape for g in got] == [r.shape for r in ref] == [(2, 17, 96), (2, 17, 96), (1, 17, 96)]
    got, ref = np.concatenate(got), np.concatenate(ref)
    np.testing.assert_array_equal(got[:, 16], ref[:, 16])
    window_texts = [TEXTS[0], TEXTS[0], TEXTS[1], "", ""]  # a3 has no sidecar
    expect_tokens = np.stack([tokens.BERTTokenizer()(t) for t in window_texts]).astype(np.float32)
    np.testing.assert_array_equal(got[:, 16], expect_tokens)
    # the fused path's bf16 rounding points: the JAX suite's bound for its own kernels
    assert np.abs(got[:, :16] - ref[:, :16]).max() < 0.05


def test_extract_on_missing_cuda_raises(wav_dir, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["extract", "set", str(wav_dir / "a*.wav"), "--local-files",
                  "--directory", str(tmp_path / "out")])


def test_iter_hf_dataset_reads_samples(monkeypatch):
    samples = [
        {"audio": {"array": [0.1, -0.2], "sampling_rate": 8000}, "transcript": "hi"},
        {"audio": {"array": np.zeros(3), "sampling_rate": 16000}},
    ]
    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda *args, **kwargs: iter(samples)
    monkeypatch.setitem(sys.modules, "datasets", fake)
    got = list(extract.iter_hf_dataset("org/set"))
    ref = list(jax_extract.iter_hf_dataset("org/set"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["sampling_rate"] == r["sampling_rate"] and g["transcript"] == r["transcript"]
        np.testing.assert_array_equal(g["array"], r["array"])
        assert g["array"].dtype == np.float32


@pytest.mark.parametrize("kind", ["int16", "float32", "float32-extensible", "bytes"])
def test_read_wav_any_matches_jax(tmp_path, kind):
    audio = _signal(4, 1000, channels=2)
    path = str(tmp_path / "x.wav")
    if kind == "int16":
        write_wav(path, audio, 22050)
    else:
        with open(path, "wb") as f:
            f.write(_float_wav_bytes(audio, 22050, extensible=kind == "float32-extensible"))
    arg = (tmp_path / "x.wav").read_bytes() if kind == "bytes" else path
    got, rate = codecs.read_wav_any(arg)
    ref, ref_rate = jax_codecs.read_wav_any(arg)
    assert rate == ref_rate == 22050 and got.shape == ref.shape == (2, 1000)
    np.testing.assert_array_equal(got, ref)
    if kind != "int16":
        np.testing.assert_array_equal(got, audio)  # float samples are kept exactly
        loaded, _ = audio_to_bct_array(path)  # the featurizer's loader reads it too
        np.testing.assert_array_equal(loaded[0], audio)


def test_appendable_npy_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    blocks = [rng.normal(size=(n, 17, 96)).astype(np.float32) for n in (3, 2, 4)]
    for mod, name in ((npy, "torch.npy"), (jax_npy, "jax.npy")):
        store = mod.AppendableNpyFile(str(tmp_path / name))
        store.append(blocks[0])
        store.append(blocks[1])
        reopened = mod.AppendableNpyFile(str(tmp_path / name))
        assert len(reopened) == 5 and reopened.shape == (5, 17, 96)
        reopened.append(blocks[2])
    got = (tmp_path / "torch.npy").read_bytes()
    assert got == (tmp_path / "jax.npy").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "torch.npy"), np.concatenate(blocks))
    assert npy.read_npy_header(str(tmp_path / "torch.npy"))[1] == (9, 17, 96)
    with pytest.raises(ValueError, match="row shape"):
        npy.AppendableNpyFile(str(tmp_path / "torch.npy")).append(np.zeros((1, 16, 96), np.float32))


def test_ensure_appendable_repairs_a_torn_append(tmp_path):
    rows = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    for mod, name in ((npy, "torch.npy"), (jax_npy, "jax.npy")):
        path = str(tmp_path / name)
        mod.AppendableNpyFile(path).append(rows)
        with open(path, "ab") as f:
            f.write(b"\x00" * 10)  # part of a fifth row
        mod.ensure_appendable(path)
    assert (tmp_path / "torch.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "torch.npy"), rows)


def test_hash_tokenizer_ids_equal_jax(monkeypatch):
    monkeypatch.delenv("HEYBUDDY_TOKENIZER", raising=False)
    got, ref = tokens.BERTTokenizer(length=8), jax_tokens.BERTTokenizer(length=8)
    assert not got.is_wordpiece and not ref.is_wordpiece
    for text in TEXTS + [" ".join(["word"] * 20)]:
        np.testing.assert_array_equal(got(text), ref(text))
        assert got(text).dtype == np.int64 and got(text).shape == (8,)
    np.testing.assert_array_equal(got(TEXTS[0], length=3), ref(TEXTS[0], length=3))
    assert got.decode(got(TEXTS[0])) == ref.decode(ref(TEXTS[0])) == "hello there general kenobi"


def test_wordpiece_tokenizer_ids_equal_jax(tmp_path, monkeypatch):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "there", "good", "morn", "##ing", ",", "!"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    monkeypatch.setenv("HEYBUDDY_TOKENIZER", str(tmp_path / "vocab.txt"))
    got, ref = tokens.BERTTokenizer(length=6), jax_tokens.BERTTokenizer(length=6)
    assert got.is_wordpiece and ref.is_wordpiece
    for text in TEXTS:
        np.testing.assert_array_equal(got(text), ref(text))
    np.testing.assert_array_equal(got("hello there, good morning!")[:6], [4, 5, 9, 6, 7, 8])
