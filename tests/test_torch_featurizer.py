"""The port's featurizer (the whole slice up to the embeddings) against the JAX package.

On the CPU the port's wrappers run the kernels' plain versions; the JAX side
runs its fused Pallas path in interpret mode.
"""

import functools
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import heybuddy_tpu.ops.pallas.embedding_kernel as jax_ek
import heybuddy_tpu.ops.pallas.melspec_kernel as jax_mk
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu.models import featurizer as jax_featurizer
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.models import featurizer
from heybuddy_tpu_torch.models.wakeword import load_model
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings, get_speech_embeddings


SHIPPED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reports",
                       "quality-v26-embedv8.npz")


@pytest.fixture(scope="module")
def embeddings():
    return SpeechEmbeddings(device="cpu")


def _clips(seed: int, b: int, t: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 0.03, (b, t)).astype(np.float32)


def _jax_fused(params, mono):
    with mock.patch.object(
        jax_mk, "mel_patches_pallas", functools.partial(jax_mk.mel_patches_pallas, interpret=True)
    ), mock.patch.object(
        jax_ek,
        "fused_embedding_from_patches",
        functools.partial(jax_ek.fused_embedding_from_patches, interpret=True),
    ):
        return np.asarray(jax_featurizer.featurize_batch(params, jnp.asarray(mono), pooling="fused"))


def test_speech_embeddings_match_jax(embeddings):
    clips = _clips(31, 3, 23040)
    got = embeddings(clips)
    mono = clips * 32767.0  # the featurizer's int16-range scaling
    params = jax_net.default_params()
    fused = _jax_fused(params, mono)
    assert got.shape == fused.shape == (3, 16, 96)
    assert np.isfinite(got).all()
    # the same rounding points as the Pallas path; bf16 flips from summation
    # order stay under the JAX suite's 0.05 bound for its own kernel
    assert np.abs(got - fused).max() < 0.05
    banded_f32 = np.asarray(
        jax_featurizer.featurize_batch(
            params, jnp.asarray(mono), pooling="banded", compute_dtype=jnp.float32
        )
    )
    # bf16 path against the float32 reference, as test_melspec.py bounds its own
    assert np.abs(got - banded_f32).max() < 0.1


@pytest.mark.parametrize("t, frames", [(17280, 100), (23040, 420)])
def test_return_spectrograms_truncates_to_whole_windows(embeddings, t, frames):
    clips = _clips(32, 2, t)
    emb, spec = embeddings(clips, return_spectrograms=True)
    assert emb.shape == (2, (t - 17280) // 1920 * 4 + 4, 96)
    assert spec.shape == (2, frames, 32)
    with mock.patch.object(jax_featurizer, "_GLOBAL_EMBEDDINGS", None):
        _, ref = jax_featurizer.SpeechEmbeddings()(clips, return_spectrograms=True)
    np.testing.assert_allclose(spec, ref, atol=5e-3, rtol=1e-4)


def test_featurize_device_matches_call(embeddings):
    clips = _clips(33, 2, 23040)
    out, n = embeddings.featurize_device(clips)
    assert n == 2 and out.shape == (2, 16, 96) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), embeddings(clips))


def test_repair_nan_replaces_bad_rows_from_good_ones():
    emb = np.arange(4 * 2 * 3, dtype=np.float32).reshape(4, 2, 3)
    emb[1, 0, 0] = np.nan
    emb[3, 1, 2] = np.nan
    gen = torch.Generator().manual_seed(5)
    fixed = SpeechEmbeddings._repair_nan(emb, gen)
    assert np.isfinite(fixed).all()
    good = {tuple(emb[0].ravel()), tuple(emb[2].ravel())}
    assert tuple(fixed[1].ravel()) in good and tuple(fixed[3].ravel()) in good
    np.testing.assert_array_equal(fixed[[0, 2]], emb[[0, 2]])
    again = SpeechEmbeddings._repair_nan(emb, torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(fixed, again)  # the generator decides the rows
    clean = emb[[0, 2]]
    assert SpeechEmbeddings._repair_nan(clean) is clean
    all_bad = np.full((2, 2, 3), np.nan, np.float32)
    np.testing.assert_array_equal(SpeechEmbeddings._repair_nan(all_bad), np.zeros_like(all_bad))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeechEmbeddings()
    with pytest.raises(RuntimeError):
        featurizer.get_speech_embeddings()
    with pytest.raises(RuntimeError):
        load_model(SHIPPED)
    with pytest.raises(RuntimeError):
        cli_main(["predict", SHIPPED, "unused.wav"])


def test_onnx_embedding_is_not_ported(monkeypatch):
    """The ONNX backend is ported (tests/test_torch_onnx_import.py); a HEYBUDDY_EMBEDDING_ONNX
    naming no file raises instead of falling back to another feature space."""
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_ONNX", "/nonexistent/speech-embedding.onnx")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        SpeechEmbeddings(device="cpu")


def test_get_speech_embeddings_is_shared_per_device(monkeypatch):
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    first = get_speech_embeddings(device="cpu")
    assert get_speech_embeddings(device="cpu") is first
    assert first.space_id == jax_net.embedding_space_id(jax_net.default_params())
