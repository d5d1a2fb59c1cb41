"""The browser-bundle exporters (mel spectrogram, embedding network) against the
JAX package's: the same bytes for the same parameters, the shipped
``browser/models`` files reproduced from the bundled npz, and the exported
pipeline run by the numpy runner against the port's float32 featurizer."""

import hashlib
import os

import jax
import numpy as np
import pytest
import torch

from heybuddy_tpu.export import onnx_export as jax_export
from heybuddy_tpu.models import embedding_net as jax_net
from heybuddy_tpu_torch.export.onnx_export import export_embedding_net, export_mel_spectrogram
from heybuddy_tpu_torch.export.onnx_numpy import OnnxRunner
from heybuddy_tpu_torch.models import embedding_net
from heybuddy_tpu_torch.models.featurizer import SpeechEmbeddings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = {
    "mel": os.path.join(ROOT, "browser", "models", "mel-spectrogram.onnx"),
    "embedding": os.path.join(ROOT, "browser", "models", "speech-embedding.onnx"),
}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _perturbed(params, seed=1):
    rng = np.random.default_rng(seed)
    flat = embedding_net.flatten_params(params)
    return embedding_net.unflatten_params({
        k: (np.asarray(v) + rng.normal(0.0, 0.01, np.shape(v))).astype(np.float32) for k, v in flat.items()
    })


def test_bundled_npz_reproduces_the_shipped_browser_models(tmp_path):
    mel, emb = str(tmp_path / "mel.onnx"), str(tmp_path / "emb.onnx")
    export_mel_spectrogram(mel)
    export_embedding_net(emb)  # params=None: the bundled npz
    assert _bytes(mel) == _bytes(SHIPPED["mel"])
    assert _bytes(emb) == _bytes(SHIPPED["embedding"])
    assert hashlib.sha256(_bytes(mel)).hexdigest().startswith("1c4ece5c65075c7d")
    assert hashlib.sha256(_bytes(emb)).hexdigest().startswith("ca053f6b1f46993a")


@pytest.mark.parametrize("num_samples", [17280, 23040, 32000])
def test_mel_export_bytes_equal_jax(tmp_path, num_samples):
    port, ref = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    export_mel_spectrogram(port, num_samples=num_samples)
    jax_export.export_mel_spectrogram(ref, num_samples=num_samples)
    assert _bytes(port) == _bytes(ref)


@pytest.mark.parametrize("which", ["bundled", "perturbed", "jax_init_small"])
def test_embedding_export_bytes_equal_jax(tmp_path, which):
    config = None
    if which == "jax_init_small":
        jax_cfg = jax_net.EmbeddingNetConfig(hidden_dim=64, trunk_hidden_dim=96, trunk_blocks=1, pool_heads=2)
        params = jax.tree_util.tree_map(np.asarray, jax_net.init_params(jax.random.PRNGKey(3), jax_cfg))
        config = embedding_net.EmbeddingNetConfig(hidden_dim=64, trunk_hidden_dim=96, trunk_blocks=1, pool_heads=2)
    else:
        params = embedding_net.load_params(embedding_net.bundled_weights_path())
        if which == "perturbed":
            params = _perturbed(params)
        jax_cfg = None
    port, ref = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    export_embedding_net(port, params=params, config=config)
    jax_export.export_embedding_net(ref, params=params, config=jax_cfg)
    assert _bytes(port) == _bytes(ref)


def test_embedding_export_reads_the_weights_env(tmp_path, monkeypatch):
    """``params=None`` is ``default_params()``: HEYBUDDY_EMBEDDING_WEIGHTS first, in both packages."""
    path = str(tmp_path / "perturbed.npz")
    embedding_net.save_params(_perturbed(embedding_net.load_params(embedding_net.bundled_weights_path())), path)
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_WEIGHTS", path)
    monkeypatch.setattr(jax_net, "_DEFAULT_PARAMS_CACHE", {})
    port, ref = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    export_embedding_net(port)
    jax_export.export_embedding_net(ref)
    assert _bytes(port) == _bytes(ref) != _bytes(SHIPPED["embedding"])


def test_exporters_refuse_what_jax_refuses(tmp_path):
    with pytest.raises(ValueError, match="opset"):
        export_mel_spectrogram(str(tmp_path / "m.onnx"), opset_version=17)
    with pytest.raises(ValueError, match="opset"):
        export_embedding_net(str(tmp_path / "e.onnx"), opset_version=17)
    with pytest.raises(ValueError, match="hop"):
        export_mel_spectrogram(str(tmp_path / "m.onnx"), num_samples=17281)


def test_browser_pipeline_end_to_end_matches_the_port(tmp_path):
    """audio -> mel ONNX -> 76-frame windows at stride 8 -> embedding ONNX in the
    numpy runner, against the port's float32 featurizer (JAX's bound, 1e-3)."""
    mel, emb = str(tmp_path / "mel.onnx"), str(tmp_path / "emb.onnx")
    export_mel_spectrogram(mel)
    export_embedding_net(emb)
    audio = np.random.default_rng(3).normal(0, 1000.0, (1, 17280)).astype(np.float32)
    spec = OnnxRunner.from_file(mel)(input=audio)["output"][0]  # (105, 32)
    n = (spec.shape[0] - 76) // 8 + 1
    windows = np.stack([spec[i * 8: i * 8 + 76] for i in range(n)]).astype(np.float32)
    embeddings = OnnxRunner.from_file(emb)(input=windows)["output"]
    assert embeddings.shape == (4, 96)
    native = SpeechEmbeddings(device="cpu", compute_dtype=torch.float32)(audio / 32767.0)
    np.testing.assert_allclose(embeddings[None], native, atol=1e-3, rtol=1e-3)
