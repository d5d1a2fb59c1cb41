"""The port's wake-word head, predict and CLI against the JAX package."""

import functools
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch
import jax

import heybuddy_tpu.ops.pallas.embedding_kernel as jax_ek
import heybuddy_tpu.ops.pallas.melspec_kernel as jax_mk
from heybuddy_tpu.models import featurizer as jax_featurizer
from heybuddy_tpu.models import wakeword as jax_wakeword
from heybuddy_tpu.models.formant import FormantSynthesizer
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.convert import wakeword_params_from_numpy
from heybuddy_tpu_torch.models import featurizer
from heybuddy_tpu_torch.models import wakeword
from heybuddy_tpu_torch.utils.audio_io import write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, "reports", "quality-v26-embedv8.npz")

# the head is float32 end to end in both packages: only summation order differs
HEAD_ATOL = 1e-5


def _features(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0.0, 1.0, (n, 16, 96)).astype(np.float32)


def test_shipped_head_matches_jax():
    jax_model = jax_wakeword.load_model(SHIPPED)
    model = wakeword.load_model(SHIPPED, device="cpu")
    assert model.config() == jax_model.config()
    x = _features(41, 8)
    ref = np.asarray(jax_model(x))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (8, 1)
    np.testing.assert_allclose(got, ref, atol=HEAD_ATOL)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_weight_bridge_with_half_layers(activation):
    jax_model = jax_wakeword.WakeWordMLPModel(
        layer_dim=32, num_layers=2, use_half_layers=True, activation=activation, seed=3
    )
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    model = wakeword.WakeWordMLPModel(
        layer_dim=32, num_layers=2, use_half_layers=True, activation=activation,
        params=tree, device="cpu",
    )
    assert set(wakeword_params_from_numpy(tree)) == set(model.state_dict())
    x = _features(42, 5)
    np.testing.assert_allclose(
        model(torch.from_numpy(x)).detach().numpy(), np.asarray(jax_model(x)), atol=HEAD_ATOL
    )


def test_transformer_checkpoint_is_not_ported(tmp_path):
    """A JAX transformer checkpoint loads in the port; its ONNX export is what
    is not ported (the JAX package has none either)."""
    path = str(tmp_path / "transformer.npz")
    jax_wakeword.WakeWordTransformerModel(dim=16, num_layers=1).save(path)
    model = wakeword.load_model(path, device="cpu")
    assert isinstance(model, wakeword.WakeWordTransformerModel)
    with pytest.raises(NotImplementedError, match="perceptron architecture"):
        model.save_onnx(str(tmp_path / "transformer.onnx"))


@pytest.mark.parametrize(
    "options",
    [
        dict(dim=96, num_layers=2, num_heads=1),
        dict(dim=32, num_layers=1, num_heads=2, activation="gelu"),
        dict(dim=24, num_layers=3, num_heads=3, multiple_of=8, norm_epsilon=1e-6),
    ],
)
def test_transformer_matches_jax_apply(options):
    jax_model = jax_wakeword.WakeWordTransformerModel(seed=7, **options)
    # the zero-initialised final layer makes every score 0.5: give it weights
    params = jax.tree_util.tree_map(np.asarray, jax_model.params)
    rng = np.random.default_rng(8)
    params["final"]["fc"]["w"] = rng.normal(0.0, 0.15, params["final"]["fc"]["w"].shape).astype(np.float32)
    params["final"]["fc"]["b"] = np.asarray([-2.0], np.float32)
    model = wakeword.WakeWordTransformerModel(params=params, device="cpu", **options)
    assert model.config() == jax_model.config()
    x = _features(43, 6)
    ref = np.asarray(jax_model.apply(params, x, train=False))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (6, 1)
    assert np.ptp(ref) > 0.01
    np.testing.assert_allclose(got, ref, atol=HEAD_ATOL)


@pytest.mark.parametrize("architecture", ["perceptron", "transformer"])
def test_checkpoints_load_both_ways(tmp_path, architecture):
    if architecture == "perceptron":
        jax_model = jax_wakeword.WakeWordMLPModel(layer_dim=32, num_layers=0, use_half_layers=True, seed=1)
    else:
        jax_model = jax_wakeword.WakeWordTransformerModel(dim=24, num_layers=2, num_heads=2, seed=1)
    x = _features(44, 4)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_model.save(jax_path)
    model = wakeword.load_model(jax_path, device="cpu")
    assert model.config() == jax_model.config()
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(), np.asarray(jax_model(x)),
                               atol=HEAD_ATOL)
    wakeword.save_model(model, port_path)
    back = jax_wakeword.load_model(port_path)
    assert back.config() == jax_model.config()
    for a, b in zip(jax.tree_util.tree_leaves(back.params), jax.tree_util.tree_leaves(jax_model.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)


def test_dropout_draws_from_the_generator():
    model = wakeword.WakeWordMLPModel(layer_dim=16, num_layers=1, dropout=0.5, device="cpu")
    x = torch.from_numpy(_features(45, 64))
    first = model(x, train=True, generator=torch.Generator().manual_seed(3))
    again = model(x, train=True, generator=torch.Generator().manual_seed(3))
    other = model(x, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert torch.equal(model(x, train=True), model(x))  # no generator: no dropout
    kept = wakeword._dropout(torch.ones(100000), 0.1, torch.Generator().manual_seed(0))
    assert abs(float((kept == 0).float().mean()) - 0.1) < 0.005
    assert set(torch.unique(kept).tolist()) == {0.0, float(np.float32(1.0) / np.float32(0.9))}


@pytest.fixture(scope="module")
def speech_wav(tmp_path_factory):
    clip = FormantSynthesizer().synthesize("hey buddy", speaker=3)
    audio = np.concatenate([np.zeros(16000, np.float32), clip, np.zeros(24000, np.float32)])
    path = str(tmp_path_factory.mktemp("wav") / "hey-buddy.wav")
    write_wav(path, audio, 16000)
    return path


def test_predict_matches_jax(speech_wav, monkeypatch):
    model = wakeword.load_model(SHIPPED, device="cpu")
    windows = model.timecode_windows(speech_wav)
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    got = np.array(model.predict(windows, return_scores=True))

    # the JAX side runs its fused Pallas path in interpret mode: on the CPU its
    # "auto" pooling would take the banded bf16 XLA path, ~0.25 from float32
    monkeypatch.setattr(jax_featurizer, "_resolve_pooling", lambda pooling: "fused")
    monkeypatch.setattr(jax_featurizer, "_GLOBAL_EMBEDDINGS", None)
    monkeypatch.setattr(jax_featurizer, "_jitted_featurize", functools.lru_cache(maxsize=8)(
        jax_featurizer._jitted_featurize.__wrapped__
    ))
    traced = []
    mel_patches_pallas = jax_mk.mel_patches_pallas

    def interpreted_mel_patches(*args, **kwargs):
        traced.append(args[0].shape)
        return mel_patches_pallas(*args, interpret=True, **kwargs)

    with mock.patch.object(jax_mk, "mel_patches_pallas", interpreted_mel_patches), mock.patch.object(
        jax_ek,
        "fused_embedding_from_patches",
        functools.partial(jax_ek.fused_embedding_from_patches, interpret=True),
    ):
        ref = np.array(jax_wakeword.load_model(SHIPPED).predict(windows, return_scores=True))
    assert traced, "the JAX side did not take its fused path"
    assert got.shape == ref.shape == (windows.shape[0],)
    assert got.max() > 0.5  # the synthesized phrase fires the shipped head
    # bf16 feature differences (< 0.05 per element) through the head's sigmoid
    assert np.abs(got - ref).max() < 0.02


def test_cli_predict_lines(speech_wav, capsys):
    assert cli_main(["predict", SHIPPED, speech_wav, "--threshold", "-1", "--device", "cpu"]) == 0
    hits = capsys.readouterr().out.strip().splitlines()
    n = wakeword.WakeWordMLPModel.timecode_windows(speech_wav).shape[0]
    # every window fires: adjacent hits merge at the half second, the last is dropped
    assert hits == [f"Wake word detected at {i + 0.5:.1f}s" for i in range(n - 1)]
    assert cli_main(["predict", SHIPPED, speech_wav, "--threshold", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "No wake words detected."


def test_predict_timecodes_follow_the_scores(speech_wav, monkeypatch):
    model = wakeword.load_model(SHIPPED, device="cpu")
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    scores = np.array(model.predict(model.timecode_windows(speech_wav), return_scores=True))
    hits = [bool(s > 0.5) for s in scores]
    times = model.predict_timecodes(speech_wav, threshold=0.5)
    assert bool(times) == any(hits)
