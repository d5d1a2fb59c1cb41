"""The port's tools against the JAX package's scripts, on the CPU: the heads'
``from_file`` / ``save`` against JAX's both ways, ``tools/g2p_accuracy``
and ``tools/train_neural_g2p`` against ``scripts/g2p_accuracy.py`` and
``scripts/train_neural_g2p.py`` (loaded by path), and the API walkthrough
``examples/train_wake_word`` at a toy size. The audio tools are in
``test_torch_tools_audio.py``."""

import contextlib
import functools
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from heybuddy_tpu.models import wakeword as jax_wakeword
from heybuddy_tpu.text import neural_g2p as jax_g2p
from heybuddy_tpu.text import phonemizer as jax_phonemizer
from heybuddy_tpu_torch.examples import train_wake_word
from heybuddy_tpu_torch.models import wakeword
from heybuddy_tpu_torch.runtime.onnx_model import WakeWordONNXModel
from heybuddy_tpu_torch.text import neural_g2p as g2p
from heybuddy_tpu_torch.text import phonemizer
from heybuddy_tpu_torch.tools import g2p_accuracy, train_neural_g2p

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
HEAD_ATOL = 1e-5  # the heads are float32 in both packages (test_torch_wakeword.py)
LOGIT_ATOL = 3e-4  # the neural G2P's held-out logits after 60 steps from one initialisation (measured 3.0e-5)
ONNX_ATOL = 1e-5  # convert's ONNX head by the numpy runner against the npz head
FAKE_CMUDICT = (";;; five words\nHEY  HH EY1\nBUDDY  B AH1 D IY0\nWATER  W AO1 T ER0\n"
                "ORANGE  AO1 R AH0 N JH\nQUOKKA  K W AA1 K AH0\n")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def tools_env(monkeypatch, tmp_path):
    """Offline, the rule G2P, no CMU dictionary, fresh dictionary caches in both packages."""
    monkeypatch.setenv("HEYBUDDY_OFFLINE", "1")
    monkeypatch.setenv("HEYBUDDY_PHONEMIZER", "simple")
    monkeypatch.setenv("HEYBUDDY_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("HEYBUDDY_CMUDICT", raising=False)
    for mod in (phonemizer, jax_phonemizer):
        monkeypatch.setattr(mod, "_CMUDICT_CACHE", None)
        monkeypatch.setattr(mod, "_GLOBAL_PHONEMIZER", None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


def _run_script(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    return _stdout(mod.main)[1]


# --- the heads' checkpoints -------------------------------------------------------------------

def _features(seed, n=4):
    return np.random.default_rng(seed).normal(0.0, 1.0, (n, 16, 96)).astype(np.float32)


JAX_HEADS = {
    "perceptron": (jax_wakeword.WakeWordMLPModel, wakeword.WakeWordMLPModel,
                   dict(layer_dim=32, num_layers=1, use_half_layers=True, seed=2)),
    "transformer": (jax_wakeword.WakeWordTransformerModel, wakeword.WakeWordTransformerModel,
                    dict(dim=24, num_layers=2, num_heads=2, seed=2)),
}


@pytest.mark.parametrize("architecture", sorted(JAX_HEADS))
def test_head_from_file_and_save_round_trip_with_jax(tmp_path, architecture):
    """JAX's ``save`` -> the port's ``from_file``: equal parameters and
    scores; the port's ``save`` -> JAX's ``from_file``: equal parameters."""
    jax_cls, cls, options = JAX_HEADS[architecture]
    jax_model = jax_cls(**options)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_model.save(jax_path)
    model = cls.from_file(jax_path, device="cpu")
    assert type(model) is cls and model.config() == jax_model.config()
    jax_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_model.params)]
    port_leaves = jax.tree_util.tree_leaves(wakeword.wakeword_params_to_numpy(model))
    assert len(port_leaves) == len(jax_leaves)
    for a, b in zip(port_leaves, jax_leaves):
        np.testing.assert_array_equal(a, b)
    x = _features(51)
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(), np.asarray(jax_model(x)), atol=HEAD_ATOL)
    model.save(port_path)
    back = jax_cls.from_file(port_path)
    assert back.config() == jax_model.config()
    for a, b in zip(jax.tree_util.tree_leaves(back.params), jax_leaves):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("architecture", sorted(JAX_HEADS))
def test_head_from_file_raises_on_the_other_architecture(tmp_path, architecture):
    jax_cls, _, options = JAX_HEADS[architecture]
    path = str(tmp_path / "head.npz")
    jax_cls(**options).save(path)
    other = next(c for a, (_, c, _) in JAX_HEADS.items() if a != architecture)
    with pytest.raises(TypeError, match=f"not a {other.__name__}"):
        other.from_file(path, device="cpu")
    with pytest.raises(AssertionError):  # JAX asserts there
        next(j for a, (j, _, _) in JAX_HEADS.items() if a != architecture).from_file(path)


@pytest.mark.parametrize("n,multiple", [(0, 8), (7, 8), (8, 8), (63, 18), (64, 18), (100, 7)])
def test_find_nearest_multiple_and_normalized_dim_equal_jax(n, multiple):
    assert wakeword.find_nearest_multiple(n, multiple) == jax_wakeword.find_nearest_multiple(n, multiple)
    assert wakeword.get_normalized_dim(n + 30, multiple) == jax_wakeword.get_normalized_dim(n + 30, multiple)


# --- g2p_accuracy -----------------------------------------------------------------------------

def test_golden_lexicon_equals_the_scripts():
    assert g2p_accuracy.GOLDEN == _script("g2p_accuracy").GOLDEN
    assert list(g2p_accuracy.GOLDEN) == list(_script("g2p_accuracy").GOLDEN)


@pytest.mark.parametrize("cmudict", [False, True])
def test_g2p_accuracy_json_equals_the_scripts(cmudict, tmp_path, monkeypatch):
    """The printed JSON and the ``--json`` file, byte for byte, on the golden
    lexicon alone and with a five-word fake ``HEYBUDDY_CMUDICT``."""
    if cmudict:
        path = tmp_path / "cmudict.txt"
        path.write_text(FAKE_CMUDICT, encoding="latin1")
        monkeypatch.setenv("HEYBUDDY_CMUDICT", str(path))
    script = _script("g2p_accuracy")
    want = _run_script(script, ["--sample", "3", "--seed", "1", "--json", str(tmp_path / "jax.json")], monkeypatch)
    rc, got = _stdout(g2p_accuracy.main, ["--sample", "3", "--seed", "1", "--json", str(tmp_path / "port.json")])
    assert rc == 0 and got == want
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    results = json.loads(got)
    assert sorted(results) == (["cmudict", "golden"] if cmudict else ["golden"])
    assert results["golden"]["words"] == len(g2p_accuracy.GOLDEN)
    if cmudict:
        assert results["cmudict"]["words"] == 3


def test_tools_raise_without_a_card_unless_the_cpu_is_asked_for():
    """The tools that run torch default to the card and raise without one;
    ``g2p_accuracy`` runs Python only and takes no device, like its script."""
    from heybuddy_tpu_torch.tools import diagnose_stream_fps, embedding_separation_probe, mel_precision_probe

    assert _stdout(g2p_accuracy.main, [])[0] == 0
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device does not raise")
    for main, argv in ((train_neural_g2p.main, ["--steps", "1"]), (train_wake_word.main, []),
                       (mel_precision_probe.main, []), (diagnose_stream_fps.main, ["--checkpoint", "head.npz"]),
                       (embedding_separation_probe.main, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)


# --- train_neural_g2p -------------------------------------------------------------------------

@pytest.mark.parametrize("cmudict", [False, True])
def test_training_table_equals_the_scripts(cmudict, tmp_path, monkeypatch):
    """The table the script hands its trainer, word for word and in order,
    and its held-out split, on the word list and with a fake dictionary."""
    if cmudict:
        path = tmp_path / "cmudict.txt"
        path.write_text(FAKE_CMUDICT, encoding="latin1")
        monkeypatch.setenv("HEYBUDDY_CMUDICT", str(path))
    captured = {}

    class Captured(Exception):
        pass

    def capture(table, **kwargs):
        captured.update(table=table, **kwargs)
        raise Captured  # the table is all this test needs

    monkeypatch.setattr(jax_g2p, "train_neural_g2p", capture)
    monkeypatch.setattr(sys, "argv", ["train_neural_g2p.py", "--heldout-every", "3", "--seed", "2"])
    with pytest.raises(Captured):
        _script("train_neural_g2p").main()
    golden, heldout, table = train_neural_g2p.training_table(3, 20000, 2, phonemizer.load_cmudict())
    assert list(table.items()) == list(captured["table"].items())
    assert heldout == dict(sorted(_script("g2p_accuracy").GOLDEN.items())[::3])
    assert not set(heldout) & set(table)
    assert ("quokka" in table) == cmudict


def test_training_from_jax_init_decodes_the_heldout_words_as_jax(tmp_path, monkeypatch):
    """``--dim 32 --layers 1`` from JAX's initial parameters, 60 steps at a
    learning rate of 1e-2 (at 20 steps every position still decodes to PAD,
    so no phone would be compared): the held-out words' logits stay within
    LOGIT_ATOL of the script's checkpoint's, they decode to the same phones,
    and the metrics JSON equals the script's."""
    args = ["--steps", "60", "--dim", "32", "--layers", "1", "--lr", "1e-2"]
    _run_script(_script("train_neural_g2p"), args + ["-o", str(tmp_path / "jax.npz"), "--json",
                                                      str(tmp_path / "jax.json")], monkeypatch)
    init = jax.tree_util.tree_map(np.asarray, jax_g2p.NeuralG2P(dim=32, layers=1).init_params(jax.random.PRNGKey(0)))
    monkeypatch.setattr(train_neural_g2p, "train_neural_g2p", functools.partial(g2p.train_neural_g2p, params=init))
    assert train_neural_g2p.main(args + ["-o", str(tmp_path / "port.npz"), "--json", str(tmp_path / "port.json"),
                                         "--cpu"]) == 0
    _, heldout, _ = train_neural_g2p.training_table()
    words = sorted(heldout)
    jax_model, jax_params = jax_g2p.NeuralG2P.load(str(tmp_path / "jax.npz"))
    model, params = g2p.NeuralG2P.load(str(tmp_path / "port.npz"))
    chars = np.stack([g2p.encode_word(w, model.max_word) for w in words])
    err = np.abs(model.apply_np(params, chars) - jax_model.apply_np(jax_params, chars)).max()
    assert err <= LOGIT_ATOL, err
    want = jax_model.decode(jax_params, words)
    got = model.decode(params, words)
    assert sum(map(len, want)) >= len(words)  # the decoding is not trivially empty
    assert got == want
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())


# --- the API walkthrough ----------------------------------------------------------------------

def test_walkthrough_trains_exports_and_its_onnx_scores_equal_the_head(tmp_path, monkeypatch, capsys):
    ckpt = tmp_path / "ckpt"
    rc = train_wake_word.main(["--cpu", "--checkpoint-dir", str(ckpt), "--dataset-dir", str(tmp_path / "data"),
                               "--positive-samples", "16", "--adversarial-samples", "16",
                               "--validation-samples", "8", "--steps", "20"])
    out = capsys.readouterr().out
    assert rc == 0
    onnx_path = ckpt / "hey-computer_final.onnx"
    assert f"exported {onnx_path}" in out and "detections: []" in out
    head = wakeword.load_model(str(ckpt / "hey-computer_final.npz"), device="cpu")
    x = _features(52, 8)
    got = WakeWordONNXModel(str(onnx_path), device="cpu")(x).reshape(-1)
    want = head(torch.from_numpy(x)).detach().numpy().reshape(-1)
    assert np.abs(got - want).max() <= ONNX_ATOL
    assert sorted(p.name for p in (tmp_path / "data").glob("*.npy")) == [
        "hey-computer-adversarial.npy", "hey-computer-testing-validation.npy", "hey-computer.npy"]
