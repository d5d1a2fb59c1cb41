"""The port's numpy ONNX exporter and runner against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

from heybuddy_tpu.export.onnx_numpy import OnnxRunner as JaxRunner
from heybuddy_tpu.models import wakeword as jax_wakeword
from heybuddy_tpu_torch.cli import main as cli_main
from heybuddy_tpu_torch.convert import wakeword_params_to_numpy
from heybuddy_tpu_torch.export.onnx_export import export_mlp_model
from heybuddy_tpu_torch.export.onnx_numpy import OnnxRunner, run_model
from heybuddy_tpu_torch.models import wakeword

# the exported graph against the port's forward: both float32, the graph's
# LayerNorm decomposed (mean, centred square, sqrt, divide) where the module
# uses rsqrt, so only rounding differs
ONNX_ATOL = 1e-5


@pytest.mark.parametrize(
    "options",
    [
        dict(layer_dim=96, num_layers=2),
        dict(layer_dim=32, num_layers=1, use_half_layers=True),
        dict(layer_dim=24, num_layers=0, activation="relu"),
        dict(layer_dim=24, num_layers=1, use_gating=False, activation="tanh"),
    ],
)
def test_export_writes_the_jax_bytes(tmp_path, options):
    jax_model = jax_wakeword.WakeWordMLPModel(seed=5, **options)
    tree = jax.tree_util.tree_map(np.asarray, jax_model.params)
    model = wakeword.WakeWordMLPModel(params=tree, device="cpu", **options)
    ref_path, path = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    jax_model.save_onnx(ref_path)
    model.save_onnx(path)
    with open(ref_path, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()

    x = np.random.default_rng(1).normal(size=(6, 16, 96)).astype(np.float32)
    got = OnnxRunner.from_file(path)(input=x)["output"]
    assert got.shape == (6, 1)
    want = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ONNX_ATOL)
    np.testing.assert_array_equal(got, JaxRunner.from_file(ref_path)(input=x)["output"])
    np.testing.assert_array_equal(run_model(path, input=x)["output"], got)


def test_convert_cli_from_either_package(tmp_path, capsys):
    """convert reads the npz alone: a JAX checkpoint converts to the JAX exporter's bytes."""
    jax_model = jax_wakeword.WakeWordMLPModel(layer_dim=32, num_layers=1, use_half_layers=True, seed=2)
    ckpt = str(tmp_path / "head.npz")
    jax_model.save(ckpt)
    jax_model.save_onnx(str(tmp_path / "jax.onnx"))
    assert cli_main(["convert", ckpt]) == 0
    assert capsys.readouterr().out.strip() == f"Wrote {tmp_path / 'head.onnx'}"
    assert (tmp_path / "head.onnx").read_bytes() == (tmp_path / "jax.onnx").read_bytes()
    out = str(tmp_path / "named.onnx")
    assert cli_main(["convert", ckpt, out, "--opset-version", "18"]) == 0
    with pytest.raises(ValueError, match="opset_version 17"):
        cli_main(["convert", ckpt, out, "--opset-version", "17"])


def test_transformer_has_no_onnx_export(tmp_path):
    model = wakeword.WakeWordTransformerModel(dim=16, num_layers=1, device="cpu")
    with pytest.raises(NotImplementedError, match="perceptron"):
        model.save_onnx(str(tmp_path / "t.onnx"))
    ckpt = str(tmp_path / "t.npz")
    wakeword.save_model(model, ckpt)
    with pytest.raises(NotImplementedError, match="perceptron"):
        cli_main(["convert", ckpt])


def test_exporter_takes_the_numpy_tree(tmp_path):
    """save_onnx exports the module's tree through the reverse bridge."""
    model = wakeword.WakeWordMLPModel(layer_dim=16, num_layers=1, seed=4, device="cpu")
    a, b = str(tmp_path / "a.onnx"), str(tmp_path / "b.onnx")
    model.save_onnx(a)
    export_mlp_model(wakeword_params_to_numpy(model), model.config(), b)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
