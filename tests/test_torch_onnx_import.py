"""The port's ONNX importer (``export/onnx_to_torch.py``) against the JAX
package's ``OnnxJaxFunction`` on the same files and numpy inputs: graphs
written by the port's ``onnx_proto`` writer with ``torch.nn`` layers for
weights (the shapes of tests/test_onnx_to_jax.py and
tests/test_frozen_import.py), both bundled browser graphs, a Silero-v4-shaped
VAD graph with its state carried, and the "onnx" featurizer backend."""

import os

import numpy as np
import pytest
import torch

from heybuddy_tpu.export.onnx_to_jax import OnnxJaxFunction
from heybuddy_tpu.models import featurizer as jax_featurizer
from heybuddy_tpu.models import vad as jax_vad
from heybuddy_tpu_torch.data import space
from heybuddy_tpu_torch.data.features import TrainingFeaturesGenerator
from heybuddy_tpu_torch.export.onnx_proto import OnnxGraph, OnnxTensor, OnnxValueInfo, parse_model
from heybuddy_tpu_torch.export.onnx_to_torch import OnnxTorchFunction
from heybuddy_tpu_torch.models import embedding_net, featurizer, vad
from torch_fixtures import lstm_to_onnx_weights, node, silero_v4_graph, write_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEECH_EMBEDDING = os.path.join(ROOT, "browser", "models", "speech-embedding.onnx")
MEL_SPECTROGRAM = os.path.join(ROOT, "browser", "models", "mel-spectrogram.onnx")
# float32 on both sides, the same products in another summation order
ATOL = 1e-5
# the whole ONNX featurizer: the port's plain mel against XLA's, then the
# imported graph (measured 1.3e-5 on (2, 23040) noise)
FEATURES_ATOL = 1e-4


def t2n(t):
    return t.detach().numpy()


def both(path):
    """The port's function on the CPU and JAX's, on one file."""
    return OnnxTorchFunction(parse_model(path), device="cpu"), OnnxJaxFunction.from_file(path)


def run_both(path, *inputs):
    """Each package's outputs as numpy lists; tensors for the port's float inputs, numpy otherwise."""
    port, ref = both(path)
    port_in = [torch.from_numpy(x) if isinstance(x, np.ndarray) and x.dtype.kind == "f" else x for x in inputs]
    got, want = port(port.params, *port_in), ref(ref.params, *inputs)
    as_list = lambda v: [np.asarray(x) for x in (v if isinstance(v, (list, tuple)) else [v])]  # noqa: E731
    return [np.asarray(g.detach()) if torch.is_tensor(g) else g for g in as_list(got)], as_list(want)


def assert_close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_conv2d_bn_pool_gemm(tmp_path):
    torch.manual_seed(0)
    conv1 = torch.nn.Conv2d(2, 8, 3, stride=2, padding=1)
    dw = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8)
    bn = torch.nn.BatchNorm2d(8).eval()
    bn.running_mean.data = torch.randn(8) * 0.1
    bn.running_var.data = torch.rand(8) + 0.5
    fc = torch.nn.Linear(8 * 4 * 4, 5)
    path = write_graph(
        str(tmp_path / "conv.onnx"),
        [
            node("Conv", ["x", "w1", "b1"], ["c1"], strides=[2, 2], pads=[1, 1, 1, 1], kernel_shape=[3, 3]),
            node("Conv", ["c1", "w2", "b2"], ["c2"], pads=[1, 1, 1, 1], group=8, kernel_shape=[3, 3]),
            node("BatchNormalization", ["c2", "g", "be", "m", "v"], ["bn"], epsilon=1e-5),
            node("Relu", ["bn"], ["r"]),
            node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2], strides=[2, 2]),
            node("Flatten", ["p"], ["f"], axis=1),
            node("Gemm", ["f", "wf", "bf"], ["y"], transB=1),
        ],
        {"w1": t2n(conv1.weight), "b1": t2n(conv1.bias), "w2": t2n(dw.weight), "b2": t2n(dw.bias),
         "g": t2n(bn.weight), "be": t2n(bn.bias), "m": bn.running_mean.numpy(), "v": bn.running_var.numpy(),
         "wf": t2n(fc.weight), "bf": t2n(fc.bias)},
        [("x", (3, 2, 16, 16))], [("y", (3, 5))],
    )
    x = np.random.default_rng(0).normal(size=(3, 2, 16, 16)).astype(np.float32)
    got, want = run_both(path, x)
    assert_close(got, want)
    with torch.no_grad():
        ref = fc(torch.nn.functional.max_pool2d(torch.relu(bn(dw(conv1(torch.from_numpy(x))))), 2).flatten(1))
    np.testing.assert_allclose(got[0], t2n(ref), atol=ATOL)


@pytest.mark.parametrize("pads,auto_pad", [([2, 2], None), ([1, 3], None), (None, "SAME_UPPER"),
                                           (None, "SAME_LOWER")])
def test_conv1d_avgpool(tmp_path, pads, auto_pad):
    """Symmetric, uneven and auto pads (uneven ones go through F.pad first); both AveragePool counts."""
    torch.manual_seed(1)
    conv = torch.nn.Conv1d(1, 6, 5, stride=3)
    conv_attrs = {"strides": [3], "kernel_shape": [5]}
    conv_attrs.update({"pads": pads} if pads else {"auto_pad": auto_pad})
    path = write_graph(
        str(tmp_path / "conv1d.onnx"),
        [
            node("Conv", ["x", "w", "b"], ["c"], **conv_attrs),
            node("Relu", ["c"], ["r"]),
            node("AveragePool", ["r"], ["y"], kernel_shape=[2], strides=[2]),
            node("AveragePool", ["r"], ["z"], kernel_shape=[3], strides=[1], pads=[1, 1]),
            node("AveragePool", ["r"], ["u"], kernel_shape=[3], strides=[2], pads=[1, 1], count_include_pad=1),
            node("MaxPool", ["r"], ["v"], kernel_shape=[3], strides=[2], pads=[0, 2]),
        ],
        {"w": t2n(conv.weight), "b": t2n(conv.bias)},
        [("x", (2, 1, 64))], [("y", ()), ("z", ()), ("u", ()), ("v", ())],
    )
    x = np.random.default_rng(1).normal(size=(2, 1, 64)).astype(np.float32)
    got, want = run_both(path, x)
    assert_close(got, want)
    if pads == [2, 2]:
        with torch.no_grad():
            ref = torch.nn.functional.avg_pool1d(torch.relu(torch.nn.functional.conv1d(
                torch.from_numpy(x), conv.weight, conv.bias, stride=3, padding=2)), 2)
        np.testing.assert_allclose(got[0], t2n(ref), atol=ATOL)


def test_lstm_two_layer_stateful(tmp_path):
    torch.manual_seed(2)
    hidden, n_in, seq, batch = 16, 10, 7, 3
    lstm = torch.nn.LSTM(n_in, hidden, num_layers=2)
    w0, r0, b0 = lstm_to_onnx_weights(lstm, 0)
    w1, r1, b1 = lstm_to_onnx_weights(lstm, 1)
    path = write_graph(
        str(tmp_path / "lstm.onnx"),
        [
            node("Slice", ["h0", "zero", "one", "ax0"], ["h0a"]),
            node("Slice", ["h0", "one", "two", "ax0"], ["h0b"]),
            node("Slice", ["c0", "zero", "one", "ax0"], ["c0a"]),
            node("Slice", ["c0", "one", "two", "ax0"], ["c0b"]),
            node("LSTM", ["x", "w0", "r0", "b0", "", "h0a", "c0a"], ["ya", "ha", "ca"], hidden_size=hidden),
            node("Squeeze", ["ya", "ax1"], ["ya2"]),
            node("LSTM", ["ya2", "w1", "r1", "b1", "", "h0b", "c0b"], ["yb", "hb", "cb"], hidden_size=hidden),
            node("Squeeze", ["yb", "ax1"], ["y"]),
            node("Concat", ["ha", "hb"], ["h"], axis=0),
            node("Concat", ["ca", "cb"], ["c"], axis=0),
        ],
        {"w0": w0, "r0": r0, "b0": b0, "w1": w1, "r1": r1, "b1": b1,
         "zero": np.array([0], np.int64), "one": np.array([1], np.int64), "two": np.array([2], np.int64),
         "ax0": np.array([0], np.int64), "ax1": np.array([1], np.int64)},
        [("x", (seq, batch, n_in)), ("h0", (2, batch, hidden)), ("c0", (2, batch, hidden))],
        [("y", (seq, batch, hidden)), ("h", (2, batch, hidden)), ("c", (2, batch, hidden))],
    )
    rng = np.random.default_rng(2)
    x, h0, c0 = (rng.normal(size=s).astype(np.float32) for s in
                 ((seq, batch, n_in), (2, batch, hidden), (2, batch, hidden)))
    got, want = run_both(path, x, h0, c0)
    assert_close(got, want)
    with torch.no_grad():
        y_ref, (h_ref, c_ref) = lstm(torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)))
    for g, r in zip(got, (y_ref, h_ref, c_ref)):
        np.testing.assert_allclose(g, t2n(r), atol=ATOL)


def test_static_shape_arithmetic_stays_on_the_host(tmp_path):
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape, plus integer Div, Range and ConstantOfShape:
    folded in numpy, so the Reshape target never becomes a tensor."""
    path = write_graph(
        str(tmp_path / "shape.onnx"),
        [
            node("Shape", ["x"], ["s"]),
            node("Gather", ["s", "idx0"], ["d0"], axis=0),
            node("Unsqueeze", ["d0", "ax0"], ["d0u"]),
            node("Concat", ["d0u", "minus1"], ["target"], axis=0),
            node("Reshape", ["x", "target"], ["y"]),
            node("Div", ["neg7", "two"], ["q"]),
            node("Range", ["zero", "d0", "one"], ["r"]),
            node("ConstantOfShape", ["d0u"], ["z"]),
        ],
        {"idx0": np.array(0, np.int64), "ax0": np.array([0], np.int64), "minus1": np.array([-1], np.int64),
         "neg7": np.array(-7, np.int64), "two": np.array(2, np.int64), "zero": np.array(0, np.int64),
         "one": np.array(1, np.int64)},
        [("x", (4, 5, 6))], [("y", (4, 30)), ("q", ()), ("r", (4,)), ("z", (4,))],
    )
    x = np.random.default_rng(0).normal(size=(4, 5, 6)).astype(np.float32)
    port, _ = both(path)
    y, q, r, z = port(port.params, torch.from_numpy(x))
    assert torch.is_tensor(y) and not any(torch.is_tensor(v) for v in (q, r, z))
    got, want = run_both(path, x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], x.reshape(4, 30))
    assert int(got[1]) == -3  # ONNX integer Div truncates toward zero


def if_graph(tmp_path):
    then_g = OnnxGraph("then", [node("Mul", ["x", "twoc"], ["o"])],
                       [OnnxTensor("twoc", np.float32(2.0).reshape(()))], [], [OnnxValueInfo("o", ())])
    else_g = OnnxGraph("else", [node("Add", ["x", "onec"], ["o2"])],
                       [OnnxTensor("onec", np.float32(1.0).reshape(()))], [], [OnnxValueInfo("o2", ())])
    return write_graph(
        str(tmp_path / "if.onnx"),
        [node("Equal", ["sr", "sr16k"], ["is16k"]),
         node("If", ["is16k"], ["y"], then_branch=then_g, else_branch=else_g)],
        {"sr16k": np.array(16000, np.int64)}, [("x", (3,)), ("sr", ())], [("y", (3,))],
    )


@pytest.mark.parametrize("sr", [16000, 8000])
def test_if_static_condition_folds(tmp_path, sr):
    path = if_graph(tmp_path)
    x = np.arange(3, dtype=np.float32)
    got, want = run_both(path, x, np.array(sr, np.int64))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], x * 2 if sr == 16000 else x + 1)
    port, _ = both(path)
    with pytest.raises(NotImplementedError, match="device condition"):
        port(port.params, torch.from_numpy(x), torch.tensor(sr))


def test_google_style_embedding_graph(tmp_path):
    """NHWC input -> Transpose -> conv stack -> conv2d_19 [n, 1, 1, 96], through load_from_onnx too."""
    torch.manual_seed(3)
    c1 = torch.nn.Conv2d(1, 24, (5, 5), stride=(2, 2), padding=(2, 2))
    c2 = torch.nn.Conv2d(24, 48, (5, 5), stride=(2, 2), padding=(2, 2))
    c3 = torch.nn.Conv2d(48, 96, (19, 8))
    path = write_graph(
        str(tmp_path / "emb.onnx"),
        [
            node("Transpose", ["input"], ["t"], perm=[0, 3, 1, 2]),
            node("Conv", ["t", "w1", "b1"], ["h1"], strides=[2, 2], pads=[2, 2, 2, 2], kernel_shape=[5, 5]),
            node("Relu", ["h1"], ["r1"]),
            node("Conv", ["r1", "w2", "b2"], ["h2"], strides=[2, 2], pads=[2, 2, 2, 2], kernel_shape=[5, 5]),
            node("Relu", ["h2"], ["r2"]),
            node("Conv", ["r2", "w3", "b3"], ["h3"], kernel_shape=[19, 8]),
            node("Transpose", ["h3"], ["conv2d_19"], perm=[0, 2, 3, 1]),
        ],
        {"w1": t2n(c1.weight), "b1": t2n(c1.bias), "w2": t2n(c2.weight), "b2": t2n(c2.bias),
         "w3": t2n(c3.weight), "b3": t2n(c3.bias)},
        [("input", ("n", 76, 32, 1))], [("conv2d_19", ("n", 1, 1, 96))],
    )
    x = np.random.default_rng(3).normal(size=(4, 76, 32, 1)).astype(np.float32)
    got, want = run_both(path, x)
    assert got[0].shape == (4, 1, 1, 96)
    assert_close(got, want)
    net = embedding_net.load_from_onnx(path, device="cpu")
    assert net.output_name == "conv2d_19" and net.input_rank == 4
    out = net.apply(torch.from_numpy(x[..., 0]))  # rank 3 in, NHWC channel added
    np.testing.assert_allclose(out.numpy(), want[0].reshape(4, 96), atol=ATOL)


def test_bundled_speech_embedding_graph():
    """browser/models/speech-embedding.onnx (the v8 embedding at full width) on (4, 76, 32)."""
    x = np.random.default_rng(4).normal(-4.0, 2.0, (4, 76, 32)).astype(np.float32)
    got, want = run_both(SPEECH_EMBEDDING, x)
    assert got[0].shape == (4, 96)
    assert_close(got, want)
    net = embedding_net.load_from_onnx(SPEECH_EMBEDDING, device="cpu")
    assert net.output_name == "output" and net.input_rank == 3
    np.testing.assert_allclose(net.apply(torch.from_numpy(x[..., None])).numpy(), want[0], atol=ATOL)


def test_bundled_mel_spectrogram_graph():
    """browser/models/mel-spectrogram.onnx on (1, 17280) int16-range noise (4.8e-7 measured)."""
    x = np.random.default_rng(5).normal(0.0, 1000.0, (1, 17280)).astype(np.float32)
    got, want = run_both(MEL_SPECTROGRAM, x)
    assert got[0].shape == (1, 105, 32)
    assert_close(got, want)


def test_silero_onnx_vad_state_carried(tmp_path):
    """SileroOnnxVAD against JAX's over chunks of several lengths (one padded, one of two chunks),
    the state carried; reset; a torch forward of one chunk; the sample-rate check."""
    path, (conv, lstm, head) = silero_v4_graph(str(tmp_path / "silero-vad.onnx"))
    port, ref = vad.SileroOnnxVAD(path, device="cpu"), jax_vad.SileroOnnxVAD(path)
    assert not port._v5
    rng = np.random.default_rng(3)
    for n in (512, 512, 300, 1024, 512):
        chunk = rng.normal(0, 0.3, n).astype(np.float32)
        assert abs(port(chunk) - ref(chunk)) <= ATOL
        for s_port, s_ref in zip(port._state, ref._state):
            np.testing.assert_allclose(s_port.numpy(), np.asarray(s_ref), atol=ATOL)
    chunk = rng.normal(0, 0.3, 512).astype(np.float32)
    port.reset()
    assert all(not s.any() for s in port._state)
    with torch.no_grad():
        feat = torch.relu(conv(torch.from_numpy(chunk)[None, None])).mean(dim=2)
        want = torch.sigmoid(head(lstm(feat[None])[0][0]))
    assert port(chunk) == pytest.approx(float(want[0, 0]), abs=ATOL)
    with pytest.raises(ValueError, match="16000 Hz"):
        port(chunk, sample_rate=8000)
    assert port.trim(np.zeros(16000, np.float32), min_start=2000).ndim == 1


@pytest.fixture()
def fresh_featurizers(monkeypatch):
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.delenv("HEYBUDDY_EMBEDDING_ONNX", raising=False)


def test_speech_embeddings_onnx_backend_matches_jax(fresh_featurizers):
    """SpeechEmbeddings(onnx_path=bundled graph): K3's plain version, the window gather and the
    graph against JAX's featurize_batch_per_window on (2, 23040); featurize_device alike."""
    audio = np.random.default_rng(6).normal(0.0, 0.1, (2, 23040)).astype(np.float32)
    port = featurizer.SpeechEmbeddings(onnx_path=SPEECH_EMBEDDING, device="cpu")
    assert port.backend == "onnx" and port.net is None
    got = port(audio)
    net = jax_net_from(SPEECH_EMBEDDING)
    want = np.asarray(jax_featurizer.featurize_batch_per_window(net.apply, net.params, audio * 32767.0))
    assert got.shape == want.shape == (2, 16, 96)
    np.testing.assert_allclose(got, want, atol=FEATURES_ATOL, rtol=0)
    dev_out, rows = port.featurize_device(audio)
    assert rows == 2
    np.testing.assert_array_equal(dev_out.numpy(), got)
    short = port(np.zeros(17280, np.float32))
    assert short.shape == (1, 4, 96)


def jax_net_from(path):
    from heybuddy_tpu.models import embedding_net as jax_net

    return jax_net.load_from_onnx(path)


def test_onnx_space_id_keys_on_backend(fresh_featurizers, monkeypatch, tmp_path):
    """The "onnx" space id equals JAX's for the same file and differs from the trunkpool one;
    HEYBUDDY_EMBEDDING_ONNX selects the backend; hosted sets are then compatible."""
    onnx = featurizer.SpeechEmbeddings(onnx_path=SPEECH_EMBEDDING, device="cpu")
    trunkpool = featurizer.SpeechEmbeddings(device="cpu")
    jax_onnx = jax_featurizer.SpeechEmbeddings(onnx_path=SPEECH_EMBEDDING)
    assert onnx.space_id == jax_onnx.space_id
    assert onnx.space_id != trunkpool.space_id
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_ONNX", SPEECH_EMBEDDING)
    shared = featurizer.get_speech_embeddings(device="cpu")
    assert shared.backend == "onnx" and shared.space_id == onnx.space_id
    assert space.active_space(device="cpu")["backend"] == "onnx"
    assert space.hosted_sets_compatible("test", device="cpu")
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_ONNX", str(tmp_path / "missing.onnx"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        featurizer.SpeechEmbeddings(device="cpu")


def test_fused_route_needs_the_trunkpool_embedding(fresh_featurizers, monkeypatch, tmp_path):
    """formant-device feeds the fused plans -> features path only under the native embedding: an
    imported ONNX embedding has no K2 to fuse into, so its caches take the classic route."""
    gen = TrainingFeaturesGenerator("hey buddy", directory=str(tmp_path), tts_backend="formant-device", device="cpu")
    assert gen._use_fused_pipeline()
    monkeypatch.setattr(featurizer, "_GLOBAL_EMBEDDINGS", {})
    monkeypatch.setenv("HEYBUDDY_EMBEDDING_ONNX", SPEECH_EMBEDDING)
    assert not gen._use_fused_pipeline()


def test_silero_onnx_vad_v5_layout(tmp_path):
    """The v5 layout (inputs input, state, sr; outputs output, stateN with state (2, 1, 128)): one
    LSTM over the conv features, its h and c in one state tensor; port against JAX, state carried."""
    torch.manual_seed(9)
    hidden = 128
    conv = torch.nn.Conv1d(1, hidden, 16, stride=8, padding=4)
    lstm = torch.nn.LSTM(hidden, hidden)
    head = torch.nn.Linear(hidden, 1)
    w, r, b = lstm_to_onnx_weights(lstm, 0)
    ints = lambda *v: np.array(v, np.int64)  # noqa: E731
    path = write_graph(
        str(tmp_path / "silero-v5.onnx"),
        [
            node("Unsqueeze", ["input", "ax1"], ["x3"]),
            node("Conv", ["x3", "cw", "cb"], ["c1"], strides=[8], pads=[4, 4], kernel_shape=[16]),
            node("Relu", ["c1"], ["cr"]),
            node("ReduceMean", ["cr"], ["feat"], axes=[2], keepdims=0),
            node("Unsqueeze", ["feat", "ax0"], ["seq"]),
            node("Slice", ["state", "i0", "i1", "ax0"], ["h0"]),
            node("Slice", ["state", "i1", "i2", "ax0"], ["c0"]),
            node("LSTM", ["seq", "w", "r", "b", "", "h0", "c0"], ["y", "hn", "cn"], hidden_size=hidden),
            node("Squeeze", ["y", "ax01"], ["y2"]),
            node("Gemm", ["y2", "hw", "hb"], ["logit"], transB=1),
            node("Sigmoid", ["logit"], ["output"]),
            node("Concat", ["hn", "cn"], ["stateN"], axis=0),
        ],
        {"cw": t2n(conv.weight), "cb": t2n(conv.bias), "w": w, "r": r, "b": b, "hw": t2n(head.weight),
         "hb": t2n(head.bias), "ax0": ints(0), "ax1": ints(1), "ax01": ints(0, 1), "i0": ints(0), "i1": ints(1),
         "i2": ints(2)},
        [("input", (1, "t")), ("state", (2, 1, hidden)), ("sr", ())],
        [("output", (1, 1)), ("stateN", (2, 1, hidden))],
    )
    port, ref = vad.SileroOnnxVAD(path, device="cpu"), jax_vad.SileroOnnxVAD(path)
    assert port._v5 and port._state[0].shape == (2, 1, hidden)
    rng = np.random.default_rng(7)
    for n in (512, 512, 800):
        chunk = rng.normal(0, 0.3, n).astype(np.float32)
        assert abs(port(chunk) - ref(chunk)) <= ATOL
        np.testing.assert_allclose(port._state[0].numpy(), np.asarray(ref._state[0]), atol=ATOL)
