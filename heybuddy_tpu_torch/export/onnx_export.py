"""
ONNX export of the browser bundle, in numpy: the wake-word MLP head, the
mel spectrogram and the embedding network.

* ``export_mlp_model``: input "input" float[1,16,96] -> output "output"
  float[1,1]. It is built from the checkpoint's numpy parameter tree and
  config (``models/wakeword.read_checkpoint``), so ``convert`` needs neither
  torch tensors nor a device. The transformer head has no exporter in
  either package.
* ``export_mel_spectrogram``: audio float[1, num_samples] -> the scaled
  log-mel float[1, frames, 32] (hop reshape, frame gather, windowed-DFT
  MatMul, power, mel MatMul, ``log(x + 1e-6)/10 + 2``).
* ``export_embedding_net``: stacked windows float[batch, 76, 32] ->
  embeddings float[batch, 96], from an embedding parameter tree (default:
  ``embedding_net.default_params()``), computed in float32.

The graphs use only portable primitive ops (MatMul, Add, Sub, Mul, Div, Sqrt,
ReduceMean, Sigmoid, Flatten, Gather, Reshape, Slice, Log, Erf, Softmax,
Transpose), LayerNorm, RMS normalisation, SiLU and GELU decomposed, so they
load on every ONNX Runtime execution provider. Each exporter writes the same
bytes as the JAX package's for the same parameters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from heybuddy_tpu_torch.export.onnx_proto import (
    ATTR_INT,
    ATTR_INTS,
    FLOAT,
    OnnxAttribute,
    OnnxGraph,
    OnnxModel,
    OnnxNode,
    OnnxTensor,
    OnnxValueInfo,
    serialize_model,
)
from heybuddy_tpu_torch.models.wakeword import HALF_LAYER_INDICES

__all__ = ["export_mlp_model", "build_mlp_graph", "export_mel_spectrogram", "export_embedding_net"]


class _GraphBuilder:
    def __init__(self) -> None:
        self.nodes: List[OnnxNode] = []
        self.initializers: List[OnnxTensor] = []
        self._counter = 0

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def constant(self, hint: str, array: np.ndarray) -> str:
        name = self.fresh(hint)
        self.initializers.append(OnnxTensor(name, np.ascontiguousarray(array)))
        return name

    def op(self, op_type: str, inputs: List[str], hint: str,
           attributes: Optional[List[OnnxAttribute]] = None) -> str:
        out = self.fresh(hint)
        self.nodes.append(
            OnnxNode(op_type, inputs, [out], name=out, attributes=attributes or [])
        )
        return out

    def layernorm(self, x: str, gamma: np.ndarray, beta: np.ndarray, eps: float = 1e-5) -> str:
        axes = self.constant("ln_axes", np.asarray([-1], dtype=np.int64))
        mean = self.op("ReduceMean", [x, axes], "ln_mean")
        centered = self.op("Sub", [x, mean], "ln_center")
        sq = self.op("Mul", [centered, centered], "ln_sq")
        var = self.op("ReduceMean", [sq, axes], "ln_var")
        eps_c = self.constant("ln_eps", np.asarray(eps, dtype=np.float32))
        var_eps = self.op("Add", [var, eps_c], "ln_vareps")
        std = self.op("Sqrt", [var_eps], "ln_std")
        normed = self.op("Div", [centered, std], "ln_norm")
        scaled = self.op("Mul", [normed, self.constant("ln_g", gamma)], "ln_scale")
        return self.op("Add", [scaled, self.constant("ln_b", beta)], "ln_out")

    def linear(self, x: str, weight: np.ndarray, bias: np.ndarray, hint: str) -> str:
        mm = self.op("MatMul", [x, self.constant(f"{hint}_w", weight)], f"{hint}_mm")
        return self.op("Add", [mm, self.constant(f"{hint}_b", bias)], f"{hint}_out")

    def silu(self, x: str) -> str:
        sig = self.op("Sigmoid", [x], "silu_sig")
        return self.op("Mul", [x, sig], "silu_out")

    def activation(self, x: str, kind: str) -> str:
        """Emit the model's configured activation — exporting SiLU for a
        relu/gelu/tanh-trained model silently changes every score."""
        if kind == "silu":
            return self.silu(x)
        if kind == "relu":
            return self.op("Relu", [x], "relu_out")
        if kind == "tanh":
            return self.op("Tanh", [x], "tanh_out")
        if kind == "gelu":
            # exact (erf) gelu, matching jax.nn.gelu(approximate=False)
            inv_sqrt2 = self.constant("gelu_is2", np.asarray(0.7071067811865476, np.float32))
            erf = self.op("Erf", [self.op("Mul", [x, inv_sqrt2], "gelu_scaled")], "gelu_erf")
            one = self.constant("gelu_one", np.asarray(1.0, np.float32))
            half = self.constant("gelu_half", np.asarray(0.5, np.float32))
            gate = self.op("Mul", [self.op("Add", [erf, one], "gelu_1p"), half], "gelu_gate")
            return self.op("Mul", [x, gate], "gelu_out")
        raise NotImplementedError(f"ONNX export for activation {kind!r}")

    def mlp(self, x: str, params: Dict[str, Any], hint: str, activation: str = "silu") -> str:
        hidden = self.linear(
            x, np.asarray(params["hidden"]["w"]), np.asarray(params["hidden"]["b"]), f"{hint}_hidden"
        )
        act = self.activation(hidden, activation)
        if "gate" in params:
            gate = self.linear(
                x, np.asarray(params["gate"]["w"]), np.asarray(params["gate"]["b"]), f"{hint}_gate"
            )
            act = self.op("Mul", [act, gate], f"{hint}_gated")
        return self.linear(
            act, np.asarray(params["output"]["w"]), np.asarray(params["output"]["b"]), f"{hint}_proj"
        )


def build_mlp_graph(params: Dict[str, Any], config: Dict[str, Any]) -> OnnxGraph:
    """The ONNX graph of a perceptron head: its parameter tree and ``config()``."""
    gb = _GraphBuilder()
    activation = config.get("activation", "silu")
    half_indices = HALF_LAYER_INDICES if config["use_half_layers"] else []

    flat = gb.op(
        "Flatten", ["input"], "flatten", [OnnxAttribute("axis", 1, ATTR_INT)]
    )
    normed = gb.layernorm(
        flat, np.asarray(params["norm_in"]["g"]), np.asarray(params["norm_in"]["b"])
    )
    states = gb.mlp(normed, params["mlp_in"], "mlp_in", activation)

    for i, (indices, half) in enumerate(zip(half_indices, params["half_layers"])):
        idx = gb.constant(f"half{i}_idx", np.asarray(indices, dtype=np.int64))
        gathered = gb.op(
            "Gather", ["input", idx], f"half{i}_gather", [OnnxAttribute("axis", 1, ATTR_INT)]
        )
        half_flat = gb.op(
            "Flatten", [gathered], f"half{i}_flat", [OnnxAttribute("axis", 1, ATTR_INT)]
        )
        half_norm = gb.layernorm(
            half_flat, np.asarray(half["norm"]["g"]), np.asarray(half["norm"]["b"])
        )
        half_out = gb.mlp(half_norm, half["mlp"], f"half{i}", activation)
        states = gb.op("Add", [states, half_out], f"half{i}_residual")

    for i, layer in enumerate(params["layers"]):
        normed = gb.layernorm(
            states, np.asarray(layer["norm"]["g"]), np.asarray(layer["norm"]["b"])
        )
        states = gb.mlp(normed, layer["mlp"], f"layer{i}", activation)

    normed = gb.layernorm(
        states, np.asarray(params["norm_out"]["g"]), np.asarray(params["norm_out"]["b"])
    )
    logits = gb.mlp(normed, params["mlp_out"], "mlp_out", activation)
    gb.nodes.append(OnnxNode("Sigmoid", [logits], ["output"], name="output_sigmoid"))

    frames, dim = config["input_shape"]
    return OnnxGraph(
        name="heybuddy_wakeword",
        nodes=gb.nodes,
        initializers=gb.initializers,
        inputs=[OnnxValueInfo("input", (1, frames, dim), FLOAT)],
        outputs=[OnnxValueInfo("output", (1, 1), FLOAT)],
    )


def _check_opset(opset_version: int) -> None:
    if opset_version < 18:
        # the exporter emits ReduceMean with axes as a runtime input (the
        # opset>=18 form); an older opset stamp would not load
        raise ValueError(
            f"opset_version {opset_version} not supported: the exporter emits "
            "opset-18+ graphs (ReduceMean with axes input); use >= 18"
        )


def export_mlp_model(
    params: Dict[str, Any], config: Dict[str, Any], path: str, opset_version: int = 19
) -> None:
    """Write the perceptron head (parameter tree + config) as ``.onnx``."""
    _check_opset(opset_version)
    serialize_model(OnnxModel(build_mlp_graph(params, config), opset_version=opset_version), path)


def export_mel_spectrogram(path: str, num_samples: int = 17280, opset_version: int = 19) -> None:
    """
    Write the mel-spectrogram transform as ``.onnx`` for the browser runtime,
    which feeds 1.08 s (17280-sample) batches: input[1, num_samples] -> hop
    reshape -> frame gather -> windowed-DFT MatMul -> power -> mel MatMul ->
    ``log/10 + 2`` -> output[1, frames, 32] (the log scaling baked in).
    """
    _check_opset(opset_version)
    from heybuddy_tpu_torch.constants import (
        MEL_BINS,
        MEL_HOP_LENGTH,
        MEL_LOG_EPS,
        MEL_N_FFT,
        MEL_SCALE_ADD,
        MEL_SCALE_DIV,
        MEL_WIN_LENGTH,
    )
    from heybuddy_tpu_torch.ops.melspec import dft_basis, mel_band_freqs, mel_filterbank, num_frames

    if num_samples % MEL_HOP_LENGTH:
        raise ValueError(f"num_samples ({num_samples}) must be a whole number of {MEL_HOP_LENGTH}-sample hops")
    n_hops = num_samples // MEL_HOP_LENGTH
    n_frames = num_frames(num_samples)
    hops_per_frame = -(-MEL_N_FFT // MEL_HOP_LENGTH)
    n_freqs = mel_band_freqs()

    basis = dft_basis(MEL_N_FFT, MEL_WIN_LENGTH, n_freqs)  # (512, 2 n_freqs)
    padded = np.zeros((hops_per_frame * MEL_HOP_LENGTH, basis.shape[1]), dtype=np.float32)
    padded[: basis.shape[0]] = basis
    fb = mel_filterbank()[:n_freqs]

    b = _GraphBuilder()
    hop_shape = b.constant("hop_shape", np.asarray([n_hops, MEL_HOP_LENGTH], dtype=np.int64))
    hops = b.op("Reshape", ["input", hop_shape], "hops")
    frame_idx = np.arange(n_frames, dtype=np.int64)[:, None] + np.arange(hops_per_frame, dtype=np.int64)
    gathered = b.op("Gather", [hops, b.constant("frame_idx", frame_idx)], "frame_hops",
                    [OnnxAttribute("axis", 0, ATTR_INT)])  # (frames, 4, 160)
    frame_shape = b.constant(
        "frame_shape", np.asarray([n_frames, hops_per_frame * MEL_HOP_LENGTH], dtype=np.int64))
    frames = b.op("Reshape", [gathered, frame_shape], "frames")
    spectrum = b.op("MatMul", [frames, b.constant("dft_basis", padded)], "spectrum")

    slice_re = [
        b.constant("re_starts", np.asarray([0], dtype=np.int64)),
        b.constant("re_ends", np.asarray([n_freqs], dtype=np.int64)),
        b.constant("re_axes", np.asarray([1], dtype=np.int64)),
    ]
    slice_im = [
        b.constant("im_starts", np.asarray([n_freqs], dtype=np.int64)),
        b.constant("im_ends", np.asarray([2 * n_freqs], dtype=np.int64)),
        b.constant("im_axes", np.asarray([1], dtype=np.int64)),
    ]
    re = b.op("Slice", [spectrum] + slice_re, "re")
    im = b.op("Slice", [spectrum] + slice_im, "im")
    power = b.op("Add", [b.op("Mul", [re, re], "re2"), b.op("Mul", [im, im], "im2")], "power")
    mel = b.op("MatMul", [power, b.constant("mel_fb", fb)], "mel")
    eps = b.constant("eps", np.asarray(MEL_LOG_EPS, dtype=np.float32))
    logmel = b.op("Log", [b.op("Add", [mel, eps], "mel_eps")], "logmel")
    scaled = b.op("Div", [logmel, b.constant("scale_div", np.asarray(MEL_SCALE_DIV, dtype=np.float32))], "div")
    shifted = b.op("Add", [scaled, b.constant("scale_add", np.asarray(MEL_SCALE_ADD, dtype=np.float32))],
                   "shift")
    out_shape = b.constant("out_shape", np.asarray([1, n_frames, MEL_BINS], dtype=np.int64))
    b.nodes.append(OnnxNode("Reshape", [shifted, out_shape], ["output"], name="output_reshape"))

    graph = OnnxGraph(
        name="heybuddy_mel_spectrogram",
        nodes=b.nodes,
        initializers=b.initializers,
        inputs=[OnnxValueInfo("input", (1, num_samples), FLOAT)],
        outputs=[OnnxValueInfo("output", (1, n_frames, MEL_BINS), FLOAT)],
    )
    serialize_model(OnnxModel(graph, opset_version=opset_version), path)


def export_embedding_net(path: str, params: Any = None, config: Any = None, opset_version: int = 19) -> None:
    """
    Write the embedding network as ``.onnx`` for the browser runtime: input
    "input" float[batch, 76, 32] (a dynamic batch of stacked windows) ->
    output "output" float[batch, 96]. ``params`` is the JAX-layout numpy
    tree (default ``embedding_net.default_params()``); ``config`` an
    ``EmbeddingNetConfig`` (default: the default architecture).
    """
    _check_opset(opset_version)
    from heybuddy_tpu_torch.models import embedding_net

    if params is None:
        params = embedding_net.default_params()
    cfg = config or embedding_net.EmbeddingNetConfig()

    b = _GraphBuilder()

    def f32(value: Any) -> np.ndarray:
        return np.asarray(value, dtype=np.float32)

    def rms_scale(x: str, hint: str) -> str:
        # centred RMS normalisation, as embedding_net._rms_scale
        axes = b.constant(f"{hint}_axes", np.asarray([-1], dtype=np.int64))
        mean = b.op("ReduceMean", [x, axes], f"{hint}_mean")
        centered = b.op("Sub", [x, mean], f"{hint}_centered")
        sq = b.op("Mul", [centered, centered], f"{hint}_sq")
        ms = b.op("ReduceMean", [sq, axes], f"{hint}_ms")
        eps = b.constant(f"{hint}_eps", np.asarray(1e-6, dtype=np.float32))
        rms = b.op("Sqrt", [b.op("Add", [ms, eps], f"{hint}_mse")], f"{hint}_rms")
        return b.op("Div", [centered, rms], f"{hint}_out")

    def matmul(x: str, dense: Dict[str, Any], hint: str) -> str:
        mm = b.op("MatMul", [x, b.constant(f"{hint}_w", f32(dense["w"]))], f"{hint}_mm")
        return b.op("Add", [mm, b.constant(f"{hint}_b", f32(dense["b"]))], f"{hint}_add")

    def gelu(x: str, hint: str) -> str:
        inv_sqrt2 = b.constant(f"{hint}_is2", np.asarray(1.0 / np.sqrt(2.0), dtype=np.float32))
        erf = b.op("Erf", [b.op("Mul", [x, inv_sqrt2], f"{hint}_scaled")], f"{hint}_erf")
        one = b.constant(f"{hint}_one", np.asarray(1.0, dtype=np.float32))
        half = b.constant(f"{hint}_half", np.asarray(0.5, dtype=np.float32))
        return b.op("Mul", [b.op("Mul", [x, half], f"{hint}_xh"), b.op("Add", [erf, one], f"{hint}_erf1")],
                    f"{hint}_out")

    patch_shape = b.constant("patch_shape", np.asarray([0, cfg.window_patches, cfg.patch_dim], dtype=np.int64))
    patches = b.op("Reshape", ["input", patch_shape], "patches")
    x = matmul(rms_scale(patches, "in_norm"), params["patch_proj"], "patch_proj")
    for i, block in enumerate(params["trunk"]):
        h = gelu(matmul(rms_scale(x, f"t{i}_norm"), block["up"], f"t{i}_up"), f"t{i}_gelu")
        x = b.op("Add", [x, matmul(h, block["down"], f"t{i}_down")], f"t{i}_res")

    x = b.op("Add", [x, b.constant("pos", f32(params["pos"]))], "posadd")
    scores = b.op("MatMul", [x, b.constant("pool_q", f32(params["pool_query"]))], "scores")
    weights = b.op("Softmax", [scores], "pool_softmax", [OnnxAttribute("axis", 1, ATTR_INT)])
    weights_t = b.op("Transpose", [weights], "weights_t", [OnnxAttribute("perm", [0, 2, 1], ATTR_INTS)])
    pooled = b.op("MatMul", [weights_t, x], "pooled")  # (batch, heads, hidden)
    pool_shape = b.constant("pool_shape", np.asarray([0, cfg.pool_heads * cfg.hidden_dim], dtype=np.int64))
    flat = b.op("Reshape", [pooled, pool_shape], "pooled_flat")
    head = matmul(rms_scale(flat, "head_norm"), params["head"], "head")
    b.nodes.append(OnnxNode("Identity", [head], ["output"], name="output_identity"))

    graph = OnnxGraph(
        name="heybuddy_speech_embedding",
        nodes=b.nodes,
        initializers=b.initializers,
        inputs=[OnnxValueInfo("input", ("batch", cfg.window_size, cfg.mel_bins), FLOAT)],
        outputs=[OnnxValueInfo("output", ("batch", cfg.embedding_dim), FLOAT)],
    )
    serialize_model(OnnxModel(graph, opset_version=opset_version), path)
