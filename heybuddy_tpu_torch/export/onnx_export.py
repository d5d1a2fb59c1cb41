"""
ONNX export of the wake-word MLP head for the browser runtime, in numpy.

Input "input" float[1,16,96] -> output "output" float[1,1]. The graph uses
only portable primitive ops (MatMul/Add/Sub/Mul/Div/Sqrt/ReduceMean/Sigmoid/
Flatten/Gather), LayerNorm and SiLU decomposed, so it loads on every ONNX
Runtime execution provider. It is built from the checkpoint's numpy parameter
tree and config (``models/wakeword.read_checkpoint``), so ``convert`` needs
neither torch tensors nor a device, and it writes the same bytes as the JAX
package's exporter for the same parameters. The transformer head has no
exporter in either package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from heybuddy_tpu_torch.export.onnx_proto import (
    ATTR_INT,
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

__all__ = ["export_mlp_model", "build_mlp_graph"]


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
