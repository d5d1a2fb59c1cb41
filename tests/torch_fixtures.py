"""
Fixtures shared by the port's tests and ``chip_smoke.py`` (not part of the
package). Small ONNX graphs written with the port's protobuf writer, for
checking the importer where no third-party file is at hand: ``node`` /
``write_graph`` build a graph from numpy initializers, and
``silero_v4_graph`` writes a graph in the Silero VAD v4 layout (inputs
``input, sr, h, c``; outputs ``output, hn, cn``; a sample-rate ``If``; a
strided conv front end; two stacked ``LSTM`` nodes; a sigmoid head) with
seeded ``torch.nn`` weights, run through ``SileroOnnxVAD``. And
``perturbed_vits``, a VITS parameter tree with every flow non-trivial.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from heybuddy_tpu_torch.export.onnx_proto import (
    ATTR_FLOAT,
    ATTR_GRAPH,
    ATTR_INT,
    ATTR_INTS,
    ATTR_STRING,
    ATTR_TENSOR,
    OnnxAttribute,
    OnnxGraph,
    OnnxModel,
    OnnxNode,
    OnnxTensor,
    OnnxValueInfo,
    serialize_model,
)

__all__ = ["node", "write_graph", "lstm_to_onnx_weights", "silero_v4_graph", "perturbed_vits"]


def _attr(name: str, value: Any) -> OnnxAttribute:
    if isinstance(value, bool):
        return OnnxAttribute(name, int(value), ATTR_INT)
    if isinstance(value, int):
        return OnnxAttribute(name, value, ATTR_INT)
    if isinstance(value, float):
        return OnnxAttribute(name, value, ATTR_FLOAT)
    if isinstance(value, str):
        return OnnxAttribute(name, value, ATTR_STRING)
    if isinstance(value, (list, tuple)):
        return OnnxAttribute(name, [int(v) for v in value], ATTR_INTS)
    if isinstance(value, OnnxTensor):
        return OnnxAttribute(name, value, ATTR_TENSOR)
    if isinstance(value, OnnxGraph):
        return OnnxAttribute(name, value, ATTR_GRAPH)
    raise TypeError(type(value))


def node(op: str, inputs: Sequence[str], outputs: Sequence[str], **attrs: Any) -> OnnxNode:
    """One node; attributes typed from their Python values."""
    return OnnxNode(op, list(inputs), list(outputs), attributes=[_attr(k, v) for k, v in attrs.items()])


def write_graph(
    path: str,
    nodes: List[OnnxNode],
    initializers: Dict[str, np.ndarray],
    inputs: Sequence[Tuple[str, tuple]],
    outputs: Sequence[Tuple[str, tuple]],
) -> str:
    """Serialize a graph to ``path``; returns the path."""
    graph = OnnxGraph(
        "graph", nodes, [OnnxTensor(k, np.asarray(v)) for k, v in initializers.items()],
        [OnnxValueInfo(n, s) for n, s in inputs], [OnnxValueInfo(n, s) for n, s in outputs],
    )
    serialize_model(OnnxModel(graph), path)
    return path


def lstm_to_onnx_weights(lstm: torch.nn.LSTM, layer: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One layer of a ``torch.nn.LSTM`` as ONNX's W, R, B: gate blocks from torch's (i, f, g, o) to (i, o, f, c)."""
    hidden = lstm.hidden_size

    def reorder(mat: np.ndarray) -> np.ndarray:
        i, f, g, o = np.split(mat, 4, axis=0)
        return np.concatenate([i, o, f, g], axis=0)

    def weight(name: str) -> np.ndarray:
        return getattr(lstm, f"{name}_l{layer}").detach().numpy()

    b_ih = reorder(weight("bias_ih").reshape(4 * hidden, 1)).reshape(-1)
    b_hh = reorder(weight("bias_hh").reshape(4 * hidden, 1)).reshape(-1)
    return reorder(weight("weight_ih"))[None], reorder(weight("weight_hh"))[None], np.concatenate([b_ih, b_hh])[None]


def silero_v4_graph(path: str, seed: int = 8) -> Tuple[str, Tuple[torch.nn.Module, ...]]:
    """
    The Silero-v4-layout graph at ``path`` (hidden size 64) with weights of
    seeded torch layers; returns the path and the layers (conv, LSTM, head).
    """
    hidden = 64
    with torch.random.fork_rng(devices=[]):  # torch.nn draws from the global generator
        torch.manual_seed(seed)
        conv = torch.nn.Conv1d(1, hidden, 16, stride=8, padding=4)
        lstm = torch.nn.LSTM(hidden, hidden, num_layers=2)
        head = torch.nn.Linear(hidden, 1)
    w0, r0, b0 = lstm_to_onnx_weights(lstm, 0)
    w1, r1, b1 = lstm_to_onnx_weights(lstm, 1)
    then_g = OnnxGraph("then", [node("Identity", ["feat0"], ["tb_out"])], [], [], [OnnxValueInfo("tb_out", ())])
    else_g = OnnxGraph("else", [node("Mul", ["feat0", "half"], ["eb_out"])],
                       [OnnxTensor("half", np.float32(0.5).reshape(()))], [], [OnnxValueInfo("eb_out", ())])

    def ints(*values: int) -> np.ndarray:
        return np.array(values, np.int64)

    write_graph(
        path,
        [
            node("Unsqueeze", ["input", "ax1"], ["x3"]),
            node("Conv", ["x3", "cw", "cb"], ["c1"], strides=[8], pads=[4, 4], kernel_shape=[16]),
            node("Relu", ["c1"], ["cr"]),
            node("ReduceMean", ["cr"], ["feat0"], axes=[2], keepdims=0),
            node("Equal", ["sr", "sr16k"], ["is16k"]),
            node("If", ["is16k"], ["feat"], then_branch=then_g, else_branch=else_g),
            node("Unsqueeze", ["feat", "ax0"], ["seq"]),
            node("Slice", ["h", "i0", "i1", "iax0"], ["h0a"]),
            node("Slice", ["h", "i1", "i2", "iax0"], ["h0b"]),
            node("Slice", ["c", "i0", "i1", "iax0"], ["c0a"]),
            node("Slice", ["c", "i1", "i2", "iax0"], ["c0b"]),
            node("LSTM", ["seq", "w0", "r0", "b0", "", "h0a", "c0a"], ["ya", "ha", "ca"], hidden_size=hidden),
            node("Squeeze", ["ya", "ax1"], ["ya2"]),
            node("LSTM", ["ya2", "w1", "r1", "b1", "", "h0b", "c0b"], ["yb", "hb", "cb"], hidden_size=hidden),
            node("Squeeze", ["yb", "iax0"], ["yb2"]),
            node("Gemm", ["yb2", "hw", "hb2"], ["logit"], transB=1),
            node("Sigmoid", ["logit"], ["output"]),
            node("Concat", ["ha", "hb"], ["hn"], axis=0),
            node("Concat", ["ca", "cb"], ["cn"], axis=0),
        ],
        {"cw": conv.weight.detach().numpy(), "cb": conv.bias.detach().numpy(), "w0": w0, "r0": r0, "b0": b0,
         "w1": w1, "r1": r1, "b1": b1, "hw": head.weight.detach().numpy(), "hb2": head.bias.detach().numpy(),
         "sr16k": np.array(16000, np.int64), "ax0": ints(0), "ax1": ints(1), "i0": ints(0), "i1": ints(1),
         "i2": ints(2), "iax0": ints(0)},
        [("input", (1, "t")), ("sr", ()), ("h", (2, 1, hidden)), ("c", (2, 1, hidden))],
        [("output", (1, 1)), ("hn", (2, 1, hidden)), ("cn", (2, 1, hidden))],
    )
    return path, (conv, lstm, head)


def perturbed_vits(tree: Dict[str, Any], seed: int = 7) -> Dict[str, Any]:
    """A JAX-layout numpy VITS tree (``init_params``'s) with the zero-initialised flow posts,
    spline projections and affine flows made non-zero, so that every flow is non-trivial."""
    rng = np.random.default_rng(seed)

    def normal(scale: float, shape: Tuple[int, ...]) -> np.ndarray:
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    for layer in tree["flow"]["layers"]:
        layer["post"]["w"] = normal(0.1, layer["post"]["w"].shape)
    for flows in (tree["dp"].get("flows", []), tree.get("dp_posterior", {}).get("post_flows", [])):
        for layer in flows[1:]:
            layer["convflow"]["proj"]["w"] = normal(0.1, layer["convflow"]["proj"]["w"].shape)
        if flows:
            flows[0]["affine"] = {"m": normal(0.1, (2, 1)), "logs": normal(0.1, (2, 1))}
    return tree
