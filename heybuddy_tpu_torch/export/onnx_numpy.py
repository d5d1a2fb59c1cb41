"""
Numpy evaluator of exported ONNX graphs: checks an exported head against the
model without an onnxruntime dependency. Runs the op subset the exporters
emit plus the common elementwise and matmul ops; the port's copy of the JAX
package's runner.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from heybuddy_tpu_torch.export.onnx_proto import OnnxModel, parse_model

__all__ = ["run_model", "OnnxRunner"]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class OnnxRunner:
    """Evaluate a parsed ONNX graph with numpy."""

    def __init__(self, model: OnnxModel) -> None:
        self.model = model
        self.graph = model.graph
        self.initializers = {t.name: t.array for t in self.graph.initializers}

    @classmethod
    def from_file(cls, path: str) -> "OnnxRunner":
        return cls(parse_model(path))

    def __call__(self, **inputs: np.ndarray) -> Dict[str, np.ndarray]:
        values: Dict[str, np.ndarray] = dict(self.initializers)
        for info in self.graph.inputs:
            if info.name not in inputs:
                raise KeyError(f"Missing graph input {info.name}")
            values[info.name] = np.asarray(inputs[info.name])

        for node in self.graph.nodes:
            args = [values[name] for name in node.inputs if name]
            values[node.outputs[0]] = self._execute(node, args)

        return {info.name: values[info.name] for info in self.graph.outputs}

    def run(self, inputs: Dict[str, np.ndarray]) -> List[np.ndarray]:
        out = self(**inputs)
        return [out[info.name] for info in self.graph.outputs]

    @staticmethod
    def _execute(node: Any, args: List[np.ndarray]) -> np.ndarray:
        op = node.op_type
        if op == "MatMul":
            return args[0] @ args[1]
        if op == "Gemm":
            alpha = node.attr("alpha", 1.0)
            beta = node.attr("beta", 1.0)
            a = args[0].T if node.attr("transA", 0) else args[0]
            b = args[1].T if node.attr("transB", 0) else args[1]
            out = alpha * (a @ b)
            if len(args) > 2:
                out = out + beta * args[2]
            return out
        if op == "Add":
            return args[0] + args[1]
        if op == "Sub":
            return args[0] - args[1]
        if op == "Mul":
            return args[0] * args[1]
        if op == "Div":
            return args[0] / args[1]
        if op == "Sqrt":
            return np.sqrt(args[0])
        if op == "Sigmoid":
            return _sigmoid(args[0])
        if op == "Relu":
            return np.maximum(args[0], 0)
        if op == "Tanh":
            return np.tanh(args[0])
        if op == "Flatten":
            axis = node.attr("axis", 1)
            shape = args[0].shape
            lead = int(np.prod(shape[:axis])) if axis > 0 else 1
            return args[0].reshape(lead, -1)
        if op == "Reshape":
            # ONNX semantics: 0 copies the input dim, -1 infers.
            shape = [
                args[0].shape[i] if int(s) == 0 else int(s)
                for i, s in enumerate(args[1])
            ]
            return args[0].reshape(shape)
        if op == "ReduceMean":
            axes = node.attr("axes")
            if axes is None and len(args) > 1:
                axes = [int(a) for a in args[1]]
            keepdims = bool(node.attr("keepdims", 1))
            return np.mean(args[0], axis=tuple(int(a) for a in axes), keepdims=keepdims)
        if op == "Gather":
            axis = node.attr("axis", 0)
            return np.take(args[0], args[1].astype(np.int64), axis=axis)
        if op == "Transpose":
            perm = node.attr("perm")
            return np.transpose(args[0], perm)
        if op == "Softmax":
            axis = node.attr("axis", -1)
            x = args[0] - args[0].max(axis=axis, keepdims=True)
            e = np.exp(x)
            return e / e.sum(axis=axis, keepdims=True)
        if op == "ReduceMax":
            axes = node.attr("axes")
            if axes is None and len(args) > 1:
                axes = [int(a) for a in args[1]]
            keepdims = bool(node.attr("keepdims", 1))
            return np.max(args[0], axis=tuple(int(a) for a in axes), keepdims=keepdims)
        if op == "Identity":
            return args[0]
        if op == "Concat":
            axis = node.attr("axis", 0)
            return np.concatenate(args, axis=axis)
        if op == "Log":
            return np.log(args[0])
        if op == "Exp":
            return np.exp(args[0])
        if op == "Erf":
            from scipy.special import erf

            return erf(args[0]).astype(args[0].dtype)
        if op == "Pow":
            return np.power(args[0], args[1])
        if op == "Slice":
            starts = args[1].astype(np.int64)
            ends = args[2].astype(np.int64)
            axes = args[3].astype(np.int64) if len(args) > 3 else np.arange(len(starts))
            slices = [slice(None)] * args[0].ndim
            for s, e, a in zip(starts, ends, axes):
                slices[int(a)] = slice(int(s), int(e))
            return args[0][tuple(slices)]
        raise NotImplementedError(f"ONNX op not supported by numpy runner: {op}")


def run_model(path: str, **inputs: np.ndarray) -> Dict[str, np.ndarray]:
    return OnnxRunner.from_file(path)(**inputs)
