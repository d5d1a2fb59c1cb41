"""
ONNX graph -> PyTorch function, the port's counterpart of the JAX package's
``export/onnx_to_jax.py``.

It imports the frozen models that ship as ``.onnx`` files: the speech
embedding (``browser/models/speech-embedding.onnx``), the mel spectrogram
(``browser/models/mel-spectrogram.onnx``) and the Silero VAD. The file is
parsed by the port's own protobuf codec (``onnx_proto.py``) and the node list
is interpreted with tensor ops on ``device``; no ``onnx`` or ``onnxruntime``
package is involved.

* Float initializers are the weights: a dict of tensors on the device
  (``.params``), passed as the first argument so that a caller may swap them.
  Integer and bool initializers are shape and index helpers and stay numpy.
* Values that carry shapes (``Shape``, ``Reshape`` targets, axes, pads,
  ``Range``, ``ConstantOfShape``, static arithmetic over them) are numpy
  arrays, folded on the host whenever every input is numpy. A shape never
  becomes a device tensor, so no op waits for the card to learn one.
* ``If`` needs a condition known on the host (the Silero sample-rate
  branch, with ``sr`` passed as a numpy integer); a device condition raises.
* A numpy value that meets a tensor becomes a tensor on the tensor's
  device; float64 becomes float32, as the JAX package (64-bit off) does.

The op coverage is the JAX converter's: the elementwise, shape, reduction,
convolution, pooling, normalisation and ``LSTM`` families. ``ConvTranspose``
and ``GRU`` raise ``NotImplementedError``, as they do there; so does any
other op, naming it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from heybuddy_tpu_torch.device import DeviceLike, resolve_device
from heybuddy_tpu_torch.export.onnx_proto import OnnxGraph, OnnxModel, parse_model

__all__ = ["OnnxTorchFunction"]

Value = Any  # np.ndarray | np.generic | torch.Tensor

_CAST_DTYPES = {
    1: (np.float32, torch.float32),
    2: (np.uint8, torch.uint8),
    3: (np.int8, torch.int8),
    5: (np.int16, torch.int16),
    6: (np.int32, torch.int32),
    7: (np.int64, torch.int64),
    9: (np.bool_, torch.bool),
    10: (np.float16, torch.float16),
    11: (np.float64, torch.float64),
}


def _is_static(*values: Any) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float, bool)) for v in values)


def _as_int_list(value: Any) -> List[int]:
    return [int(v) for v in np.asarray(value).reshape(-1)]


def _shape(value: Value) -> Tuple[int, ...]:
    return tuple(value.shape) if isinstance(value, torch.Tensor) else np.shape(value)


def _tensor(value: Value, device: torch.device) -> torch.Tensor:
    """A value as a tensor on ``device``; numpy float64 as float32 (JAX's 64-bit-off rule)."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _pads_last_first(pairs: Sequence[Tuple[int, int]]) -> List[int]:
    """[(begin, end) per dim, first dim first] -> F.pad's flat list, last dim first."""
    out: List[int] = []
    for begin, end in reversed(list(pairs)):
        out += [int(begin), int(end)]
    return out


class OnnxTorchFunction:
    """
    A parsed ONNX graph as ``fn(params, *inputs)`` on ``device``.

    ``params`` is the dict of float initializers (``.params`` holds them on
    the device); inputs follow ``.input_names``, as tensors or, for values the
    graph needs on the host (a sample rate), numpy. Returns the outputs in
    ``.output_names`` order, or the one output.
    """

    def __init__(self, model: Union[OnnxModel, OnnxGraph], device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.graph = model.graph if isinstance(model, OnnxModel) else model
        self.params: Dict[str, torch.Tensor] = {}
        self.constants: Dict[str, np.ndarray] = {}
        for t in self.graph.initializers:
            arr = np.asarray(t.array)
            if arr.dtype.kind in "iub":
                self.constants[t.name] = arr
            else:
                self.params[t.name] = _tensor(arr, self.device)
        self.input_names: List[str] = [
            i.name for i in self.graph.inputs if i.name not in self.params and i.name not in self.constants
        ]
        self.output_names: List[str] = [o.name for o in self.graph.outputs]

    @classmethod
    def from_file(cls, path: str, device: DeviceLike = "cuda") -> "OnnxTorchFunction":
        return cls(parse_model(path), device)

    # ------------------------------------------------------------- execution

    def __call__(self, params: Dict[str, torch.Tensor], *inputs: Value) -> Any:
        if len(inputs) != len(self.input_names):
            raise ValueError(f"Expected {len(self.input_names)} inputs {self.input_names}, got {len(inputs)}")
        values: Dict[str, Value] = dict(self.constants)
        values.update(params)
        values.update(zip(self.input_names, inputs))
        self._run_graph(self.graph, values)
        outs = [values[name] for name in self.output_names]
        return outs[0] if len(outs) == 1 else outs

    def _run_graph(self, graph: OnnxGraph, values: Dict[str, Value]) -> None:
        for node in graph.nodes:
            args = [values[name] if name else None for name in node.inputs]
            results = self._execute(node, args, values)
            if not isinstance(results, (tuple, list)):
                results = (results,)
            for out_name, result in zip(node.outputs, results):
                if out_name:
                    values[out_name] = result

    def _t(self, value: Value) -> torch.Tensor:
        return _tensor(value, self.device)

    # ------------------------------------------------------------------- ops

    def _execute(self, node: Any, args: List[Value], values: Dict[str, Value]) -> Any:
        op = node.op_type
        t = self._t

        # ---- constants and shape machinery, kept on the host ----
        if op == "Constant":
            tensor = node.attr("value")
            if tensor is None:
                for alt in ("value_float", "value_int"):
                    v = node.attr(alt)
                    if v is not None:
                        return np.asarray(v)
                raise NotImplementedError("Constant without value tensor")
            return np.asarray(tensor.array)
        if op == "Shape":
            shape = np.asarray(_shape(args[0]), dtype=np.int64)
            start = node.attr("start", 0)
            end = node.attr("end")
            return shape[start: None if end is None else end]
        if op == "ConstantOfShape":
            tensor = node.attr("value")
            fill = np.asarray(tensor.array).reshape(-1)[0] if tensor is not None else np.float32(0)
            return np.full(_as_int_list(args[0]), fill)
        if op == "Range":
            if not _is_static(*args):
                raise NotImplementedError("Range with device start/limit/delta (shape must be static)")
            return np.arange(np.asarray(args[0]).item(), np.asarray(args[1]).item(), np.asarray(args[2]).item())
        if op == "Cast":
            np_dtype, torch_dtype = _CAST_DTYPES[int(node.attr("to", 1))]
            if _is_static(args[0]):
                return np.asarray(args[0]).astype(np_dtype)
            return args[0].to(torch_dtype)
        if op == "If":
            cond = args[0]
            if not _is_static(cond):
                raise NotImplementedError(
                    "If with a device condition; pass the deciding input (e.g. sample rate) as a numpy "
                    "value so that the branch folds on the host"
                )
            taken = bool(np.asarray(cond).reshape(-1)[0])
            branch = node.attr("then_branch") if taken else node.attr("else_branch")
            sub_values = dict(values)  # ONNX subgraphs see the outer scope
            for init in branch.initializers:
                sub_values[init.name] = np.asarray(init.array)
            self._run_graph(branch, sub_values)
            return tuple(sub_values[o.name] for o in branch.outputs)

        present = [a for a in args if a is not None]
        if op in _STATIC_SAFE_OPS and _is_static(*present):
            return _STATIC_SAFE_OPS[op](node, [np.asarray(a) if a is not None else None for a in args])

        # ---- elementwise ----
        if op in _BINARY:
            return _BINARY[op](t(args[0]), t(args[1]))
        if op == "Div":
            a, b = t(args[0]), t(args[1])
            if not a.is_floating_point():  # ONNX integer Div truncates toward zero
                return torch.div(a, b, rounding_mode="trunc")
            return a / b
        if op in _UNARY:
            return _UNARY[op](t(args[0]))
        if op in ("Min", "Max"):
            fn = torch.minimum if op == "Min" else torch.maximum
            out = t(args[0])
            for a in args[1:]:
                out = fn(out, t(a))
            return out
        if op == "Clip":
            lo, hi = node.attr("min"), node.attr("max")
            if lo is None and len(args) > 1 and args[1] is not None:
                lo = args[1]
            if hi is None and len(args) > 2 and args[2] is not None:
                hi = args[2]
            x = t(args[0])
            lo = t(lo).to(x.dtype) if lo is not None and not isinstance(lo, float) else lo
            hi = t(hi).to(x.dtype) if hi is not None and not isinstance(hi, float) else hi
            return torch.clamp(x, lo, hi)
        if op == "LeakyRelu":
            return F.leaky_relu(t(args[0]), node.attr("alpha", 0.01))
        if op == "Elu":
            return F.elu(t(args[0]), node.attr("alpha", 1.0))
        if op == "HardSigmoid":
            return torch.clamp(node.attr("alpha", 0.2) * t(args[0]) + node.attr("beta", 0.5), 0.0, 1.0)
        if op == "PRelu":
            x = t(args[0])
            return torch.where(x > 0, x, x * t(args[1]))
        if op == "Softmax":
            return torch.softmax(t(args[0]), dim=node.attr("axis", -1))
        if op == "LogSoftmax":
            return torch.log_softmax(t(args[0]), dim=node.attr("axis", -1))
        if op == "Where":
            return torch.where(t(args[0]).bool(), t(args[1]), t(args[2]))
        if op in _COMPARE:
            return _COMPARE[op](t(args[0]), t(args[1]))

        # ---- linear algebra ----
        if op == "MatMul":
            return torch.matmul(t(args[0]), t(args[1]))
        if op == "Gemm":
            a = t(args[0]).T if node.attr("transA", 0) else t(args[0])
            b = t(args[1]).T if node.attr("transB", 0) else t(args[1])
            out = node.attr("alpha", 1.0) * (a @ b)
            if len(args) > 2 and args[2] is not None:
                out = out + node.attr("beta", 1.0) * t(args[2])
            return out

        # ---- shape manipulation ----
        if op == "Reshape":
            if not _is_static(args[1]):
                raise NotImplementedError("Reshape with a device target shape")
            in_shape = _shape(args[0])
            shape = [
                int(in_shape[i]) if int(s) == 0 and node.attr("allowzero", 0) == 0 else int(s)
                for i, s in enumerate(_as_int_list(args[1]))
            ]
            return t(args[0]).reshape(shape)
        if op == "Flatten":
            axis = int(node.attr("axis", 1))
            shape = _shape(args[0])
            if axis < 0:
                axis += len(shape)
            lead = int(np.prod(shape[:axis])) if axis > 0 else 1
            return t(args[0]).reshape(lead, -1)
        if op == "Transpose":
            x = t(args[0])
            perm = node.attr("perm")
            return x.permute(*(perm if perm is not None else reversed(range(x.ndim))))
        if op == "Squeeze":
            axes = node.attr("axes")
            if axes is None and len(args) > 1 and args[1] is not None:
                axes = _as_int_list(args[1])
            x = t(args[0])
            if axes is None:
                return x.squeeze()
            return x.squeeze(tuple(int(a) for a in axes))
        if op == "Unsqueeze":
            axes = node.attr("axes")
            if axes is None:
                axes = _as_int_list(args[1])
            out = t(args[0])
            out_rank = out.ndim + len(list(axes))  # negative axes count from the output's rank
            for a in sorted(int(x) % out_rank for x in axes):
                out = out.unsqueeze(a)
            return out
        if op == "Concat":
            return torch.cat([t(a) for a in present], dim=node.attr("axis", 0))
        if op == "Split":
            axis = node.attr("axis", 0)
            splits = node.attr("split")
            if splits is None and len(args) > 1 and args[1] is not None:
                splits = _as_int_list(args[1])
            dim = _shape(args[0])[axis]
            if splits is None:
                n_out = max(len(node.outputs), node.attr("num_outputs", len(node.outputs)) or 1)
                size = -(-dim // n_out)
                splits = [size] * (n_out - 1) + [dim - size * (n_out - 1)]
            return tuple(torch.split(t(args[0]), [int(s) for s in splits], dim=axis))
        if op == "Slice":
            starts, ends, axes, steps = _slice_spec(node, args)
            return _slice_tensor(t(args[0]), starts, ends, axes, steps)
        if op == "Gather":
            return _take(t(args[0]), args[1], node.attr("axis", 0), self.device)
        if op == "GatherElements":
            x = t(args[0])
            axis = node.attr("axis", 0)
            idx = t(np.asarray(args[1]).astype(np.int64) if _is_static(args[1]) else args[1]).long()
            idx = torch.where(idx < 0, idx + x.shape[axis], idx)
            return torch.gather(x, axis, idx)
        if op == "Expand":
            target = _as_int_list(args[1])
            shape = list(_shape(args[0]))
            rank = max(len(target), len(shape))
            shape = [1] * (rank - len(shape)) + shape
            target = [1] * (rank - len(target)) + target
            out_shape = [max(s, d) for s, d in zip(shape, target)]
            return t(args[0]).reshape(shape).expand(out_shape)
        if op == "Tile":
            return torch.tile(t(args[0]), tuple(_as_int_list(args[1])))
        if op == "Pad":
            return self._pad(node, args)

        # ---- reductions ----
        if op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin", "ReduceProd"):
            return self._reduce(node, op, args)
        if op == "ArgMax":
            axis = node.attr("axis", 0)
            return torch.argmax(t(args[0]), dim=axis, keepdim=bool(node.attr("keepdims", 1)))

        # ---- convolution / pooling / normalisation ----
        if op == "Conv":
            return self._conv(node, args)
        if op == "ConvTranspose":
            raise NotImplementedError("ConvTranspose not needed by the frozen models")
        if op in ("MaxPool", "AveragePool"):
            return self._pool(node, t(args[0]), op)
        if op in ("GlobalAveragePool", "GlobalMaxPool"):
            x = t(args[0])
            spatial = tuple(range(2, x.ndim))
            return x.mean(dim=spatial, keepdim=True) if op == "GlobalAveragePool" else x.amax(spatial, True)
        if op == "BatchNormalization":
            x, scale, bias, mean, var = (t(a) for a in args[:5])
            eps = node.attr("epsilon", 1e-5)
            shape = [1, -1] + [1] * (x.ndim - 2)
            inv = 1.0 / torch.sqrt(var + eps)
            return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + bias.reshape(shape)
        if op == "InstanceNormalization":
            x, scale, bias = (t(a) for a in args[:3])
            eps = node.attr("epsilon", 1e-5)
            spatial = tuple(range(2, x.ndim))
            mean = x.mean(dim=spatial, keepdim=True)
            var = x.var(dim=spatial, keepdim=True, unbiased=False)
            shape = [1, -1] + [1] * (x.ndim - 2)
            return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)
        if op == "LayerNormalization":
            x, scale = t(args[0]), t(args[1])
            bias = t(args[2]) if len(args) > 2 and args[2] is not None else None
            axis = node.attr("axis", -1)
            eps = node.attr("epsilon", 1e-5)
            axes = tuple(range(axis % x.ndim, x.ndim))
            mean = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
            out = (x - mean) / torch.sqrt(var + eps) * scale
            return out + bias if bias is not None else out

        # ---- recurrent ----
        if op == "LSTM":
            return self._lstm(node, args)
        if op == "GRU":
            raise NotImplementedError("GRU not needed by the frozen models")

        if op in ("Identity", "Dropout"):
            return args[0]

        raise NotImplementedError(f"ONNX op not supported by the torch converter: {op}")

    # ------------------------------------------------------- pads, reductions

    def _pad(self, node: Any, args: List[Value]) -> torch.Tensor:
        mode = node.attr("mode", "constant")
        if isinstance(mode, bytes):
            mode = mode.decode()
        pads = node.attr("pads")
        if pads is None:
            if not _is_static(args[1]):
                raise NotImplementedError("Pad with device pads")
            pads = _as_int_list(args[1])
        x = self._t(args[0])
        rank = x.ndim
        flat = _pads_last_first([(int(pads[i]), int(pads[i + rank])) for i in range(rank)])
        if mode == "constant":
            cval = 0.0
            if len(args) > 2 and args[2] is not None:
                cval = float(np.asarray(args[2]).reshape(-1)[0]) if _is_static(args[2]) else float(args[2])
            return F.pad(x, flat, mode="constant", value=cval)
        return F.pad(x, flat, mode={"reflect": "reflect", "edge": "replicate"}[mode])

    def _reduce(self, node: Any, op: str, args: List[Value]) -> torch.Tensor:
        axes = node.attr("axes")
        if axes is None and len(args) > 1 and args[1] is not None:
            axes = _as_int_list(args[1])
        x = self._t(args[0])
        if axes is not None and len(list(axes)) == 0:
            # explicit empty axes reduce every dim unless the graph asks for a no-op
            if node.attr("noop_with_empty_axes", 0):
                return x
            axes = None
        keep = bool(node.attr("keepdims", 1))
        dims = tuple(int(a) % max(x.ndim, 1) for a in axes) if axes is not None else tuple(range(x.ndim))
        if op == "ReduceProd":
            out = x
            for d in sorted(dims, reverse=True):
                out = torch.prod(out, dim=d, keepdim=keep)
            return out
        fn = {"ReduceMean": torch.mean, "ReduceSum": torch.sum, "ReduceMax": torch.amax,
              "ReduceMin": torch.amin}[op]
        return fn(x, dim=dims, keepdim=keep)

    # --------------------------------------------------------------- conv ops

    @staticmethod
    def _conv_padding(
        node: Any, x_spatial: Sequence[int], k_spatial: Sequence[int],
        strides: Sequence[int], dilations: Sequence[int],
    ) -> List[Tuple[int, int]]:
        auto_pad = node.attr("auto_pad", "NOTSET")
        if isinstance(auto_pad, bytes):
            auto_pad = auto_pad.decode()
        n = len(k_spatial)
        if auto_pad in ("NOTSET", "", None):
            pads = node.attr("pads", [0] * (2 * n))
            return [(int(pads[i]), int(pads[i + n])) for i in range(n)]
        if auto_pad == "VALID":
            return [(0, 0)] * n
        out = []  # SAME_UPPER / SAME_LOWER
        for size, k, s, d in zip(x_spatial, k_spatial, strides, dilations):
            eff_k = (k - 1) * d + 1
            out_size = -(-size // s)
            total = max(0, (out_size - 1) * s + eff_k - size)
            if auto_pad == "SAME_UPPER":
                out.append((total // 2, total - total // 2))
            else:
                out.append((total - total // 2, total // 2))
        return out

    def _conv(self, node: Any, args: List[Value]) -> torch.Tensor:
        x, w = self._t(args[0]), self._t(args[1])
        b = self._t(args[2]) if len(args) > 2 and args[2] is not None else None
        n_spatial = w.ndim - 2
        if n_spatial not in (1, 2, 3):
            raise NotImplementedError(f"{n_spatial}-D convolution")
        strides = [int(s) for s in node.attr("strides", [1] * n_spatial)]
        dilations = [int(d) for d in node.attr("dilations", [1] * n_spatial)]
        group = int(node.attr("group", 1))
        padding = self._conv_padding(node, x.shape[2:], w.shape[2:], strides, dilations)
        if all(lo == hi for lo, hi in padding):
            sym = [lo for lo, _ in padding]
        else:  # F.conv pads both sides alike: pad the uneven part first
            x = F.pad(x, _pads_last_first(padding))
            sym = [0] * n_spatial
        conv = (F.conv1d, F.conv2d, F.conv3d)[n_spatial - 1]
        return conv(x, w, b, stride=strides, padding=sym, dilation=dilations, groups=group)

    def _pool(self, node: Any, x: torch.Tensor, op: str) -> torch.Tensor:
        kernel = [int(k) for k in node.attr("kernel_shape")]
        n = len(kernel)
        strides = [int(s) for s in node.attr("strides", [1] * n)]
        dilations = [int(d) for d in node.attr("dilations", [1] * n)]
        if any(d != 1 for d in dilations):
            raise NotImplementedError("Pooling dilation")
        if node.attr("ceil_mode", 0):
            raise NotImplementedError("Pooling ceil_mode=1")
        flat = _pads_last_first(self._conv_padding(node, x.shape[2:], kernel, strides, dilations))
        if op == "MaxPool":
            padded = F.pad(x, flat, value=-float("inf"))
            return (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1](padded, kernel, strides)

        def window_sum(v: torch.Tensor) -> torch.Tensor:
            v = F.pad(v, flat)
            if n == 1:  # avg_pool1d has no divisor_override: sum as a 2-D pool
                return F.avg_pool2d(v[:, :, None], [1] + kernel, [1] + strides, divisor_override=1)[:, :, 0]
            return (F.avg_pool2d, F.avg_pool3d)[n - 2](v, kernel, strides, divisor_override=1)

        summed = window_sum(x)
        if node.attr("count_include_pad", 0):
            return summed / float(np.prod(kernel))
        return summed / window_sum(torch.ones_like(x))

    # --------------------------------------------------------------- LSTM

    def _lstm(self, node: Any, args: List[Value]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """
        ONNX LSTM (gate order i, o, f, c, where torch's ``nn.LSTM`` uses
        i, f, g, o), forward, reverse or bidirectional: (Y [seq, dirs, batch,
        hidden], Y_h, Y_c).
        """
        t = self._t
        x, w, r = t(args[0]), t(args[1]), t(args[2])
        n_dirs = w.shape[0]
        hidden = int(node.attr("hidden_size", r.shape[2]))
        batch = x.shape[1]
        b = t(args[3]) if len(args) > 3 and args[3] is not None else None
        zeros = torch.zeros((n_dirs, batch, hidden), dtype=torch.float32, device=x.device)
        h0 = t(args[5]) if len(args) > 5 and args[5] is not None else zeros
        c0 = t(args[6]) if len(args) > 6 and args[6] is not None else zeros
        if len(args) > 4 and args[4] is not None:
            raise NotImplementedError("LSTM sequence_lens input")
        if len(args) > 7 and args[7] is not None:
            raise NotImplementedError("LSTM peephole weights")
        direction = node.attr("direction", "forward")
        if isinstance(direction, bytes):
            direction = direction.decode()

        def run_direction(d: int, reverse: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
            wd, rd = w[d], r[d]  # [4H, input], [4H, H]
            bias = (b[d][: 4 * hidden] + b[d][4 * hidden:]) if b is not None else 0.0
            h, c = h0[d], c0[d]
            ys = []
            steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
            for step in steps:
                gates = x[step] @ wd.T + h @ rd.T + bias
                i, o, f, g = torch.split(gates, hidden, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                ys.append(h)
            if reverse:
                ys.reverse()
            return torch.stack(ys), h, c

        if direction in ("forward", "reverse"):
            ys, h_fin, c_fin = run_direction(0, direction == "reverse")
            return ys[:, None], h_fin[None], c_fin[None]
        ys_f, h_f, c_f = run_direction(0, False)
        ys_b, h_b, c_b = run_direction(1, True)
        return torch.stack([ys_f, ys_b], dim=1), torch.stack([h_f, h_b]), torch.stack([c_f, c_b])


_BINARY: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Pow": torch.pow,
}
_UNARY: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "Sqrt": torch.sqrt,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Exp": torch.exp,
    "Log": torch.log,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,
    "Relu": torch.relu,
    "Selu": F.selu,
    "Softplus": F.softplus,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Erf": torch.erf,
    "Not": torch.logical_not,
}
_COMPARE: Dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "Equal": torch.eq,
    "Greater": torch.gt,
    "GreaterOrEqual": torch.ge,
    "Less": torch.lt,
    "LessOrEqual": torch.le,
    "And": torch.logical_and,
    "Or": torch.logical_or,
}


def _take(x: torch.Tensor, idx: Value, axis: int, device: torch.device) -> torch.Tensor:
    """``jnp.take(x, idx, axis)``: negative indices count from the end."""
    axis = axis % x.ndim
    idx_t = _tensor(np.asarray(idx).astype(np.int64) if _is_static(idx) else idx, device).long()
    idx_t = torch.where(idx_t < 0, idx_t + x.shape[axis], idx_t)
    out = x.index_select(axis, idx_t.reshape(-1))
    return out.reshape(x.shape[:axis] + idx_t.shape + x.shape[axis + 1:])


def _slice_spec(node: Any, args: List[Value]) -> Tuple[List[int], List[int], List[int], List[int]]:
    if node.attr("starts") is not None:  # opset < 10: attributes
        starts = list(node.attr("starts"))
        ends = list(node.attr("ends"))
        return starts, ends, list(node.attr("axes", list(range(len(starts))))), [1] * len(starts)
    if not _is_static(*[a for a in args[1:] if a is not None]):
        raise NotImplementedError("Slice with device indices")
    starts = _as_int_list(args[1])
    ends = _as_int_list(args[2])
    axes = _as_int_list(args[3]) if len(args) > 3 and args[3] is not None else list(range(len(starts)))
    steps = _as_int_list(args[4]) if len(args) > 4 and args[4] is not None else [1] * len(starts)
    return starts, ends, axes, steps


def _clamp_int32(v: int) -> int:
    """The INT64_MAX sentinels exporters use for "to the end", clamped."""
    return max(min(v, np.iinfo(np.int32).max), np.iinfo(np.int32).min)


def _slice_tensor(
    x: torch.Tensor, starts: List[int], ends: List[int], axes: List[int], steps: List[int]
) -> torch.Tensor:
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % x.ndim
        sl = slice(_clamp_int32(s), _clamp_int32(e), st)
        if st > 0:
            x = x[(slice(None),) * a + (sl,)]
        else:  # torch slicing has no negative step: take numpy's indices
            idx = torch.as_tensor(np.arange(x.shape[a])[sl], dtype=torch.long, device=x.device)
            x = x.index_select(a, idx)
    return x


def _np_binop(fn: Callable[..., np.ndarray]) -> Callable[[Any, List[Optional[np.ndarray]]], np.ndarray]:
    return lambda node, args: fn(*[a for a in args if a is not None])


def _np_slice(node: Any, args: List[Optional[np.ndarray]]) -> np.ndarray:
    starts, ends, axes, steps = _slice_spec(node, args)
    slices: List[slice] = [slice(None)] * np.ndim(args[0])
    for s, e, a, st in zip(starts, ends, axes, steps):
        slices[int(a)] = slice(_clamp_int32(s), _clamp_int32(e), st)
    return np.asarray(args[0])[tuple(slices)]


# ops folded in numpy when every input is on the host, so that shape
# arithmetic stays concrete through Reshape / Slice / Pad targets
_STATIC_SAFE_OPS: Dict[str, Callable[[Any, List[Optional[np.ndarray]]], np.ndarray]] = {
    "Add": _np_binop(np.add),
    "Sub": _np_binop(np.subtract),
    "Mul": _np_binop(np.multiply),
    # ONNX integer Div truncates toward zero: Div(-7, 2) is -3
    "Div": _np_binop(
        lambda a, b: np.trunc(np.true_divide(a, b)).astype(a.dtype)
        if a.dtype.kind in "iu" and b.dtype.kind in "iu"
        else a / b
    ),
    "Concat": lambda node, args: np.concatenate([a for a in args if a is not None], axis=node.attr("axis", 0)),
    "Gather": lambda node, args: np.take(args[0], args[1].astype(np.int64), axis=node.attr("axis", 0)),
    "Squeeze": lambda node, args: np.squeeze(
        args[0],
        axis=tuple(
            int(a)
            for a in (
                node.attr("axes")
                if node.attr("axes") is not None
                else (args[1] if len(args) > 1 and args[1] is not None else [])
            )
        )
        or None,
    ),
    "Unsqueeze": lambda node, args: np.expand_dims(
        args[0], tuple(int(a) for a in (node.attr("axes") if node.attr("axes") is not None else args[1]))
    ),
    "Slice": _np_slice,
    # comparisons of host values stay on the host (the Silero sample-rate test feeds If)
    "Equal": _np_binop(np.equal),
    "Greater": _np_binop(np.greater),
    "GreaterOrEqual": _np_binop(np.greater_equal),
    "Less": _np_binop(np.less),
    "LessOrEqual": _np_binop(np.less_equal),
}
