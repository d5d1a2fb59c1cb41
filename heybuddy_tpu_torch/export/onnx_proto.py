"""
Minimal self-contained ONNX protobuf reader/writer (numpy only).

The browser runtime loads the wake-word head as an ``.onnx`` file with input
"input" float[1,16,96] and output "output" float[1,1]. This module implements
the protobuf *wire format* directly for the subset of ONNX needed to write and
read such graphs, with no ``onnx``/``onnxruntime`` dependency. It is the
port's copy of the JAX package's codec and writes the same bytes for the same
graph.

Wire format: each field is ``(field_number << 3 | wire_type)`` varint-prefixed;
wire type 0 = varint, 2 = length-delimited, 5 = 32-bit. Message field numbers
follow onnx.proto3 (ModelProto, GraphProto, NodeProto, TensorProto,
ValueInfoProto, AttributeProto, OperatorSetIdProto).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple, Union

import numpy as np

__all__ = [
    "OnnxTensor",
    "OnnxAttribute",
    "OnnxNode",
    "OnnxValueInfo",
    "OnnxGraph",
    "OnnxModel",
    "serialize_model",
    "parse_model",
]

# onnx TensorProto.DataType
FLOAT = 1
UINT8 = 2
INT8 = 3
INT16 = 5
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

_DTYPE_BY_DATA_TYPE = {
    FLOAT: np.dtype(np.float32),
    UINT8: np.dtype(np.uint8),
    INT8: np.dtype(np.int8),
    INT16: np.dtype(np.int16),
    INT32: np.dtype(np.int32),
    INT64: np.dtype(np.int64),
    BOOL: np.dtype(np.bool_),
    FLOAT16: np.dtype(np.float16),
    DOUBLE: np.dtype(np.float64),
}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_GRAPH = 5
ATTR_FLOATS = 6
ATTR_INTS = 7


# --------------------------------------------------------------- wire encoding


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def _field_varint(field_number: int, value: int) -> bytes:
    return _tag(field_number, 0) + _varint(value)


def _field_bytes(field_number: int, data: bytes) -> bytes:
    return _tag(field_number, 2) + _varint(len(data)) + data


def _field_string(field_number: int, text: str) -> bytes:
    return _field_bytes(field_number, text.encode("utf-8"))


# --------------------------------------------------------------- wire decoding


def _to_signed64(value: int) -> int:
    """proto int64 varints are two's complement; map >=2^63 back to negative."""
    return value - (1 << 64) if value >= (1 << 63) else value


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _iter_fields(data: bytes):
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field_number, wire_type = tag >> 3, tag & 7
        if wire_type == 0:
            value, pos = _read_varint(data, pos)
        elif wire_type == 2:
            length, pos = _read_varint(data, pos)
            value = data[pos : pos + length]
            pos += length
        elif wire_type == 5:
            value = data[pos : pos + 4]
            pos += 4
        elif wire_type == 1:
            value = data[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"Unsupported wire type {wire_type}")
        yield field_number, wire_type, value


# ------------------------------------------------------------------- datatypes


@dataclass
class OnnxTensor:
    name: str
    array: np.ndarray

    def encode(self) -> bytes:
        arr = self.array
        for dt, dtype in _DTYPE_BY_DATA_TYPE.items():
            if arr.dtype == dtype:
                data_type = dt
                break
        else:
            raise TypeError(f"Unsupported tensor dtype {arr.dtype}")
        out = b""
        for dim in arr.shape:
            out += _field_varint(1, dim)
        out += _field_varint(2, data_type)
        out += _field_string(8, self.name)
        out += _field_bytes(9, arr.tobytes())  # raw_data
        return out

    @classmethod
    def decode(cls, data: bytes) -> "OnnxTensor":
        dims: List[int] = []
        data_type = FLOAT
        name = ""
        raw = b""
        float_data: List[float] = []
        int_data: List[int] = []
        double_data: List[float] = []
        for num, wt, value in _iter_fields(data):
            if num == 1:
                dims.append(value)
            elif num == 2:
                data_type = value
            elif num == 8:
                name = value.decode("utf-8")
            elif num == 9:
                raw = value
            elif num == 4 and wt == 2:  # packed float_data
                float_data.extend(struct.unpack(f"<{len(value) // 4}f", value))
            elif num == 4 and wt == 5:  # unpacked float_data
                float_data.append(struct.unpack("<f", value)[0])
            elif num == 7 and wt == 2:  # packed int64_data (also holds int32/bool)
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int_data.append(_to_signed64(v))
            elif num == 7 and wt == 0:
                int_data.append(_to_signed64(value))
            elif num == 5 and wt == 2:  # packed int32_data
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    int_data.append(_to_signed64(v))
            elif num == 5 and wt == 0:
                int_data.append(_to_signed64(value))
            elif num == 10 and wt == 2:  # packed double_data
                double_data.extend(struct.unpack(f"<{len(value) // 8}d", value))
        dtype = _DTYPE_BY_DATA_TYPE.get(data_type, np.dtype(np.float32))
        if raw:
            arr = np.frombuffer(raw, dtype=dtype)
        elif float_data:
            arr = np.asarray(float_data, dtype=np.float32)
        elif double_data:
            arr = np.asarray(double_data, dtype=np.float64)
        elif int_data:
            # int32/bool/int64 all arrive via varint fields; cast to target
            arr = np.asarray(int_data, dtype=np.int64).astype(dtype)
        else:
            arr = np.zeros(0, dtype=dtype)
        # Empty dims on a 1-element tensor means a scalar in ONNX.
        return cls(name, arr.reshape(dims) if dims or arr.size == 1 else arr)


@dataclass
class OnnxAttribute:
    name: str
    value: Any
    attr_type: int

    def encode(self) -> bytes:
        out = _field_string(1, self.name)
        if self.attr_type == ATTR_FLOAT:
            out += _tag(2, 5) + struct.pack("<f", float(self.value))
        elif self.attr_type == ATTR_INT:
            out += _field_varint(3, int(self.value))
        elif self.attr_type == ATTR_STRING:
            out += _field_bytes(4, self.value.encode("utf-8"))
        elif self.attr_type == ATTR_TENSOR:
            out += _field_bytes(5, self.value.encode())
        elif self.attr_type == ATTR_GRAPH:
            out += _field_bytes(6, self.value.encode())
        elif self.attr_type == ATTR_INTS:
            for v in self.value:
                out += _field_varint(8, int(v))
        elif self.attr_type == ATTR_FLOATS:
            for v in self.value:
                out += _tag(7, 5) + struct.pack("<f", float(v))
        else:
            raise ValueError(f"Unsupported attribute type {self.attr_type}")
        out += _field_varint(20, self.attr_type)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "OnnxAttribute":
        name = ""
        attr_type = 0
        f_val: Optional[float] = None
        i_val: Optional[int] = None
        s_val: Optional[str] = None
        t_val: Optional[OnnxTensor] = None
        g_val: Optional["OnnxGraph"] = None
        ints: List[int] = []
        floats: List[float] = []
        for num, wt, value in _iter_fields(data):
            if num == 1:
                name = value.decode("utf-8")
            elif num == 2:
                f_val = struct.unpack("<f", value)[0]
            elif num == 3:
                i_val = _to_signed64(value)
            elif num == 4:
                s_val = value.decode("utf-8")
            elif num == 5:
                t_val = OnnxTensor.decode(value)
            elif num == 6:
                g_val = OnnxGraph.decode(value)
            elif num == 8:
                if wt == 0:
                    ints.append(_to_signed64(value))
                else:
                    pos = 0
                    while pos < len(value):
                        v, pos = _read_varint(value, pos)
                        ints.append(_to_signed64(v))
            elif num == 7 and wt == 5:
                floats.append(struct.unpack("<f", value)[0])
            elif num == 20:
                attr_type = value
        if attr_type == ATTR_FLOAT:
            return cls(name, f_val, attr_type)
        if attr_type == ATTR_INT:
            return cls(name, i_val, attr_type)
        if attr_type == ATTR_STRING:
            return cls(name, s_val, attr_type)
        if attr_type == ATTR_TENSOR:
            return cls(name, t_val, attr_type)
        if attr_type == ATTR_GRAPH:
            return cls(name, g_val, attr_type)
        if attr_type == ATTR_INTS:
            return cls(name, ints, attr_type)
        if attr_type == ATTR_FLOATS:
            return cls(name, floats, attr_type)
        # untyped attributes: best effort
        return cls(name, i_val if i_val is not None else f_val, attr_type)


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attributes: List[OnnxAttribute] = field(default_factory=list)

    def encode(self) -> bytes:
        out = b""
        for inp in self.inputs:
            out += _field_string(1, inp)
        for outp in self.outputs:
            out += _field_string(2, outp)
        if self.name:
            out += _field_string(3, self.name)
        out += _field_string(4, self.op_type)
        for attr in self.attributes:
            out += _field_bytes(5, attr.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "OnnxNode":
        node = cls("", [], [])
        for num, _wt, value in _iter_fields(data):
            if num == 1:
                node.inputs.append(value.decode("utf-8"))
            elif num == 2:
                node.outputs.append(value.decode("utf-8"))
            elif num == 3:
                node.name = value.decode("utf-8")
            elif num == 4:
                node.op_type = value.decode("utf-8")
            elif num == 5:
                node.attributes.append(OnnxAttribute.decode(value))
        return node

    def attr(self, name: str, default: Any = None) -> Any:
        for attribute in self.attributes:
            if attribute.name == name:
                return attribute.value
        return default


@dataclass
class OnnxValueInfo:
    name: str
    shape: Tuple[Union[int, str], ...]
    elem_type: int = FLOAT

    def encode(self) -> bytes:
        shape_proto = b""
        for dim in self.shape:
            if isinstance(dim, str):
                dim_proto = _field_string(2, dim)
            else:
                dim_proto = _field_varint(1, dim)
            shape_proto += _field_bytes(1, dim_proto)
        tensor_type = _field_varint(1, self.elem_type) + _field_bytes(2, shape_proto)
        type_proto = _field_bytes(1, tensor_type)
        return _field_string(1, self.name) + _field_bytes(2, type_proto)

    @classmethod
    def decode(cls, data: bytes) -> "OnnxValueInfo":
        name = ""
        shape: List[Union[int, str]] = []
        elem_type = FLOAT
        for num, _wt, value in _iter_fields(data):
            if num == 1:
                name = value.decode("utf-8")
            elif num == 2:
                for tnum, _twt, tvalue in _iter_fields(value):
                    if tnum == 1:  # tensor_type
                        for fnum, _fwt, fvalue in _iter_fields(tvalue):
                            if fnum == 1:
                                elem_type = fvalue
                            elif fnum == 2:  # shape
                                for snum, _swt, svalue in _iter_fields(fvalue):
                                    if snum == 1:  # dim
                                        dim: Union[int, str] = 0
                                        for dnum, _dwt, dvalue in _iter_fields(svalue):
                                            if dnum == 1:
                                                dim = dvalue
                                            elif dnum == 2:
                                                dim = dvalue.decode("utf-8")
                                        shape.append(dim)
        return cls(name, tuple(shape), elem_type)


@dataclass
class OnnxGraph:
    name: str
    nodes: List[OnnxNode]
    initializers: List[OnnxTensor]
    inputs: List[OnnxValueInfo]
    outputs: List[OnnxValueInfo]

    def encode(self) -> bytes:
        out = b""
        for node in self.nodes:
            out += _field_bytes(1, node.encode())
        out += _field_string(2, self.name)
        for init in self.initializers:
            out += _field_bytes(5, init.encode())
        for inp in self.inputs:
            out += _field_bytes(11, inp.encode())
        for outp in self.outputs:
            out += _field_bytes(12, outp.encode())
        return out

    @classmethod
    def decode(cls, data: bytes) -> "OnnxGraph":
        graph = cls("", [], [], [], [])
        for num, _wt, value in _iter_fields(data):
            if num == 1:
                graph.nodes.append(OnnxNode.decode(value))
            elif num == 2:
                graph.name = value.decode("utf-8")
            elif num == 5:
                graph.initializers.append(OnnxTensor.decode(value))
            elif num == 11:
                graph.inputs.append(OnnxValueInfo.decode(value))
            elif num == 12:
                graph.outputs.append(OnnxValueInfo.decode(value))
        return graph


@dataclass
class OnnxModel:
    graph: OnnxGraph
    opset_version: int = 19
    ir_version: int = 9
    producer_name: str = "heybuddy-tpu"

    def encode(self) -> bytes:
        opset = _field_string(1, "") + _field_varint(2, self.opset_version)
        out = _field_varint(1, self.ir_version)
        out += _field_string(2, self.producer_name)
        out += _field_bytes(7, self.graph.encode())
        out += _field_bytes(8, opset)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "OnnxModel":
        model = cls(OnnxGraph("", [], [], [], []))
        for num, _wt, value in _iter_fields(data):
            if num == 1:
                model.ir_version = value
            elif num == 2:
                model.producer_name = value.decode("utf-8")
            elif num == 7:
                model.graph = OnnxGraph.decode(value)
            elif num == 8:
                for onum, _owt, ovalue in _iter_fields(value):
                    if onum == 2:
                        model.opset_version = ovalue
        return model


def serialize_model(model: OnnxModel, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.encode())


def parse_model(path: str) -> OnnxModel:
    with open(path, "rb") as f:
        return OnnxModel.decode(f.read())
