"""Minimal protobuf wire-format codec for ONNX ModelProto (a copy of
flexflow_tpu/onnx_frontend/protowire.py, numpy only).

The importer works without the `onnx` package: ONNX's serialization is
plain protobuf, and the importer touches only a small, stable slice of
the schema (onnx/onnx.proto, field numbers fixed by the spec since IR v3):

  ModelProto.graph=7; GraphProto.node=1/.initializer=5/.input=11/
  .output=12; NodeProto.input=1/.output=2/.name=3/.op_type=4/
  .attribute=5; AttributeProto.name=1/f=2/i=3/s=4/t=5/floats=7/ints=8/
  strings=9/type=20; TensorProto.dims=1/data_type=2/float_data=4/
  int32_data=5/int64_data=7/name=8/raw_data=9/double_data=10;
  ValueInfoProto.name=1.

So this module decodes exactly that slice from raw wire bytes (varint /
64-bit / length-delimited / 32-bit records) into plain Python objects
with the same attribute surface the handlers use, plus a small encoder
(`encode_node`, `encode_model`) that writes such graphs.  When the
`onnx` package is installed the frontend prefers it for parsing.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# TensorProto.DataType (onnx.proto enum, spec-frozen)
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


# ---------------------------------------------------------------------------
# wire-level primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated protobuf: varint runs past end")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) records.  A record whose
    payload runs past the buffer raises ValueError instead of silently
    yielding a short slice (truncated/corrupt file)."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            v, i = buf[i:i + 8], i + 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wt == 5:  # 32-bit
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        if i > n:
            raise ValueError("truncated protobuf: record runs past end")
        yield field, wt, v


def _packed_varints(v: bytes) -> List[int]:
    out, i = [], 0
    while i < len(v):
        x, i = _read_varint(v, i)
        out.append(x)
    return out


def _signed(x: int) -> int:
    """Protobuf int64 varints are two's-complement."""
    return x - (1 << 64) if x >= (1 << 63) else x


# ---------------------------------------------------------------------------
# decoded objects (attribute surface mirrors the onnx package's)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Attribute:
    name: str = ""
    value: object = None


@dataclasses.dataclass
class Node:
    op_type: str = ""
    name: str = ""
    input: List[str] = dataclasses.field(default_factory=list)
    output: List[str] = dataclasses.field(default_factory=list)
    attribute: List[Attribute] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Tensor:
    name: str = ""
    array: Optional[np.ndarray] = None


@dataclasses.dataclass
class ValueInfo:
    name: str = ""
    # static dims from TypeProto.tensor_type.shape (None = symbolic)
    shape: Optional[List[Optional[int]]] = None


@dataclasses.dataclass
class GraphDef:
    node: List[Node] = dataclasses.field(default_factory=list)
    initializer: List[Tensor] = dataclasses.field(default_factory=list)
    input: List[ValueInfo] = dataclasses.field(default_factory=list)
    output: List[ValueInfo] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelDef:
    graph: GraphDef = dataclasses.field(default_factory=GraphDef)


def _parse_tensor(buf: bytes) -> Tensor:
    dims: List[int] = []
    dtype = 1
    raw = None
    floats: List[float] = []
    int32s: List[int] = []
    int64s: List[int] = []
    doubles: List[float] = []
    name = ""
    for field, wt, v in _fields(buf):
        if field == 1:
            dims.extend(_packed_varints(v) if wt == 2 else [v])
        elif field == 2:
            dtype = v
        elif field == 4:  # float_data (packed floats)
            floats.extend(struct.unpack(f"<{len(v) // 4}f", v)
                          if wt == 2 else struct.unpack("<f", v))
        elif field == 5:
            int32s.extend(_packed_varints(v) if wt == 2 else [v])
        elif field == 7:
            vals = _packed_varints(v) if wt == 2 else [v]
            int64s.extend(_signed(x) for x in vals)
        elif field == 8:
            name = v.decode()
        elif field == 9:
            raw = v
        elif field == 10:
            doubles.extend(struct.unpack(f"<{len(v) // 8}d", v)
                           if wt == 2 else struct.unpack("<d", v))
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"unsupported TensorProto data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, dtype=np_dtype)
    elif doubles:
        arr = np.asarray(doubles, dtype=np_dtype)
    elif int64s:
        arr = np.asarray(int64s, dtype=np_dtype)
    elif int32s:
        # int32_data is the spec container for int8/16/32 AND float16:
        # values are 32-bit two's complement varints (sign-convert),
        # except float16 which is bit-packed in the low 16 bits
        vals = [v & 0xFFFFFFFF for v in int32s]
        if np_dtype == np.float16:
            arr = np.asarray(vals, dtype=np.uint32).astype(
                np.uint16
            ).view(np.float16)
        else:
            signed = [v - (1 << 32) if v >= (1 << 31) else v for v in vals]
            arr = np.asarray(signed, dtype=np.int64).astype(np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    if dims or arr.size == 1:
        arr = arr.reshape(dims)  # [] -> 0-d scalar, like numpy_helper
    return Tensor(name=name, array=arr)


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    atype = 0
    f = i64 = s = t = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wt, v in _fields(buf):
        if field == 1:
            a.name = v.decode()
        elif field == 2:
            f = struct.unpack("<f", v)[0]
        elif field == 3:
            i64 = _signed(v)
        elif field == 4:
            s = v
        elif field == 5:
            t = _parse_tensor(v)
        elif field == 7:
            floats.extend(struct.unpack(f"<{len(v) // 4}f", v)
                          if wt == 2 else struct.unpack("<f", v))
        elif field == 8:
            vals = _packed_varints(v) if wt == 2 else [v]
            ints.extend(_signed(x) for x in vals)
        elif field == 9:
            strings.append(v)
        elif field == 20:
            atype = v
    # AttributeProto.AttributeType: FLOAT=1 INT=2 STRING=3 TENSOR=4
    # FLOATS=6 INTS=7 STRINGS=8; infer when the writer omitted type
    if atype == 1 or (atype == 0 and f is not None):
        a.value = f
    elif atype == 2 or (atype == 0 and i64 is not None):
        a.value = i64
    elif atype == 3 or (atype == 0 and s is not None):
        # bytes, matching onnx.helper.get_attribute_value: handlers see
        # the same type whichever parser decoded the model
        a.value = s
    elif atype == 4 or (atype == 0 and t is not None):
        a.value = t.array
    elif atype == 6 or (atype == 0 and floats):
        a.value = list(floats)
    elif atype == 7 or (atype == 0 and ints):
        a.value = list(ints)
    elif atype == 8 or (atype == 0 and strings):
        a.value = list(strings)  # bytes, like the onnx package
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for field, wt, v in _fields(buf):
        if field == 1:
            n.input.append(v.decode())
        elif field == 2:
            n.output.append(v.decode())
        elif field == 3:
            n.name = v.decode()
        elif field == 4:
            n.op_type = v.decode()
        elif field == 5:
            n.attribute.append(_parse_attribute(v))
    return n


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for field, wt, v in _fields(buf):
        if field == 1:
            vi.name = v.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(v):
                if f2 == 1:  # TypeProto.Tensor
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # TensorShapeProto
                            dims: List[Optional[int]] = []
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # Dimension
                                    dv: Optional[int] = None
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:  # dim_value
                                            dv = v5
                                    dims.append(dv)
                            vi.shape = dims
    return vi


def _parse_graph(buf: bytes) -> GraphDef:
    g = GraphDef()
    for field, wt, v in _fields(buf):
        if field == 1:
            g.node.append(_parse_node(v))
        elif field == 5:
            g.initializer.append(_parse_tensor(v))
        elif field == 11:
            g.input.append(_parse_value_info(v))
        elif field == 12:
            g.output.append(_parse_value_info(v))
    return g


def load_model(src: Union[str, bytes]) -> ModelDef:
    """Parse a serialized ONNX ModelProto (path or bytes)."""
    if isinstance(src, str):
        with open(src, "rb") as fh:
            src = fh.read()
    m = ModelDef()
    for field, wt, v in _fields(src):
        if field == 7:
            m.graph = _parse_graph(v)
    return m


# ---------------------------------------------------------------------------
# encoder (graph building / export)
# ---------------------------------------------------------------------------

def _varint(x: int) -> bytes:
    out = bytearray()
    x &= (1 << 64) - 1
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _vi(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value)


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = b"".join(_vi(1, d) for d in arr.shape)
    out += _vi(2, code)
    out += _ld(8, name.encode())
    out += _ld(9, arr.tobytes())
    return out


def encode_attribute(name: str, value) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        out += _varint((2 << 3) | 5) + struct.pack("<f", value) + _vi(20, 1)
    elif isinstance(value, (bool, int, np.integer)):
        out += _vi(3, int(value)) + _vi(20, 2)
    elif isinstance(value, str):
        out += _ld(4, value.encode()) + _vi(20, 3)
    elif isinstance(value, np.ndarray):
        out += _ld(5, encode_tensor(name, value)) + _vi(20, 4)
    elif isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], float):
        for f in value:
            out += _varint((7 << 3) | 5) + struct.pack("<f", f)
        out += _vi(20, 6)
    elif isinstance(value, (list, tuple)):
        for i in value:
            out += _vi(8, int(i))
        out += _vi(20, 7)
    else:
        raise ValueError(f"unsupported attribute value {value!r}")
    return out


def encode_node(op_type: str, inputs, outputs, name: str = "",
                **attrs) -> bytes:
    out = b"".join(_ld(1, s.encode()) for s in inputs)
    out += b"".join(_ld(2, s.encode()) for s in outputs)
    if name:
        out += _ld(3, name.encode())
    out += _ld(4, op_type.encode())
    for k, v in attrs.items():
        out += _ld(5, encode_attribute(k, v))
    return out


def _encode_value_info(name: str, shape=None) -> bytes:
    out = _ld(1, name.encode())
    if shape is not None:
        dims = b"".join(
            _ld(1, _vi(1, int(d)) if d is not None else b"") for d in shape
        )
        # TypeProto{ tensor_type{ elem_type=FLOAT, shape{dims} } }
        tensor_type = _vi(1, 1) + _ld(2, dims)
        out += _ld(2, _ld(1, tensor_type))
    return out


def encode_model(nodes: List[bytes], inputs, outputs,
                 initializers: Dict[str, np.ndarray]) -> bytes:
    """inputs/outputs: names, or (name, shape) pairs to record static
    tensor shapes."""

    def vi_bytes(entry) -> bytes:
        if isinstance(entry, str):
            return _encode_value_info(entry)
        return _encode_value_info(entry[0], entry[1])

    g = b"".join(_ld(1, n) for n in nodes)
    g += b"".join(
        _ld(5, encode_tensor(k, v)) for k, v in initializers.items()
    )
    g += b"".join(_ld(11, vi_bytes(s)) for s in inputs)
    g += b"".join(_ld(12, vi_bytes(s)) for s in outputs)
    return _vi(1, 8) + _ld(7, g)  # ir_version=8, graph
