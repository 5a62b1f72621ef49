"""Minimal vendored ONNX: real protobuf wire format, no `onnx` package
(this package's own copy of `mxnet_tpu/contrib/onnx/onnx_shim.py`).

The ONNX file format is plain protobuf (the message schema is the public
`onnx/onnx.proto`); this shim implements just the messages and helper
surface the converters in this package use — ModelProto/GraphProto/
NodeProto/AttributeProto/TensorProto/ValueInfoProto, `helper.make_*`,
`numpy_helper.from_array/to_array`, `load`, `save`.  Files written here
load in real onnx/onnxruntime and vice versa (same wire bytes).

Used as an automatic fallback by `_require_onnx` when the real `onnx`
package is absent; when `onnx` IS installed it is
preferred untouched.

Wire format: each field is a varint key ``(field_number << 3) | wire_type``
with wire_type 0 = varint, 2 = length-delimited (strings, bytes,
submessages, packed repeated scalars), 5 = fixed32 (float).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's-complement 64-bit, per protobuf int64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return result, pos


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _key(field: int, wire: int) -> bytes:
    return _enc_varint((field << 3) | wire)


def _enc_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _enc_varint(len(data)) + data


def _enc_str(field: int, s: str) -> bytes:
    return _enc_bytes(field, s.encode("utf-8"))


def _enc_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _enc_varint(int(v))


def _enc_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(v))


# ---------------------------------------------------------------------------
# message base: subclasses declare FIELDS = {py_name: (num, kind[, cls])}
# kind in {"int", "float", "str", "bytes", "msg",
#          "rep_int", "rep_float", "rep_str", "rep_bytes", "rep_msg",
#          "packed_int", "packed_float"}
# repeated scalar decode accepts BOTH packed and unpacked encodings
# (protobuf parsers must; serializers here pack).
# ---------------------------------------------------------------------------


class Message:
    FIELDS: Dict[str, tuple] = {}

    def __init__(self, **kw):
        for name, spec in self.FIELDS.items():
            kind = spec[1]
            if kind.startswith(("rep_", "packed_")):
                setattr(self, name, [])
            elif kind == "msg":
                setattr(self, name, None)
            elif kind == "int":
                setattr(self, name, 0)
            elif kind == "float":
                setattr(self, name, 0.0)
            elif kind == "bytes":
                setattr(self, name, b"")
            else:
                setattr(self, name, "")
        for k, v in kw.items():
            setattr(self, k, v)

    # -- encode ------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for name, spec in self.FIELDS.items():
            num, kind = spec[0], spec[1]
            v = getattr(self, name)
            if kind == "int":
                if v:
                    out += _enc_int(num, v)
            elif kind == "float":
                if v:
                    out += _key(num, 5) + struct.pack("<f", float(v))
            elif kind == "str":
                if v:
                    out += _enc_str(num, v)
            elif kind == "bytes":
                if v:
                    out += _enc_bytes(num, bytes(v))
            elif kind == "msg":
                if v is not None:
                    out += _enc_bytes(num, v.SerializeToString())
            elif kind == "rep_msg":
                for m in v:
                    out += _enc_bytes(num, m.SerializeToString())
            elif kind == "rep_str":
                for s in v:
                    out += _enc_str(num, s)
            elif kind == "rep_bytes":
                for s in v:
                    out += _enc_bytes(num, bytes(s))
            elif kind in ("rep_int", "packed_int"):
                if v:
                    payload = b"".join(_enc_varint(int(x)) for x in v)
                    out += _enc_bytes(num, payload)
            elif kind in ("rep_float", "packed_float"):
                if v:
                    out += _enc_bytes(num,
                                      struct.pack(f"<{len(v)}f", *v))
            else:
                raise ValueError(kind)
        return bytes(out)

    # -- decode ------------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes):
        self = cls()
        by_num = {spec[0]: (name, spec) for name, spec in cls.FIELDS.items()}
        pos, end = 0, len(data)
        while pos < end:
            tag, pos = _dec_varint(data, pos)
            num, wire = tag >> 3, tag & 7
            if wire == 0:
                val, pos = _dec_varint(data, pos)
                payload = None
            elif wire == 5:
                val = struct.unpack_from("<f", data, pos)[0]
                pos += 4
                payload = None
            elif wire == 1:
                val = struct.unpack_from("<d", data, pos)[0]
                pos += 8
                payload = None
            elif wire == 2:
                n, pos = _dec_varint(data, pos)
                payload = data[pos:pos + n]
                pos += n
                val = None
            else:
                raise ValueError(f"unsupported wire type {wire}")
            if num not in by_num:
                continue  # unknown field: skip (forward compat)
            name, spec = by_num[num]
            kind = spec[1]
            if kind == "int":
                setattr(self, name, _signed64(val))
            elif kind == "float":
                setattr(self, name, val)
            elif kind == "str":
                setattr(self, name, payload.decode("utf-8"))
            elif kind == "bytes":
                setattr(self, name, payload)
            elif kind == "msg":
                setattr(self, name, spec[2].FromString(payload))
            elif kind == "rep_msg":
                getattr(self, name).append(spec[2].FromString(payload))
            elif kind == "rep_str":
                getattr(self, name).append(payload.decode("utf-8"))
            elif kind == "rep_bytes":
                getattr(self, name).append(payload)
            elif kind in ("rep_int", "packed_int"):
                if payload is None:
                    getattr(self, name).append(_signed64(val))
                else:
                    p = 0
                    while p < len(payload):
                        x, p = _dec_varint(payload, p)
                        getattr(self, name).append(_signed64(x))
            elif kind in ("rep_float", "packed_float"):
                if payload is None:
                    getattr(self, name).append(val)
                else:
                    getattr(self, name).extend(
                        struct.unpack(f"<{len(payload) // 4}f", payload))
        return self

    def __repr__(self):
        fields = {n: getattr(self, n) for n in self.FIELDS
                  if getattr(self, n)}
        return f"{type(self).__name__}({fields})"


# ---------------------------------------------------------------------------
# ONNX messages (field numbers from the public onnx.proto)
# ---------------------------------------------------------------------------


class TensorProto(Message):
    # DataType enum values (public onnx.proto)
    FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
    STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
    FIELDS = {
        "dims": (1, "packed_int"),
        "data_type": (2, "int"),
        "float_data": (4, "packed_float"),
        "int32_data": (5, "packed_int"),
        "string_data": (6, "rep_bytes"),
        "int64_data": (7, "packed_int"),
        "name": (8, "str"),
        "raw_data": (9, "bytes"),
    }


_NP_TO_ONNX = {
    np.dtype(np.float32): TensorProto.FLOAT,
    np.dtype(np.uint8): TensorProto.UINT8,
    np.dtype(np.int8): TensorProto.INT8,
    np.dtype(np.int32): TensorProto.INT32,
    np.dtype(np.int64): TensorProto.INT64,
    np.dtype(np.float64): TensorProto.DOUBLE,
    np.dtype(np.bool_): TensorProto.BOOL,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


class TensorShapeDim(Message):
    FIELDS = {"dim_value": (1, "int"), "dim_param": (2, "str")}


class TensorShapeProto(Message):
    FIELDS = {"dim": (1, "rep_msg", TensorShapeDim)}


class TypeProtoTensor(Message):
    FIELDS = {"elem_type": (1, "int"),
              "shape": (2, "msg", TensorShapeProto)}


class TypeProto(Message):
    FIELDS = {"tensor_type": (1, "msg", TypeProtoTensor)}


class ValueInfoProto(Message):
    FIELDS = {"name": (1, "str"), "type": (2, "msg", TypeProto)}


class AttributeProto(Message):
    # AttributeType enum
    FLOAT, INT, STRING, TENSOR, GRAPH = 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10
    FIELDS = {
        "name": (1, "str"),
        "f": (2, "float"),
        "i": (3, "int"),
        "s": (4, "bytes"),
        "t": (5, "msg", TensorProto),
        "floats": (7, "rep_float"),
        "ints": (8, "packed_int"),
        "strings": (9, "rep_bytes"),
        "tensors": (10, "rep_msg", TensorProto),
        "type": (20, "int"),
    }


class NodeProto(Message):
    FIELDS = {
        "input": (1, "rep_str"),
        "output": (2, "rep_str"),
        "name": (3, "str"),
        "op_type": (4, "str"),
        "attribute": (5, "rep_msg", AttributeProto),
        "doc_string": (6, "str"),
        "domain": (7, "str"),
    }


class GraphProto(Message):
    FIELDS = {
        "node": (1, "rep_msg", NodeProto),
        "name": (2, "str"),
        "initializer": (5, "rep_msg", TensorProto),
        "doc_string": (10, "str"),
        "input": (11, "rep_msg", ValueInfoProto),
        "output": (12, "rep_msg", ValueInfoProto),
        "value_info": (13, "rep_msg", ValueInfoProto),
    }


class OperatorSetIdProto(Message):
    FIELDS = {"domain": (1, "str"), "version": (2, "int")}


class ModelProto(Message):
    FIELDS = {
        "ir_version": (1, "int"),
        "producer_name": (2, "str"),
        "producer_version": (3, "str"),
        "domain": (4, "str"),
        "model_version": (5, "int"),
        "doc_string": (6, "str"),
        "graph": (7, "msg", GraphProto),
        "opset_import": (8, "rep_msg", OperatorSetIdProto),
    }


# ---------------------------------------------------------------------------
# helper / numpy_helper / load / save — the surface the converters use
# ---------------------------------------------------------------------------


def _make_attribute(name: str, value: Any) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(value, float):
        a.f, a.type = value, AttributeProto.FLOAT
    elif isinstance(value, bool):
        a.i, a.type = int(value), AttributeProto.INT
    elif isinstance(value, int):
        a.i, a.type = value, AttributeProto.INT
    elif isinstance(value, str):
        a.s, a.type = value.encode("utf-8"), AttributeProto.STRING
    elif isinstance(value, bytes):
        a.s, a.type = value, AttributeProto.STRING
    elif isinstance(value, TensorProto):
        a.t, a.type = value, AttributeProto.TENSOR
    elif isinstance(value, (list, tuple, np.ndarray)):
        vals = list(value)
        if all(isinstance(v, (int, np.integer)) for v in vals):
            a.ints, a.type = [int(v) for v in vals], AttributeProto.INTS
        elif all(isinstance(v, (int, float, np.floating, np.integer))
                 for v in vals):
            a.floats = [float(v) for v in vals]
            a.type = AttributeProto.FLOATS
        elif all(isinstance(v, (str, bytes)) for v in vals):
            a.strings = [v.encode("utf-8") if isinstance(v, str) else v
                         for v in vals]
            a.type = AttributeProto.STRINGS
        else:
            raise TypeError(f"attribute {name}: mixed list {value!r}")
    else:
        raise TypeError(f"attribute {name}: unsupported {type(value)}")
    return a


class helper:
    @staticmethod
    def make_node(op_type: str, inputs: List[str], outputs: List[str],
                  name: str = "", doc_string: str = "", domain: str = "",
                  **kwargs) -> NodeProto:
        n = NodeProto(op_type=op_type, name=name, doc_string=doc_string,
                      domain=domain)
        n.input = list(inputs)
        n.output = list(outputs)
        n.attribute = [_make_attribute(k, v)
                       for k, v in sorted(kwargs.items())
                       if v is not None]
        return n

    @staticmethod
    def make_tensor_value_info(name: str, elem_type: int,
                               shape: Optional[List] = None
                               ) -> ValueInfoProto:
        tt = TypeProtoTensor(elem_type=elem_type)
        if shape is not None:
            sp = TensorShapeProto()
            for d in shape:
                if isinstance(d, str):
                    sp.dim.append(TensorShapeDim(dim_param=d))
                else:
                    sp.dim.append(TensorShapeDim(dim_value=int(d)))
            tt.shape = sp
        return ValueInfoProto(name=name, type=TypeProto(tensor_type=tt))

    @staticmethod
    def make_graph(nodes, name, inputs, outputs,
                   initializer=None) -> GraphProto:
        g = GraphProto(name=name)
        g.node = list(nodes)
        g.input = list(inputs)
        g.output = list(outputs)
        g.initializer = list(initializer or [])
        return g

    @staticmethod
    def make_model(graph: GraphProto, producer_name: str = "",
                   opset_imports=None, ir_version: int = 8,
                   **kwargs) -> ModelProto:
        m = ModelProto(ir_version=ir_version, producer_name=producer_name,
                       graph=graph)
        m.opset_import = list(opset_imports or
                              [OperatorSetIdProto(domain="", version=13)])
        return m

    @staticmethod
    def get_attribute_value(a: AttributeProto):
        t = a.type
        if t == AttributeProto.FLOAT:
            return a.f
        if t == AttributeProto.INT:
            return a.i
        if t == AttributeProto.STRING:
            return a.s.decode("utf-8") if isinstance(a.s, bytes) else a.s
        if t == AttributeProto.TENSOR:
            return a.t
        if t == AttributeProto.FLOATS:
            return list(a.floats)
        if t == AttributeProto.INTS:
            return list(a.ints)
        if t == AttributeProto.STRINGS:
            return [s.decode("utf-8") for s in a.strings]
        raise ValueError(f"unsupported attribute type {t}")


class numpy_helper:
    @staticmethod
    def from_array(arr: np.ndarray, name: str = "") -> TensorProto:
        arr = np.asarray(arr)
        if arr.dtype not in _NP_TO_ONNX:
            raise TypeError(f"unsupported dtype {arr.dtype}")
        t = TensorProto(name=name, data_type=_NP_TO_ONNX[arr.dtype])
        t.dims = list(arr.shape)
        t.raw_data = np.ascontiguousarray(arr).tobytes()
        return t

    @staticmethod
    def to_array(t: TensorProto) -> np.ndarray:
        if t.data_type not in _ONNX_TO_NP:
            raise TypeError(f"unsupported TensorProto dtype {t.data_type}")
        dt = _ONNX_TO_NP[t.data_type]
        shape = tuple(t.dims)
        if t.raw_data:
            return np.frombuffer(t.raw_data, dtype=dt).reshape(shape).copy()
        if t.data_type == TensorProto.FLOAT and t.float_data:
            return np.asarray(t.float_data, np.float32).reshape(shape)
        if t.data_type == TensorProto.INT64 and t.int64_data:
            return np.asarray(t.int64_data, np.int64).reshape(shape)
        if t.data_type in (TensorProto.INT32, TensorProto.INT8,
                           TensorProto.UINT8, TensorProto.BOOL) \
                and t.int32_data:
            return np.asarray(t.int32_data).astype(dt).reshape(shape)
        return np.zeros(shape, dt)


def load(path) -> ModelProto:
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    return ModelProto.FromString(data)


def save(model: ModelProto, path) -> None:
    data = model.SerializeToString()
    if hasattr(path, "write"):
        path.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


# The shim module itself exposes the same attribute surface the
# converters use (TensorProto, helper, numpy_helper, load, save) — they
# access it via the module object returned by `_require_onnx`, so
# sys.modules is never touched and third-party `import onnx`
# feature-detection stays truthful.
