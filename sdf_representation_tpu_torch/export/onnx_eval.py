"""Independent ONNX evaluator — closes the export loop without onnxruntime.
A copy of sdf_representation_tpu/export/onnx_eval.py (numpy only).

The exported model.onnx's native contract is "runs under ONNX Runtime"
(reference ops/DeepTrace/src/deeptrace.cpp:30-33,59-71 and
utils/inference_conversion.py:101-110). Validating it by decoding with the
writer's own encoder would be circular — a shared misconception (Gemm
attribute defaults, initializer raw-data layout, packed-repeated encodings)
would break a real consumer and no test would notice.

This module therefore implements, FROM THE WIRE SPEC AND onnx.proto3 —
deliberately sharing no code with export/protobuf_min.py:

  * a generic protobuf wire-format reader (varint / 64-bit / length-
    delimited / 32-bit fields; repeated scalars accepted in both packed and
    unpacked encodings, as the spec requires of parsers);
  * a numeric executor that walks GraphProto nodes generically and
    implements the opset subset the exporter can emit — Gemm (honouring
    alpha/beta/transA/transB INCLUDING their spec defaults), MatMul, Relu,
    Softplus, Tanh, Mul, Div, Add, Sub, Concat, Identity — with numpy
    broadcasting semantics.

tests/test_onnx_eval.py diffs this executor against ``model.apply`` to
float32 epsilon and exercises non-default Gemm attributes adversarially;
tests/test_torch_export.py runs it on the port's files.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# protobuf wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _fields(buf: bytes) -> Dict[int, List[Tuple[int, object]]]:
    """Decode one message into {field_number: [(wire_type, raw_value), ...]}.

    Length-delimited values stay as bytes (decoded on demand: submessage,
    string, packed scalars — the schema decides, as in real protobuf)."""
    out: Dict[int, List[Tuple[int, object]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wt == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append((wt, val))
    return out


def _ints(entries) -> List[int]:
    """Repeated int field: accept packed (LEN) and unpacked (VARINT) forms."""
    vals: List[int] = []
    for wt, raw in entries:
        if wt == _VARINT:
            vals.append(raw)
        elif wt == _LEN:
            pos = 0
            while pos < len(raw):
                v, pos = _read_varint(raw, pos)
                vals.append(v)
        else:
            raise ValueError("bad repeated-int encoding")
    return vals


def _floats(entries) -> List[float]:
    """Repeated float field: packed (LEN) and unpacked (I32) forms."""
    vals: List[float] = []
    for wt, raw in entries:
        if wt == _I32:
            vals.append(struct.unpack("<f", raw)[0])
        elif wt == _LEN:
            vals.extend(np.frombuffer(raw, dtype="<f4").tolist())
        else:
            raise ValueError("bad repeated-float encoding")
    return vals


# onnx TensorProto.DataType
_DT_FLOAT, _DT_INT8, _DT_UINT8, _DT_INT64, _DT_DOUBLE = 1, 3, 2, 7, 11


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = _fields(buf)
    dims = _ints(f.get(1, []))
    dtype = _ints(f.get(2, []))[0] if 2 in f else _DT_FLOAT
    name = f[8][0][1].decode() if 8 in f else ""
    if 9 in f:  # raw_data: fixed-width little-endian, row-major
        raw = f[9][0][1]
        np_dt = {_DT_FLOAT: "<f4", _DT_INT8: "i1", _DT_UINT8: "u1",
                 _DT_INT64: "<i8", _DT_DOUBLE: "<f8"}[dtype]
        arr = np.frombuffer(raw, dtype=np_dt)
    elif dtype == _DT_FLOAT and 4 in f:  # float_data
        arr = np.asarray(_floats(f[4]), np.float32)
    elif dtype == _DT_INT64 and 7 in f:  # int64_data
        arr = np.asarray(_ints(f[7]), np.int64)
    else:
        raise ValueError(f"tensor {name!r}: no data field for dtype {dtype}")
    return name, arr.reshape(dims)


def _parse_attr(buf: bytes) -> Tuple[str, object]:
    f = _fields(buf)
    name = f[1][0][1].decode()
    # AttributeProto: f=2 (float, I32), i=3 (varint), s=4, t=5 (tensor),
    # floats=7, ints=8. Presence decides; the type field (20) is advisory.
    if 2 in f:
        return name, struct.unpack("<f", f[2][0][1])[0]
    if 3 in f:
        v = f[3][0][1]
        # zigzag is NOT used for int64 in proto3 plain int64 fields
        if v >= 1 << 63:
            v -= 1 << 64
        return name, v
    if 4 in f:
        return name, f[4][0][1].decode()
    if 5 in f:
        return name, _parse_tensor(f[5][0][1])[1]
    if 7 in f:
        return name, _floats(f[7])
    if 8 in f:
        return name, _ints(f[8])
    return name, None


def _parse_value_info_name(buf: bytes) -> str:
    f = _fields(buf)
    return f[1][0][1].decode()


def load_model(path: str):
    """Parse a ModelProto -> (nodes, initializers, input_names, output_names).

    nodes: list of (op_type, inputs, outputs, attrs-dict)."""
    with open(path, "rb") as fh:
        model = _fields(fh.read())
    graph = _fields(model[7][0][1])  # ModelProto.graph

    inits: Dict[str, np.ndarray] = {}
    for _, raw in graph.get(5, []):  # initializer
        name, arr = _parse_tensor(raw)
        inits[name] = arr

    nodes = []
    for _, raw in graph.get(1, []):  # node
        nf = _fields(raw)
        inputs = [v.decode() for _, v in nf.get(1, [])]
        outputs = [v.decode() for _, v in nf.get(2, [])]
        op_type = nf[4][0][1].decode()
        attrs = dict(_parse_attr(v) for _, v in nf.get(5, []))
        nodes.append((op_type, inputs, outputs, attrs))

    input_names = [_parse_value_info_name(v) for _, v in graph.get(11, [])]
    output_names = [_parse_value_info_name(v) for _, v in graph.get(12, [])]
    return nodes, inits, input_names, output_names


def _softplus(x):
    # numerically stable log(1 + exp(x))
    return np.logaddexp(0.0, x)


def _gemm(a, b, c, attrs):
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    if int(attrs.get("transA", 0)):
        a = a.T
    if int(attrs.get("transB", 0)):
        b = b.T
    y = alpha * (a @ b)
    if c is not None:
        y = y + beta * c
    return y


def run_onnx(path: str, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Evaluate model.onnx on `feeds` ({input_name: array}); returns
    {output_name: array}. Generic node walk — no assumptions about the
    graph beyond the supported op set."""
    nodes, inits, input_names, output_names = load_model(path)
    env: Dict[str, np.ndarray] = dict(inits)
    for name in input_names:
        if name not in feeds and name not in env:
            raise ValueError(f"missing feed for graph input {name!r}")
    for k, v in feeds.items():
        env[k] = np.asarray(v, np.float32)

    for op, ins, outs, attrs in nodes:
        x = [env[i] for i in ins if i]
        if op == "Gemm":
            y = _gemm(x[0], x[1], x[2] if len(x) > 2 else None, attrs)
        elif op == "MatMul":
            y = x[0] @ x[1]
        elif op == "Relu":
            y = np.maximum(x[0], 0)
        elif op == "Softplus":
            y = _softplus(x[0])
        elif op == "Tanh":
            y = np.tanh(x[0])
        elif op == "Mul":
            y = x[0] * x[1]
        elif op == "Div":
            y = x[0] / x[1]
        elif op == "Add":
            y = x[0] + x[1]
        elif op == "Sub":
            y = x[0] - x[1]
        elif op == "Concat":
            y = np.concatenate(x, axis=int(attrs.get("axis", 0)))
        elif op == "Identity":
            y = x[0]
        elif op == "DequantizeLinear":
            # y = (x - zero_point) * scale; per-axis when scale is a vector
            # (opset 13+; axis defaults to 1 per the spec)
            xq = x[0].astype(np.float32)
            scale = np.asarray(x[1], np.float32)
            if len(x) > 2:
                xq = xq - x[2].astype(np.float32)
            if scale.ndim == 0 or scale.size == 1:
                y = xq * scale
            else:
                axis = int(attrs.get("axis", 1))
                shape = [1] * xq.ndim
                shape[axis] = scale.size
                y = xq * scale.reshape(shape)
        else:
            raise NotImplementedError(f"ONNX op {op!r} not supported")
        env[outs[0]] = np.asarray(y, np.float32)

    return {name: env[name] for name in output_names}
