"""ONNX export without the onnx package — hand-encoded protobuf.

Counterpart of sdf_representation_tpu/export/onnx_export.py (the role of
the reference's `save_as_onxx`, reference utils/inference_conversion.py:
69-110: opset 15, dynamic batch axis, model.onnx for the DeepTrace ONNX
Runtime consumer). The ModelProto is written directly via the minimal
wire-format encoder in protobuf_min.py, so neither onnx nor onnxruntime is
needed; for the same weights the file is the JAX package's byte for byte
(the producer name included).

Graph emitted for ImplicitNet (input "points" [batch, d_in] float32,
output "sdf" [batch, 1]):

  per layer:  Gemm(x, W(in,out), b)          [transB=0, so W is stored (in,out)]
  activation: Softplus with sharpness beta is expressed as
              Mul(x, beta) -> Softplus -> Div(beta)   (ONNX Softplus has no beta)
              or Relu when beta == 0, with a final Tanh in ReLU mode
  skip layer: Concat(h, points, axis=1) -> Mul 1/sqrt(2) -> Gemm

Field numbers follow onnx.proto3 (ModelProto, GraphProto, NodeProto,
TensorProto, ValueInfoProto, TypeProto, AttributeProto).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import protobuf_min as pb
from .native_format import export_layers
from .quantize import quantize_layers

# onnx TensorProto.DataType
FLOAT = 1
INT8 = 3

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_TENSOR = 4
ATTR_INTS = 7


def _attr_float(name: str, value: float) -> bytes:
    return pb.f_message(
        5,
        pb.f_string(1, name) + pb.tag(2, 5) + struct.pack("<f", value)
        + pb.f_varint(20, ATTR_FLOAT),
    )


def _attr_int(name: str, value: int) -> bytes:
    return pb.f_message(
        5, pb.f_string(1, name) + pb.f_varint(3, value) + pb.f_varint(20, ATTR_INT)
    )


def _node(op_type: str, inputs, outputs, name: str, attrs: bytes = b"") -> bytes:
    payload = b"".join(pb.f_string(1, i) for i in inputs)
    payload += b"".join(pb.f_string(2, o) for o in outputs)
    payload += pb.f_string(3, name)
    payload += pb.f_string(4, op_type)
    payload += attrs
    return pb.f_message(1, payload)  # GraphProto.node


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    payload = b"".join(pb.f_varint(1, d) for d in arr.shape)
    payload += pb.f_varint(2, FLOAT)
    payload += pb.f_string(8, name)
    payload += pb.f_bytes(9, arr.tobytes())  # raw_data
    return payload


def _tensor_int8(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.int8)
    payload = b"".join(pb.f_varint(1, d) for d in arr.shape)
    payload += pb.f_varint(2, INT8)
    payload += pb.f_string(8, name)
    payload += pb.f_bytes(9, arr.tobytes())  # raw_data
    return payload


def _value_info(name: str, shape) -> bytes:
    """shape entries: int -> dim_value, str -> dim_param (dynamic)."""
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += pb.f_message(1, pb.f_string(2, d))
        else:
            dims += pb.f_message(1, pb.f_varint(1, int(d)))
    tensor_type = pb.f_varint(1, FLOAT) + pb.f_message(2, dims)
    type_proto = pb.f_message(1, tensor_type)
    return pb.f_string(1, name) + pb.f_message(2, type_proto)


def save_as_onnx(path: str, model, opset: int = 15, quantize: bool = False) -> str:
    """Write model.onnx for a port ImplicitNet. Dynamic batch dimension.

    quantize=True emits the weight-only int8 artifact the reference's
    ``quantize_save`` produces via onnxruntime dynamic quantization
    (reference utils/inference_conversion.py:113-114): each Gemm weight is
    stored as an int8 initializer with per-output-channel scales and
    dequantized in-graph by a DequantizeLinear node (axis=1, symmetric —
    zero_point omitted = 0 per the ONNX spec); biases and all compute stay
    float32, exactly ORT's dynamic-quant semantics. Scales come from
    export/quantize.quantize_layers — the same scheme as the .sdfw v2
    container, so the two quantized artifacts are numerically identical."""
    layers = export_layers(model)
    d_in = model.d_in
    beta = float(model.beta)
    n_lin = model.num_layers - 1
    inv_sqrt2 = 1.0 / math.sqrt(2.0)

    if quantize:
        qlayers = quantize_layers(layers)

    graph = b""
    initializers = []
    nodes = []

    x = "points"
    for l in range(n_lin):
        b = layers[l]["b"]
        wname, bname = f"W{l}", f"B{l}"
        if quantize:
            initializers.append(_tensor_int8(f"Wq{l}", qlayers[l]["wq"]))
            initializers.append(_tensor(f"WS{l}", qlayers[l]["scale"]))
            nodes.append(
                _node("DequantizeLinear", [f"Wq{l}", f"WS{l}"], [wname],
                      f"dequant{l}", _attr_int("axis", 1))
            )
        else:
            initializers.append(_tensor(wname, layers[l]["w"]))
        initializers.append(_tensor(bname, b))

        if l in model.skip_in:
            cat = f"concat{l}"
            nodes.append(
                _node("Concat", [x, "points"], [cat], f"concat_node{l}",
                      _attr_int("axis", 1))
            )
            scaled = f"skipscale{l}"
            if l == min(s for s in model.skip_in if s > 0):
                # shared constant — emit once (duplicate initializer names
                # are invalid ONNX when a model has several skip layers)
                initializers.append(
                    _tensor("inv_sqrt2", np.asarray([inv_sqrt2], np.float32))
                )
            nodes.append(
                _node("Mul", [cat, "inv_sqrt2"], [scaled], f"skipmul{l}")
            )
            x = scaled

        lin = f"lin{l}"
        nodes.append(_node("Gemm", [x, wname, bname], [lin], f"gemm{l}"))
        x = lin

        if l < n_lin - 1:
            if beta > 0:
                if l == 0:
                    initializers.append(
                        _tensor("beta_c", np.asarray([beta], np.float32))
                    )
                mul, sp, act = f"betamul{l}", f"softplus{l}", f"act{l}"
                nodes.append(_node("Mul", [x, "beta_c"], [mul], f"bm{l}"))
                nodes.append(_node("Softplus", [mul], [sp], f"sp{l}"))
                nodes.append(_node("Div", [sp, "beta_c"], [act], f"dv{l}"))
                x = act
            else:
                act = f"relu{l}"
                nodes.append(_node("Relu", [x], [act], f"relu_node{l}"))
                x = act
        elif beta <= 0:
            act = "tanh_out"
            nodes.append(_node("Tanh", [x], [act], f"tanh_node"))
            x = act

    nodes.append(_node("Identity", [x], ["sdf"], "out_identity"))

    graph += b"".join(nodes)
    graph += pb.f_string(2, "implicit_net")
    graph += b"".join(pb.f_message(5, t) for t in initializers)
    graph += pb.f_message(11, _value_info("points", ["batch", d_in]))
    graph += pb.f_message(12, _value_info("sdf", ["batch", 1]))

    opset_import = pb.f_message(8, pb.f_string(1, "") + pb.f_varint(2, opset))
    model_proto = (
        pb.f_varint(1, 8)  # ir_version
        + pb.f_string(2, "sdf_representation_tpu")
        + pb.f_string(3, "0.1.0")
        + pb.f_message(7, graph)
        + opset_import
    )
    with open(path, "wb") as f:
        f.write(model_proto)
    return path


def save_as_onnx_quantized(path: str, model, opset: int = 15) -> str:
    """The reference's ``quantize_save`` equivalent: a small int8-weight
    model.onnx for ORT-style consumers (see save_as_onnx(quantize=True))."""
    return save_as_onnx(path, model, opset=opset, quantize=True)
