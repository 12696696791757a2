"""ORT-strictness structural lint for exported model.onnx — a copy of
sdf_representation_tpu/export/onnx_lint.py (numpy-free, torch-free).

The artifact's native contract is "loads under ONNX Runtime" (reference
ops/DeepTrace/src/deeptrace.cpp:30-33). The numeric evaluator
(export/onnx_eval.py) proves the MATH; a real ORT load additionally
enforces structural rules no numeric check exercises: ir_version range,
opset_import presence/consistency, complete input/output typing, SSA-form
value names, topological node order, initializer data sizes. This module
re-implements those load-time checks from the ONNX IR spec so a model that
would be rejected by `Ort::Session(...)` fails the tests without
onnxruntime installed.

Built on the independent wire-format reader of onnx_eval (shares nothing
with the writer, export/protobuf_min.py).

`lint_onnx(path) -> list[str]`: empty list = structurally sound.
"""

from __future__ import annotations

from typing import Dict, List

from .onnx_eval import _LEN, _VARINT, _fields, _ints

# onnx.proto3 field numbers used below
_M_IR_VERSION = 1
_M_OPSET_IMPORT = 8
_M_GRAPH = 7
_G_NODE = 1
_G_NAME = 2
_G_INITIALIZER = 5
_G_INPUT = 11
_G_OUTPUT = 12
_G_VALUE_INFO = 13

# TensorProto.DataType -> byte width (subset we can emit / ORT requires
# consistent raw_data sizes for; 2=uint8, 3=int8 for quantized weights)
_DTYPE_SIZE = {1: 4, 2: 1, 3: 1, 6: 4, 7: 8, 9: 1, 10: 2, 11: 8, 12: 4,
               13: 8, 16: 2}

# Supported ir_version range: ONNX IR v3 (opset era) .. v10 (current).
# ORT rejects models outside its known range with InvalidProtobuf.
_IR_MIN, _IR_MAX = 3, 10

# default-domain opset versions a current ORT build accepts
_OPSET_MIN, _OPSET_MAX = 1, 21

# op -> opset version that introduced it (default domain, subset the
# exporter and its consumers can produce). ORT refuses a node whose op is
# not registered for the declared opset.
_OP_SINCE = {
    "Gemm": 1, "MatMul": 1, "Relu": 1, "Softplus": 1, "Tanh": 1,
    "Mul": 1, "Div": 1, "Add": 1, "Sub": 1, "Concat": 1, "Identity": 1,
    # the exporter emits per-axis scales, an opset-13 extension (the op
    # itself exists since 10) — ORT validates this at session-create
    "DequantizeLinear": 13,
}
# ops whose required attributes ORT validates at session-create time
_REQUIRED_ATTRS = {"Concat": ("axis",)}


def _decode_str(entries, what: str, errors: List[str]) -> str:
    if not entries:
        return ""
    wt, raw = entries[0]
    if wt != _LEN:
        errors.append(f"{what}: expected length-delimited string")
        return ""
    return raw.decode("utf-8", "replace")


def _tensor_type_errors(type_buf: bytes, ctx: str, errors: List[str]) -> None:
    """ValueInfoProto.type must be a complete TypeProto.Tensor: elem_type
    set and every shape dim either dim_value > 0 or a named dim_param —
    ORT needs this to allocate and to bind dynamic axes."""
    t = _fields(type_buf)
    if 1 not in t:  # TypeProto.tensor_type
        errors.append(f"{ctx}: missing tensor_type")
        return
    tt = _fields(t[1][0][1])
    if 1 not in tt or not _ints(tt[1]):
        errors.append(f"{ctx}: tensor_type.elem_type unset")
    elif _ints(tt[1])[0] == 0:
        errors.append(f"{ctx}: tensor_type.elem_type is UNDEFINED (0)")
    if 2 not in tt:
        errors.append(f"{ctx}: tensor_type.shape unset")
        return
    shape = _fields(tt[2][0][1])
    for k, (_, dim_buf) in enumerate(shape.get(1, [])):
        d = _fields(dim_buf)
        has_value = 1 in d and _ints(d[1]) and _ints(d[1])[0] > 0
        has_param = 2 in d and len(d[2][0][1]) > 0  # dim_param (field 2)
        if not (has_value or has_param):
            errors.append(
                f"{ctx}: dim {k} has neither dim_value > 0 nor dim_param"
            )


def _value_info_name_type(buf: bytes, ctx: str, errors: List[str]):
    f = _fields(buf)
    name = _decode_str(f.get(1, []), f"{ctx}.name", errors)
    if not name:
        errors.append(f"{ctx}: empty name")
    if 2 not in f:
        errors.append(f"{ctx} {name!r}: missing type")
    else:
        _tensor_type_errors(f[2][0][1], f"{ctx} {name!r}", errors)
    return name


def lint_onnx(path: str) -> List[str]:
    """Return every structural violation a strict ORT-style load would
    reject (empty list = sound). Checks are ordered model -> graph ->
    values -> nodes."""
    errors: List[str] = []
    with open(path, "rb") as fh:
        try:
            model = _fields(fh.read())
        except Exception as exc:  # truncated / corrupt wire data
            return [f"unparseable ModelProto: {exc}"]

    # --- ModelProto level -------------------------------------------------
    if _M_IR_VERSION not in model:
        errors.append("ir_version missing")
        ir = None
    else:
        ir = _ints(model[_M_IR_VERSION])[0]
        if not (_IR_MIN <= ir <= _IR_MAX):
            errors.append(f"ir_version {ir} outside supported [{_IR_MIN}, {_IR_MAX}]")

    default_opset = None
    if _M_OPSET_IMPORT not in model:
        errors.append("opset_import missing (ORT: 'model does not have opset import')")
    else:
        seen_domains: Dict[str, int] = {}
        for _, raw in model[_M_OPSET_IMPORT]:
            op_f = _fields(raw)
            domain = _decode_str(op_f.get(1, []), "opset_import.domain", errors)
            if 2 not in op_f:
                errors.append(f"opset_import domain {domain!r}: version unset")
                continue
            version = _ints(op_f[2])[0]
            if domain in ("", "ai.onnx"):
                domain = ""
            if domain in seen_domains:
                errors.append(f"duplicate opset_import for domain {domain!r}")
            seen_domains[domain] = version
        if "" not in seen_domains:
            errors.append("no default-domain ('' / ai.onnx) opset_import")
        else:
            default_opset = seen_domains[""]
            if not (_OPSET_MIN <= default_opset <= _OPSET_MAX):
                errors.append(
                    f"default opset {default_opset} outside supported "
                    f"[{_OPSET_MIN}, {_OPSET_MAX}]"
                )

    if _M_GRAPH not in model:
        errors.append("graph missing")
        return errors
    graph = _fields(model[_M_GRAPH][0][1])
    if _G_NAME not in graph or not graph[_G_NAME][0][1]:
        errors.append("graph.name empty (required by the IR spec)")

    # --- initializers -----------------------------------------------------
    init_names: Dict[str, bool] = {}
    for _, raw in graph.get(_G_INITIALIZER, []):
        f = _fields(raw)
        name = _decode_str(f.get(8, []), "initializer.name", errors)
        if not name:
            errors.append("initializer with empty name")
            continue
        if name in init_names:
            errors.append(f"duplicate initializer {name!r}")
        init_names[name] = True
        dims = _ints(f.get(1, []))
        dtype = _ints(f[2])[0] if 2 in f else 1
        n_elem = 1
        for d in dims:
            n_elem *= d
        if 9 in f:  # raw_data: byte length must match dims * dtype width
            width = _DTYPE_SIZE.get(dtype)
            if width is None:
                errors.append(f"initializer {name!r}: unknown dtype {dtype}")
            elif len(f[9][0][1]) != n_elem * width:
                errors.append(
                    f"initializer {name!r}: raw_data {len(f[9][0][1])} bytes "
                    f"!= {n_elem} elems x {width}"
                )
        elif not (4 in f or 5 in f or 6 in f or 7 in f or 10 in f or 11 in f):
            errors.append(f"initializer {name!r}: no data field")

    # --- graph inputs / outputs / value_info ------------------------------
    input_names = []
    for _, raw in graph.get(_G_INPUT, []):
        input_names.append(_value_info_name_type(raw, "graph input", errors))
    output_names = []
    for _, raw in graph.get(_G_OUTPUT, []):
        output_names.append(_value_info_name_type(raw, "graph output", errors))
    if not output_names:
        errors.append("graph has no outputs")
    for _, raw in graph.get(_G_VALUE_INFO, []):
        _value_info_name_type(raw, "value_info", errors)
    if len(set(input_names)) != len(input_names):
        errors.append("duplicate graph input names")
    if len(set(output_names)) != len(output_names):
        errors.append("duplicate graph output names")
    # ir_version >= 4: initializers need not be re-listed as inputs, but a
    # model whose EVERY input is an initializer has no feedable surface
    feedable = [n for n in input_names if n not in init_names]
    if input_names and not feedable:
        errors.append("every graph input is shadowed by an initializer")

    # --- nodes: SSA, topological order, opset availability ----------------
    known = set(init_names) | set(input_names)
    produced = set()
    node_names = set()
    for idx, (_, raw) in enumerate(graph.get(_G_NODE, [])):
        nf = _fields(raw)
        op = _decode_str(nf.get(4, []), f"node[{idx}].op_type", errors)
        nname = _decode_str(nf.get(3, []), f"node[{idx}].name", errors)
        ctx = f"node[{idx}] {op}({nname!r})"
        if not op:
            errors.append(f"node[{idx}]: empty op_type")
        elif op not in _OP_SINCE:
            errors.append(f"{ctx}: op not registered in the default domain")
        elif default_opset is not None and default_opset < _OP_SINCE[op]:
            errors.append(
                f"{ctx}: requires opset >= {_OP_SINCE[op]}, model declares "
                f"{default_opset}"
            )
        if nname:
            if nname in node_names:
                errors.append(f"{ctx}: duplicate node name")
            node_names.add(nname)
        for v in (e[1].decode("utf-8", "replace") for e in nf.get(1, [])):
            # empty input name = optional-input placeholder (legal)
            if v and v not in known:
                errors.append(
                    f"{ctx}: input {v!r} is not a graph input, initializer, "
                    "or earlier node output (topological order violated or "
                    "value undefined)"
                )
        outs = [e[1].decode("utf-8", "replace") for e in nf.get(2, [])]
        if not outs:
            errors.append(f"{ctx}: no outputs")
        for v in outs:
            if v in produced or v in init_names or v in input_names:
                errors.append(f"{ctx}: output {v!r} violates SSA (reassigned)")
            produced.add(v)
            known.add(v)
        attrs = {}
        for _, araw in nf.get(5, []):
            af = _fields(araw)
            aname = _decode_str(af.get(1, []), f"{ctx} attr name", errors)
            attrs[aname] = True
        for req in _REQUIRED_ATTRS.get(op, ()):
            if req not in attrs:
                errors.append(f"{ctx}: required attribute {req!r} missing")

    for name in output_names:
        if name and name not in produced and name not in init_names:
            errors.append(f"graph output {name!r} is never produced")
    return errors
