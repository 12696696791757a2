"""Minimal protobuf wire-format encoder/decoder (no protobuf dependency) —
a copy of sdf_representation_tpu/export/protobuf_min.py.

Only what ONNX serialisation needs: varints, length-delimited submessages,
packed repeated scalars. Field numbers are supplied by the caller.
Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""

from __future__ import annotations

import struct


def varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's complement, 10 bytes
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return tag(field, 0) + varint(value)


def f_bytes(field: int, value: bytes) -> bytes:
    return tag(field, 2) + varint(len(value)) + value


def f_string(field: int, value: str) -> bytes:
    return f_bytes(field, value.encode("utf-8"))


def f_float(field: int, value: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", value)


def f_packed_floats(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<f", float(v)) for v in values)
    return f_bytes(field, payload)


def f_packed_varints(field: int, values) -> bytes:
    payload = b"".join(varint(int(v)) for v in values)
    return f_bytes(field, payload)


def f_message(field: int, payload: bytes) -> bytes:
    return f_bytes(field, payload)


# ---------------------------------------------------------------------------
# decoder (structure validation in tests)
# ---------------------------------------------------------------------------

def decode(buf: bytes) -> List[Tuple[int, int, object]]:
    """Decode one message level into [(field, wire, value)]. Length-delimited
    values are returned as raw bytes (decode recursively as needed)."""
    out = []
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 5:
            val = struct.unpack("<f", buf[i : i + 4])[0]
            i += 4
        elif wire == 1:
            val = struct.unpack("<d", buf[i : i + 8])[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        out.append((field, wire, val))
    return out


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def fields(decoded, field) -> list:
    return [v for f, _, v in decoded if f == field]
