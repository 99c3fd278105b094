"""Minimal protobuf wire-format codec; the port's copy of
``simple_tensorflow_tpu/lib/proto.py``.

The reference links full protobuf (tensorflow/core/protobuf/*.proto); here
events and summaries are encoded with a hand-rolled wire codec whose bytes
are protobuf-identical, so TensorBoard and TF tooling read them. Wire
types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple


def encode_varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _key(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


class Writer:
    def __init__(self):
        self._parts: List[bytes] = []

    def varint(self, field: int, value: int) -> "Writer":
        if value:
            self._parts.append(_key(field, 0))
            self._parts.append(encode_varint(int(value)))
        return self

    def varint_always(self, field: int, value: int) -> "Writer":
        self._parts.append(_key(field, 0))
        self._parts.append(encode_varint(int(value)))
        return self

    def double(self, field: int, value: float) -> "Writer":
        if value:
            self._parts.append(_key(field, 1))
            self._parts.append(struct.pack("<d", float(value)))
        return self

    def double_always(self, field: int, value: float) -> "Writer":
        self._parts.append(_key(field, 1))
        self._parts.append(struct.pack("<d", float(value)))
        return self

    def float32(self, field: int, value: float) -> "Writer":
        if value:
            self._parts.append(_key(field, 5))
            self._parts.append(struct.pack("<f", float(value)))
        return self

    def float32_always(self, field: int, value: float) -> "Writer":
        self._parts.append(_key(field, 5))
        self._parts.append(struct.pack("<f", float(value)))
        return self

    def bytes_(self, field: int, value) -> "Writer":
        if value:
            if isinstance(value, str):
                value = value.encode()
            self._parts.append(_key(field, 2))
            self._parts.append(encode_varint(len(value)))
            self._parts.append(value)
        return self

    def message(self, field: int, sub: "Writer") -> "Writer":
        data = sub.tobytes()
        self._parts.append(_key(field, 2))
        self._parts.append(encode_varint(len(data)))
        self._parts.append(data)
        return self

    def packed_doubles(self, field: int, values) -> "Writer":
        if len(values):
            data = b"".join(struct.pack("<d", float(v)) for v in values)
            self._parts.append(_key(field, 2))
            self._parts.append(encode_varint(len(data)))
            self._parts.append(data)
        return self

    def packed_floats(self, field: int, values) -> "Writer":
        if len(values):
            data = b"".join(struct.pack("<f", float(v)) for v in values)
            self._parts.append(_key(field, 2))
            self._parts.append(encode_varint(len(data)))
            self._parts.append(data)
        return self

    def packed_varints(self, field: int, values) -> "Writer":
        if len(values):
            data = b"".join(encode_varint(int(v)) for v in values)
            self._parts.append(_key(field, 2))
            self._parts.append(encode_varint(len(data)))
            self._parts.append(data)
        return self

    def tobytes(self) -> bytes:
        return b"".join(self._parts)


def parse(data: bytes) -> Dict[int, list]:
    """Decode one message into {field: [raw values]}; length-delimited
    values stay bytes (caller re-parses nested messages)."""
    out: Dict[int, list] = {}
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = decode_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = decode_varint(data, pos)
        elif wire == 1:
            val = struct.unpack("<d", data[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            ln, pos = decode_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack("<f", data[pos:pos + 4])[0]
            pos += 4
        else:
            raise ValueError(f"bad wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


def zigzag_encode(v: int) -> int:
    return (v << 1) ^ (v >> 63)
