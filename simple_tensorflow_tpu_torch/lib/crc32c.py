"""CRC32-C (Castagnoli) and the TFRecord mask (ref: tensorflow/core/lib/
hash/crc32c.h); the port's copy of ``simple_tensorflow_tpu/lib/
crc32c.py``: the table implementation, and for a record of 64 bytes or
more the native library's (``runtime/native.py``) when it is built."""

from __future__ import annotations

_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)

_MASK_DELTA = 0xA282EAD8


def _native_crc():
    try:
        from ..runtime import native

        if native.available():
            return native
    except Exception:
        pass
    return None


def crc32c(data: bytes, crc: int = 0) -> int:
    if crc == 0 and len(data) >= 64:
        native = _native_crc()
        if native is not None:
            return native.crc32c(bytes(data))
    crc = crc ^ 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """(ref: crc32c.h ``Mask``): rotate right 15 and add delta, so CRCs of
    CRC-bearing data don't collide."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF
