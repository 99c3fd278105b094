"""TFRecord read/write (ref: tensorflow/core/lib/io/record_writer.cc,
record_reader.cc, python/lib/io/tf_record.py); the port's copy of
``simple_tensorflow_tpu/lib/io/tf_record.py``.

Format-identical to the reference: [len u64][masked crc32c(len) u32]
[data][masked crc32c(data) u32]; a record is byte-identical to the JAX
writer's for the same payload. Left out: the native C++ reader and the
chunked reader of the data pipeline.
"""

from __future__ import annotations

import contextlib
import gzip
import struct
from typing import Iterator, Optional

from ...framework import errors
from ..crc32c import masked_crc32c


class TFRecordCompressionType:
    NONE = 0
    ZLIB = 1
    GZIP = 2


class TFRecordOptions:
    def __init__(self, compression_type=TFRecordCompressionType.NONE):
        self.compression_type = compression_type

    @classmethod
    def get_compression_type_string(cls, options):
        if options is None:
            return ""
        return {0: "", 1: "ZLIB", 2: "GZIP"}[options.compression_type]


def encode_record(data: bytes) -> bytes:
    """One framed record."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data +
            struct.pack("<I", masked_crc32c(data)))


class TFRecordWriter:
    """(ref: python/lib/io/tf_record.py:94 ``TFRecordWriter``)."""

    def __init__(self, path, options: Optional[TFRecordOptions] = None):
        self._path = path
        comp = TFRecordOptions.get_compression_type_string(options)
        if comp == "GZIP":
            self._f = gzip.open(path, "wb")
        elif comp == "ZLIB":
            raise NotImplementedError("ZLIB container: use GZIP")
        else:
            self._f = open(path, "wb")

    def write(self, record: bytes):
        if isinstance(record, str):
            record = record.encode()
        self._f.write(encode_record(record))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def tf_record_iterator(path, options: Optional[TFRecordOptions] = None,
                       buffer_size: Optional[int] = None
                       ) -> Iterator[bytes]:
    """(ref: python/lib/io/tf_record.py:43 ``tf_record_iterator``): the
    records of ``path``, checking both CRCs of each (``DataLossError``
    on a truncated or corrupted record). A GZIP container is read as
    such whatever ``options`` say (its magic is sniffed)."""
    compression = TFRecordOptions.get_compression_type_string(options)
    with open(path, "rb") as probe:
        magic = probe.read(2)
    with contextlib.ExitStack() as stack:
        raw = stack.enter_context(
            open(path, "rb", buffering=int(buffer_size or -1)))
        f = raw
        if compression == "GZIP" or magic == b"\x1f\x8b":
            f = stack.enter_context(gzip.GzipFile(fileobj=raw))
        while True:
            header = f.read(12)
            if len(header) == 0:
                return
            if len(header) < 12:
                raise errors.DataLossError(
                    None, None, f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if masked_crc32c(header[:8]) != len_crc:
                raise errors.DataLossError(
                    None, None, f"corrupted length crc in {path}")
            data = f.read(length)
            if len(data) < length:
                raise errors.DataLossError(
                    None, None, f"truncated record in {path}")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if masked_crc32c(data) != data_crc:
                raise errors.DataLossError(
                    None, None, f"corrupted data crc in {path}")
            yield data
