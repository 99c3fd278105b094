"""TFRecord read/write (ref: tensorflow/core/lib/io/record_writer.cc,
record_reader.cc, python/lib/io/tf_record.py); the port's copy of
``simple_tensorflow_tpu/lib/io/tf_record.py``.

Format-identical to the reference: [len u64][masked crc32c(len) u32]
[data][masked crc32c(data) u32]; a record is byte-identical to the JAX
writer's for the same payload. The reader side is the JAX module's:
``tf_record_chunks`` (lists of records, one a batched native C++ call
when ``runtime/native.py`` is built, else the Python reader's), GZIP
containers and ``buffer_size``.
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


def _read_records_py(path, compression="",
                     buffer_size: Optional[int] = None) -> Iterator[bytes]:
    """The records of ``path``, checking both CRCs of each
    (``DataLossError`` on a truncated or corrupted record). A GZIP
    container is read as such whatever ``compression`` says (its magic
    is sniffed, as the native reader decompresses transparently)."""
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


def tf_record_chunks(path, compression: str = "",
                     buffer_size: Optional[int] = None,
                     chunk_records: int = 256) -> Iterator[list]:
    """Lists of records, one a batched native call (the pipeline's shard
    readers move whole chunks through their rings). The native reader
    serves both compression modes; without it, the Python reader's
    records are grouped alike. On a corruption mid-chunk the good prefix
    is yielded first, then the ``DataLossError`` raises."""
    from ...runtime import native

    # only the probe is guarded: once the native reader is chosen its
    # errors propagate (falling back mid-stream would re-deliver records)
    try:
        use_native = native.available()
    except Exception:
        use_native = False
    if use_native:
        yield from native.read_tfrecord_chunks(
            path, batch=chunk_records, buffer_size=buffer_size)
        return
    gen = _read_records_py(path, compression, buffer_size)
    while True:
        chunk: list = []
        err = None
        try:
            for rec in gen:
                chunk.append(rec)
                if len(chunk) >= chunk_records:
                    break
        except Exception as e:
            err = e
        if chunk:
            yield chunk
        if err is not None:
            raise err
        if len(chunk) < chunk_records:
            return


def tf_record_iterator(path, options: Optional[TFRecordOptions] = None,
                       buffer_size: Optional[int] = None
                       ) -> Iterator[bytes]:
    """(ref: python/lib/io/tf_record.py:43 ``tf_record_iterator``): the
    records of ``path`` through :func:`tf_record_chunks`."""
    comp = TFRecordOptions.get_compression_type_string(options)
    for chunk in tf_record_chunks(path, comp, buffer_size):
        yield from chunk
