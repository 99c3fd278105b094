"""Read event files back (ref: tensorflow/python/summary/
summary_iterator.py); the port of ``simple_tensorflow_tpu/summary/
summary_iterator.py``."""

from __future__ import annotations

import struct

from ..lib.io.tf_record import tf_record_iterator
from ..lib.proto import parse


class Event:
    """A decoded Event proto (fields of core/util/event.proto)."""

    def __init__(self, raw: bytes):
        f = parse(raw)
        self.wall_time = f.get(1, [0.0])[0]
        self.step = f.get(2, [0])[0]
        self.file_version = (f[3][0].decode() if 3 in f else None)
        self.graph_def = f.get(4, [None])[0]
        self.summary = SummaryProto(f[5][0]) if 5 in f else None


class SummaryProto:
    def __init__(self, raw: bytes):
        f = parse(raw)
        self.value = [SummaryValue(v) for v in f.get(1, [])]


class SummaryValue:
    def __init__(self, raw: bytes):
        f = parse(raw)
        self.tag = f[1][0].decode() if 1 in f else ""
        self.simple_value = f.get(2, [None])[0]
        self.histo = HistogramProto(f[5][0]) if 5 in f else None
        self.image = f.get(4, [None])[0]

    def HasField(self, name):
        return getattr(self, name, None) is not None


class HistogramProto:
    def __init__(self, raw: bytes):
        f = parse(raw)
        self.min = f.get(1, [0.0])[0]
        self.max = f.get(2, [0.0])[0]
        self.num = f.get(3, [0.0])[0]
        self.sum = f.get(4, [0.0])[0]
        self.sum_squares = f.get(5, [0.0])[0]

        def unpack(field):
            if field not in f:
                return []
            buf = f[field][0]
            if isinstance(buf, bytes):
                return list(struct.unpack(f"<{len(buf) // 8}d", buf))
            return f[field]

        self.bucket_limit = unpack(6)
        self.bucket = unpack(7)


def summary_iterator(path):
    """(ref: summary_iterator.py:27 ``summary_iterator``)."""
    for record in tf_record_iterator(path):
        yield Event(record)
