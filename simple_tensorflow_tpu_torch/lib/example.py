"""tf.train.Example / Features proto, wire-compatible
(ref: tensorflow/core/example/example.proto, feature.proto); the port's
copy of ``simple_tensorflow_tpu/lib/example.py``, on the port's
``lib/proto.py``: the same bytes for the same features.

Field numbers match the reference protos, so records written here parse
with real TF and vice versa:
  Example.features = 1
  Features.feature = 1   (map<string, Feature>: key=1, value=2)
  Feature.bytes_list = 1 / float_list = 2 / int64_list = 3
  *List.value = 1 (bytes repeated / float packed / int64 packed)
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np

from . import proto


class BytesList:
    def __init__(self, value=()):
        self.value: List[bytes] = [
            v.encode() if isinstance(v, str) else bytes(v) for v in value]


class FloatList:
    def __init__(self, value=()):
        self.value = [float(v) for v in value]


class Int64List:
    def __init__(self, value=()):
        self.value = [int(v) for v in value]


class Feature:
    def __init__(self, bytes_list=None, float_list=None, int64_list=None):
        self.bytes_list = bytes_list
        self.float_list = float_list
        self.int64_list = int64_list

    def _writer(self) -> proto.Writer:
        w = proto.Writer()
        if self.bytes_list is not None:
            sub = proto.Writer()
            for v in self.bytes_list.value:  # empty strings included
                sub._parts.append(proto._key(1, 2))
                sub._parts.append(proto.encode_varint(len(v)))
                sub._parts.append(v)
            w.message(1, sub)
        if self.float_list is not None:
            sub = proto.Writer()
            sub.packed_floats(1, self.float_list.value)
            w.message(2, sub)
        if self.int64_list is not None:
            sub = proto.Writer()
            sub.packed_varints(1, self.int64_list.value)
            w.message(3, sub)
        return w


class Features:
    def __init__(self, feature: Dict[str, Feature] = None):
        self.feature = dict(feature or {})


class Example:
    def __init__(self, features: Features = None):
        self.features = features or Features()

    def SerializeToString(self) -> bytes:
        feats = proto.Writer()
        for name in sorted(self.features.feature):
            entry = proto.Writer()
            entry.bytes_(1, name)
            entry.message(2, self.features.feature[name]._writer())
            feats.message(1, entry)
        w = proto.Writer()
        w.message(1, feats)
        return w.tobytes()

    @staticmethod
    def FromString(data: bytes) -> "Example":
        ex = Example()
        top = proto.parse(data)
        for feats_raw in top.get(1, []):
            feats = proto.parse(feats_raw)
            for entry_raw in feats.get(1, []):
                entry = proto.parse(entry_raw)
                name = entry[1][0].decode()
                ex.features.feature[name] = _parse_feature(entry[2][0])
        return ex


def _unpack_floats(chunks) -> List[float]:
    vals: List[float] = []
    for c in chunks:
        if isinstance(c, bytes):  # packed
            vals.extend(struct.unpack(f"<{len(c) // 4}f", c))
        else:  # unpacked fixed32 already decoded as float
            vals.append(float(c))
    return vals


def _unpack_varints(chunks) -> List[int]:
    vals: List[int] = []
    for c in chunks:
        if isinstance(c, bytes):  # packed
            pos = 0
            while pos < len(c):
                v, pos = proto.decode_varint(c, pos)
                if v >= 1 << 63:
                    v -= 1 << 64
                vals.append(v)
        else:
            v = int(c)
            if v >= 1 << 63:
                v -= 1 << 64
            vals.append(v)
    return vals


def _parse_feature(raw: bytes) -> Feature:
    f = proto.parse(raw)
    if 1 in f:
        bl = proto.parse(f[1][0])
        return Feature(bytes_list=BytesList(bl.get(1, [])))
    if 2 in f:
        fl = proto.parse(f[2][0])
        return Feature(float_list=FloatList(_unpack_floats(fl.get(1, []))))
    if 3 in f:
        il = proto.parse(f[3][0])
        return Feature(int64_list=Int64List(_unpack_varints(il.get(1, []))))
    return Feature()


# -- convenience constructors (tf.train.* API) ------------------------------

def bytes_feature(values) -> Feature:
    if isinstance(values, (bytes, str)):
        values = [values]
    return Feature(bytes_list=BytesList(values))


def float_feature(values) -> Feature:
    if isinstance(values, (int, float)):
        values = [values]
    return Feature(float_list=FloatList(np.ravel(values)))


def int64_feature(values) -> Feature:
    if isinstance(values, (int, np.integer)):
        values = [values]
    return Feature(int64_list=Int64List(np.ravel(values)))


def make_example(**feature_values) -> Example:
    """make_example(label=3, weights=[0.5, 0.5], name=b"x")."""
    feats = {}
    for k, v in feature_values.items():
        arr = v if isinstance(v, (list, tuple, np.ndarray)) else [v]
        first = arr[0] if len(arr) else 0
        if isinstance(first, (bytes, str)):
            feats[k] = bytes_feature(list(arr))
        elif isinstance(first, (float, np.floating)):
            feats[k] = float_feature(list(arr))
        else:
            feats[k] = int64_feature(list(arr))
    return Example(features=Features(feature=feats))
