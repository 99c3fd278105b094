"""Example-proto parsing ops (ref: tensorflow/python/ops/parsing_ops.py,
core/kernels/example_parsing_ops.cc); the port's copy of
``simple_tensorflow_tpu/ops/parsing_ops.py``.

Parsing runs in the Session's host stage before the device step (strings
never become torch tensors: they stay numpy ``object`` arrays, as the
reference pins these kernels to the CPU); the parsed dense arrays enter
the step as feeds. Two parse paths, as in JAX, each counted by path on
``/stf/data/parse_example_{batches,records}``: the native batch parse
(``runtime/native.py``, one C call a batch for all-dense float32/int64
``FixedLenFeature`` specs and for ``RaggedFeature`` specs) and the Python
wire parse (``lib/example.py``) for every other spec or when the library
is absent.
"""

from __future__ import annotations

import numpy as np

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import sparse_tensor as sparse_mod
from ..framework import tensor_shape as shape_mod
from ..lib import example as example_mod
from ..platform import monitoring

# native = one C call per batch (example_parse.cc); python = per-record
# wire parsing — the classic input-pipeline bottleneck this counter
# makes visible (docs/DATA.md)
_parse_batches = monitoring.Counter(
    "/stf/data/parse_example_batches",
    "parse_example batch calls by parser path", "path")
_parse_records = monitoring.Counter(
    "/stf/data/parse_example_records",
    "Example protos parsed by parser path", "path")
_ragged_truncated = monitoring.Counter(
    "/stf/data/ragged_truncated_values",
    "Values dropped from RaggedFeature rows longer than max_len",
    "feature")


class FixedLenFeature:
    """(ref: parsing_ops.py ``FixedLenFeature``)."""

    def __init__(self, shape, dtype, default_value=None):
        self.shape = list(shape)
        self.dtype = dtypes_mod.as_dtype(dtype)
        self.default_value = default_value


class VarLenFeature:
    """(ref: parsing_ops.py ``VarLenFeature``). ``parse_example`` returns
    its COO triple (indices, values, dense_shape) from the host stage."""

    def __init__(self, dtype):
        self.dtype = dtypes_mod.as_dtype(dtype)


class RaggedFeature:
    """Varlen feature parsed to a PADDED dense [batch, max_len] tensor
    plus a ``<name>_lengths`` int64 [batch] vector (docs/DATA.md
    "ragged/varlen parsing contract"): static shapes, unlike
    VarLenFeature's dynamic COO triple. Rows longer than ``max_len`` are
    TRUNCATED (counted in /stf/data/ragged_truncated_values, never an
    error); absent features
    parse as length 0. Padding slots hold ``pad_value`` (-1 by
    convention for id features — embedding_bag masks them out).
    Batches of all-float32/int64 ragged specs parse in one C++ call
    (runtime_cc StfParseExamplesRagged)."""

    def __init__(self, dtype, max_len, pad_value=-1):
        self.dtype = dtypes_mod.as_dtype(dtype)
        if self.dtype not in (dtypes_mod.float32, dtypes_mod.int64):
            raise TypeError(
                f"RaggedFeature supports float32/int64, got {self.dtype}")
        self.max_len = int(max_len)
        if self.max_len <= 0:
            raise ValueError("RaggedFeature max_len must be positive")
        self.pad_value = pad_value


def _feature_values(feature, dtype):
    if dtype == dtypes_mod.string:
        return (np.asarray(feature.bytes_list.value, dtype=object)
                if feature.bytes_list else np.asarray([], dtype=object))
    if dtype.is_floating:
        return (np.asarray(feature.float_list.value, np.float32)
                if feature.float_list else np.zeros((0,), np.float32))
    return (np.asarray(feature.int64_list.value, np.int64)
            if feature.int64_list else np.zeros((0,), np.int64))


def _parse_examples_fast(serialized, features):
    """C++ batch fast path (ref core/util/example_proto_fast_parsing.cc):
    all-FixedLen float32/int64 specs parse in ONE native call into dense
    numpy buffers. Returns None when the spec mix doesn't qualify (string
    or VarLen features) or the native runtime isn't available."""
    from ..runtime import native

    specs = []
    for name in sorted(features):
        spec = features[name]
        if not isinstance(spec, FixedLenFeature):
            return None
        if spec.dtype == dtypes_mod.float32:
            kind = 0
        elif spec.dtype == dtypes_mod.int64:
            kind = 1
        else:
            return None
        specs.append((name, spec, kind,
                      int(np.prod(spec.shape)) if spec.shape else 1))
    # the native parser caps at 64 dense features per call
    if not specs or len(specs) > 64 or not native.available():
        return None
    serialized = [bytes(s) for s in serialized]
    try:
        arrays, missing = native.parse_examples_dense(
            serialized, [s[0] for s in specs], [s[2] for s in specs],
            [s[3] for s in specs])
    except RuntimeError:
        return None
    out = {}
    for f, (name, spec, _kind, size) in enumerate(specs):
        arr = arrays[f]
        miss = missing[:, f]
        if miss.any():
            if spec.default_value is None:
                bad = int(np.argmax(miss))
                raise ValueError(
                    f"feature {name!r} missing and no default "
                    f"(example {bad})")
            default = np.ravel(np.asarray(spec.default_value,
                                          arr.dtype))
            if default.shape[0] == 1 and size > 1:
                default = np.repeat(default, size)
            if default.shape[0] != size:
                raise ValueError(
                    f"feature {name!r}: default_value has "
                    f"{default.shape[0]} values, expected {size}")
            arr[miss] = default
        out[name] = arr.reshape([len(serialized)] + list(spec.shape or []))
    return out


def _finish_ragged(name, spec, arr, true_lens):
    """Clamp lengths to the cap, account truncations, and normalize the
    pad value (shared by the native and slow ragged paths)."""
    over = true_lens - spec.max_len
    n_trunc = int(over[over > 0].sum())
    if n_trunc:
        _ragged_truncated.get_cell(name).increase_by(n_trunc)
    lens = np.minimum(true_lens, spec.max_len).astype(np.int64)
    pad = spec.pad_value if spec.dtype == dtypes_mod.int64 else 0.0
    mask = np.arange(spec.max_len)[None, :] >= lens[:, None]
    arr[mask] = pad
    return arr, lens


def _parse_ragged(serialized, specs):
    """RaggedFeature batch parse -> ({name: padded, name_lengths: lens},
    path). One native C++ call when available, else the Python wire
    path."""
    from ..runtime import native

    names = sorted(specs)
    out = {}
    if len(names) <= 64 and native.ragged_parse_available():
        serialized = [bytes(s) for s in serialized]
        kinds = [0 if specs[n].dtype == dtypes_mod.float32 else 1
                 for n in names]
        caps = [specs[n].max_len for n in names]
        try:
            arrays, lengths = native.parse_examples_ragged(
                serialized, names, kinds, caps)
        except RuntimeError:
            arrays = None
        if arrays is not None:
            for f, n in enumerate(names):
                arr, lens = _finish_ragged(n, specs[n], arrays[f],
                                           lengths[:, f])
                out[n] = arr
                out[n + "_lengths"] = lens
            return out, "native"
    batch = [example_mod.Example.FromString(bytes(s)) for s in serialized]
    for n in names:
        spec = specs[n]
        pad = spec.pad_value if spec.dtype == dtypes_mod.int64 else 0.0
        arr = np.full((len(batch), spec.max_len), pad,
                      spec.dtype.as_numpy_dtype)
        true_lens = np.zeros((len(batch),), np.int64)
        for i, ex in enumerate(batch):
            f = ex.features.feature.get(n)
            vals = (_feature_values(f, spec.dtype) if f is not None
                    else np.zeros((0,), spec.dtype.as_numpy_dtype))
            true_lens[i] = len(vals)
            k = min(len(vals), spec.max_len)
            arr[i, :k] = vals[:k]
        arr, lens = _finish_ragged(n, spec, arr, true_lens)
        out[n] = arr
        out[n + "_lengths"] = lens
    return out, "python"


def parse_example_py(serialized, features):
    """Host parser: list[bytes] -> {name: ndarray or (indices,values,shape)}.

    FixedLenFeature -> dense [batch] + shape; VarLenFeature -> COO
    triple; RaggedFeature -> padded dense [batch, max_len] plus a
    ``<name>_lengths`` vector. All-dense float32/int64 FixedLen specs
    and all RaggedFeature specs take the native C++ batch fast paths
    (one C call each per batch); /stf/data/parse_example_* counters
    record which path served each batch.
    """
    with monitoring.traceme("parse_example_batch", n=len(serialized)):
        ragged = {k: v for k, v in features.items()
                  if isinstance(v, RaggedFeature)}
        rest = {k: v for k, v in features.items()
                if not isinstance(v, RaggedFeature)}
        out = {}
        path = None
        if ragged:
            rout, path = _parse_ragged(serialized, ragged)
            out.update(rout)
        if rest:
            fast = _parse_examples_fast(serialized, rest)
            path = "python" if fast is None else "native"
            out.update(fast if fast is not None
                       else _parse_example_slow(serialized, rest))
        if path is None:
            path = "python"
        _parse_batches.get_cell(path).increase_by(1)
        _parse_records.get_cell(path).increase_by(len(serialized))
        return out


def _parse_example_slow(serialized, features):
    batch = [example_mod.Example.FromString(bytes(s)) for s in serialized]
    out = {}
    for name, spec in features.items():
        if isinstance(spec, FixedLenFeature):
            n = int(np.prod(spec.shape)) if spec.shape else 1
            rows = []
            for ex in batch:
                f = ex.features.feature.get(name)
                vals = (_feature_values(f, spec.dtype) if f is not None
                        else np.zeros((0,),))
                if len(vals) == 0:
                    if spec.default_value is None:
                        raise ValueError(
                            f"feature {name!r} missing and no default")
                    vals = np.ravel(np.asarray(spec.default_value))
                    if vals.shape[0] == 1 and n > 1:
                        vals = np.repeat(vals, n)
                if len(vals) != n:
                    raise ValueError(
                        f"feature {name!r}: got {len(vals)} values, "
                        f"expected {n}")
                rows.append(np.reshape(vals, spec.shape))
            arr = np.stack(rows) if rows else np.zeros([0] + spec.shape)
            if spec.dtype != dtypes_mod.string:
                arr = arr.astype(spec.dtype.as_numpy_dtype)
            out[name] = arr
        elif isinstance(spec, VarLenFeature):
            indices, values = [], []
            max_len = 0
            for i, ex in enumerate(batch):
                f = ex.features.feature.get(name)
                vals = (_feature_values(f, spec.dtype) if f is not None
                        else np.zeros((0,)))
                max_len = max(max_len, len(vals))
                for j, v in enumerate(vals):
                    indices.append((i, j))
                    values.append(v)
            idx = (np.asarray(indices, np.int64) if indices
                   else np.zeros((0, 2), np.int64))
            if spec.dtype == dtypes_mod.string:
                val = np.asarray(values, dtype=object)
            else:
                val = np.asarray(values,
                                 dtype=spec.dtype.as_numpy_dtype)
            out[name] = (idx, val,
                         np.asarray([len(batch), max_len], np.int64))
        else:
            raise TypeError(f"unsupported feature spec {type(spec)}")
    return out


# -- graph ops (host stage) -------------------------------------------------

def _register_parse_op():
    def lower(ctx, op, inputs):
        (serialized,) = inputs
        feats = op.attrs["_features"]
        single = op.attrs.get("_single", False)
        parsed = parse_example_py(np.ravel(np.asarray(serialized, object)),
                                  feats)
        flat = []
        for name in sorted(feats):
            v = parsed[name]
            if isinstance(v, tuple):
                flat.extend(v)
            elif single:  # strip the synthetic batch dim on host
                flat.append(v[0])
            else:
                flat.append(v)
            if isinstance(feats[name], RaggedFeature):
                lens = parsed[name + "_lengths"]
                flat.append(lens[0] if single else lens)
        return flat

    op_registry.register("ParseExample", lower=lower, is_stateful=True,
                         runs_on_host=True)


_register_parse_op()


def _parse_example_graph(serialized, features, name, single):
    serialized = ops_mod.convert_to_tensor(serialized)
    g = ops_mod.get_default_graph()
    batch = serialized.shape[0] if serialized.shape.rank else None
    specs = []
    names = sorted(features)
    for n in names:
        spec = features[n]
        if isinstance(spec, FixedLenFeature):
            lead = [] if single else [batch]
            specs.append((shape_mod.TensorShape(lead + spec.shape),
                          spec.dtype))
        elif isinstance(spec, RaggedFeature):
            lead = [] if single else [batch]
            specs.append((shape_mod.TensorShape(lead + [spec.max_len]),
                          spec.dtype))
            specs.append((shape_mod.TensorShape(lead), dtypes_mod.int64))
        else:  # VarLen -> indices, values, dense_shape
            specs.append((shape_mod.TensorShape([None, 2]), dtypes_mod.int64))
            specs.append((shape_mod.TensorShape([None]), spec.dtype))
            specs.append((shape_mod.TensorShape([2]), dtypes_mod.int64))
    op = g.create_op("ParseExample", [serialized],
                     attrs={"_features": features, "_single": single},
                     name=name or "ParseExample", output_specs=specs)
    out = {}
    i = 0
    for n in names:
        spec = features[n]
        if isinstance(spec, FixedLenFeature):
            out[n] = op.outputs[i]
            i += 1
        elif isinstance(spec, RaggedFeature):
            out[n] = op.outputs[i]
            out[n + "_lengths"] = op.outputs[i + 1]
            i += 2
        else:
            out[n] = sparse_mod.SparseTensor(op.outputs[i], op.outputs[i + 1],
                                             op.outputs[i + 2])
            i += 3
    return out


def parse_example(serialized, features, name=None, example_names=None):
    """(ref: parsing_ops.py:358 ``parse_example``). serialized: 1-D string
    tensor. Returns {name: Tensor} for FixedLen and {name: SparseTensor}
    for VarLen features."""
    return _parse_example_graph(serialized, features, name, single=False)


def parse_single_example(serialized, features, name=None):
    """(ref: parsing_ops.py ``parse_single_example``): scalar serialized.
    The batch-dim handling happens inside the host parse op (np.ravel makes
    the scalar a batch of one)."""
    serialized = ops_mod.convert_to_tensor(serialized)
    return _parse_example_graph(serialized, features, name, single=True)


def decode_raw(bytes_tensor, out_type, little_endian=True, name=None):
    """(ref: parsing_ops.py ``decode_raw``): bytes -> numeric vector."""
    out_type = dtypes_mod.as_dtype(out_type)

    def host_fn(vals, _dtype=out_type):
        flat = np.ravel(np.asarray(vals, dtype=object))
        rows = [np.frombuffer(
            v if isinstance(v, bytes) else str(v).encode(),
            dtype=_dtype.as_numpy_dtype) for v in flat]
        n = {len(r) for r in rows}
        if len(n) > 1:
            raise ValueError("decode_raw: records have unequal lengths")
        arr = (np.stack(rows) if rows
               else np.zeros((0, 0), _dtype.as_numpy_dtype))
        return arr.reshape(np.asarray(vals, dtype=object).shape + (-1,))

    op_type = f"DecodeRaw_{out_type.name}_{little_endian}"
    if not op_registry.exists(op_type):
        def lower(ctx, op, inputs, fn=host_fn):
            return [fn(inputs[0])]

        op_registry.register(op_type, lower=lower, is_stateful=True,
                             runs_on_host=True)
    bytes_tensor = ops_mod.convert_to_tensor(bytes_tensor)
    g = ops_mod.get_default_graph()
    in_shape = (bytes_tensor.shape.as_list()
                if bytes_tensor.shape.rank is not None else None)
    out_shape = shape_mod.TensorShape(
        (in_shape + [None]) if in_shape is not None else None)
    op = g.create_op(op_type, [bytes_tensor], name=name or "DecodeRaw",
                     output_specs=[(out_shape, out_type)])
    return op.outputs[0]


# -- round-4 parity fills ----------------------------------------------------

class FixedLenSequenceFeature:
    """(ref: parsing_ops.py ``FixedLenSequenceFeature``): a variable
    number of fixed-shape rows; parse pads to the batch max."""

    def __init__(self, shape, dtype, allow_missing=False,
                 default_value=None):
        self.shape = list(shape)
        self.dtype = dtypes_mod.as_dtype(dtype)
        self.allow_missing = allow_missing
        self.default_value = default_value


class SparseFeature:
    """(ref: parsing_ops.py ``SparseFeature``): (index_key, value_key)
    feature pair parsed into one SparseTensor triple."""

    def __init__(self, index_key, value_key, dtype, size,
                 already_sorted=False):
        self.index_key = index_key
        self.value_key = value_key
        self.dtype = dtypes_mod.as_dtype(dtype)
        self.size = int(size)
        self.already_sorted = already_sorted


def decode_csv(records, record_defaults, field_delim=",", name=None):
    """(ref: parsing_ops.py ``decode_csv``, core/kernels/decode_csv_op.cc).
    Host stage (strings). Returns one tensor per column."""
    recs = ops_mod.convert_to_tensor(records, dtype=dtypes_mod.string)
    col_dtypes = []
    defaults = []
    for d in record_defaults:
        arr = np.asarray(d).ravel()
        if arr.dtype == object or arr.dtype.kind in "US":
            col_dtypes.append(dtypes_mod.string)
        else:
            col_dtypes.append(dtypes_mod.as_dtype(arr.dtype))
        defaults.append(arr[0] if arr.size else None)
    g = ops_mod.get_default_graph()
    op = g.create_op(
        "DecodeCSV", [recs],
        attrs={"_defaults": tuple(defaults),
               "_dtypes": tuple(d.name for d in col_dtypes),
               "field_delim": field_delim},
        name=name or "DecodeCSV",
        output_specs=[(recs.shape, dt) for dt in col_dtypes])
    return list(op.outputs)


def _lower_decode_csv(ctx, op, inputs):
    import csv as _csv
    import io as _io

    recs = np.ravel(np.asarray(inputs[0], dtype=object))
    defaults = op.attrs["_defaults"]
    dtype_names = op.attrs["_dtypes"]
    builtins_len = len(dtype_names)
    cols = [[] for _ in dtype_names]
    for r in recs:
        s = r.decode() if isinstance(r, bytes) else str(r)
        rows = list(_csv.reader(_io.StringIO(s),
                                delimiter=op.attrs["field_delim"]))
        # empty record = all fields empty -> defaults (ref kernel behavior)
        row = rows[0] if rows else [""] * builtins_len

        if len(row) != len(cols):
            raise ValueError(
                f"decode_csv: record has {len(row)} fields, expected "
                f"{len(cols)}: {s!r}")
        for i, field in enumerate(row):
            if field == "":
                if defaults[i] is None:
                    raise ValueError(
                        f"decode_csv: field {i} empty and no default")
                cols[i].append(defaults[i])
            else:
                cols[i].append(field)
    out = []
    for vals, dt_name in zip(cols, dtype_names):
        dt = dtypes_mod.as_dtype(dt_name)
        if dt == dtypes_mod.string:
            out.append(np.asarray(vals, dtype=object))
        elif dt.is_integer:
            out.append(np.asarray([int(v) for v in vals], dt.np_dtype))
        else:
            out.append(np.asarray([float(v) for v in vals], dt.np_dtype))
    shape = np.asarray(inputs[0], dtype=object).shape
    return [o.reshape(shape) for o in out]


op_registry.register("DecodeCSV", lower=_lower_decode_csv,
                     is_stateful=True, runs_on_host=True)


def parse_tensor(serialized, out_type, name=None):
    """(ref: parsing_ops.py ``parse_tensor``): TensorProto wire decode.
    The JAX package's GraphDef serializes tensors as npy bytes, so this
    accepts that representation."""
    x = ops_mod.convert_to_tensor(serialized, dtype=dtypes_mod.string)
    dt = dtypes_mod.as_dtype(out_type)
    g = ops_mod.get_default_graph()
    op = g.create_op("ParseTensor", [x], attrs={"out_type": dt.name},
                     name=name or "ParseTensor",
                     output_specs=[(shape_mod.TensorShape(None), dt)])
    return op.outputs[0]


def _lower_parse_tensor(ctx, op, inputs):
    import io as _io

    raw = inputs[0]
    v = raw.item() if hasattr(raw, "item") and getattr(
        raw, "ndim", 1) == 0 else raw
    if isinstance(v, str):
        v = v.encode("latin1")
    arr = np.load(_io.BytesIO(v), allow_pickle=False)
    want = dtypes_mod.as_dtype(op.attrs["out_type"])
    if arr.dtype != want.np_dtype:
        raise ValueError(
            f"parse_tensor: serialized dtype {arr.dtype} != requested "
            f"{want.name}")
    return [arr]


op_registry.register("ParseTensor", lower=_lower_parse_tensor,
                     is_stateful=True, runs_on_host=True)


def serialize_tensor(tensor, name=None):
    """Inverse of parse_tensor (npy wire)."""
    x = ops_mod.convert_to_tensor(tensor)
    g = ops_mod.get_default_graph()
    op = g.create_op("SerializeTensor", [x], attrs={},
                     name=name or "SerializeTensor",
                     output_specs=[(shape_mod.scalar(),
                                    dtypes_mod.string)])
    return op.outputs[0]


def _lower_serialize_tensor(ctx, op, inputs):
    import io as _io

    buf = _io.BytesIO()
    np.save(buf, np.asarray(inputs[0]), allow_pickle=False)
    return [np.asarray(buf.getvalue(), dtype=object)]


op_registry.register("SerializeTensor", lower=_lower_serialize_tensor,
                     is_stateful=True, runs_on_host=True)


def decode_json_example(json_examples, name=None):
    """(ref: parsing_ops.py ``decode_json_example``): JSON-mapped Example
    protos re-encoded to binary Example wire (host stage)."""
    x = ops_mod.convert_to_tensor(json_examples, dtype=dtypes_mod.string)
    g = ops_mod.get_default_graph()
    op = g.create_op("DecodeJSONExample", [x], attrs={},
                     name=name or "DecodeJSONExample",
                     output_specs=[(x.shape, dtypes_mod.string)])
    return op.outputs[0]


def _lower_decode_json_example(ctx, op, inputs):
    import json as _json

    from ..lib.example import make_example

    def one(s):
        if isinstance(s, bytes):
            s = s.decode()
        d = _json.loads(s)
        feats = {}
        for name, feat in d.get("features", {}).get("feature",
                                                    {}).items():
            if "floatList" in feat:
                feats[name] = [float(v)
                               for v in feat["floatList"]["value"]]
            elif "int64List" in feat:
                feats[name] = [int(v) for v in feat["int64List"]["value"]]
            elif "bytesList" in feat:
                import base64 as _b64

                feats[name] = [_b64.b64decode(v)
                               for v in feat["bytesList"]["value"]]
        return make_example(**feats).SerializeToString()

    arr = np.asarray(inputs[0], dtype=object)
    out = np.vectorize(one, otypes=[object])(arr) if arr.shape else \
        np.asarray(one(arr.item()), dtype=object)
    return [out]


op_registry.register("DecodeJSONExample", lower=_lower_decode_json_example,
                     is_stateful=True, runs_on_host=True)
