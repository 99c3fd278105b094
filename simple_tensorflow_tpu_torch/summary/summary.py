"""Summary ops (ref: tensorflow/python/summary/summary.py,
core/framework/summary.proto); the port of ``simple_tensorflow_tpu/
summary/summary.py``.

The summary ops are host sinks (``runs_on_host``, ``host_sink_pure``): the
device step computes the watched tensors, and the Session serializes them
into protobuf-wire ``Summary`` bytes on the host after the step
(``sess.run(merged)`` returns those bytes, TensorBoard-ready, as the
reference does). ``Session.run_steps`` under ``"last"`` defers them to
once a window, on the last step's values. ``histogram`` buckets its tensor
on the device first (``HistogramBucketCounts``, the reference's
value-independent exponential bucket grid), so the host reads
``_PACKED_WIDTH`` floats, not the tensor. ``tensor_summary`` writes the
tensor's values as a string ``TensorProto``, as the JAX function does
(through the ``TextSummary`` op).

Not ported: ``image``, ``audio`` and ``text`` raise
``NotImplementedError``; they need the PNG and WAV encoders
(``lib/png.py``, ``lib/wav.py``) and string tensors (ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from ..lib.proto import Writer, parse

GraphKeys = ops_mod.GraphKeys


def _summary_value(tag: str, **kw) -> bytes:
    v = Writer()
    v.bytes_(1, tag)
    if "simple_value" in kw:
        v.float32_always(2, kw["simple_value"])
    if "histo" in kw:
        v.message(5, kw["histo"])
    if "tensor_bytes" in kw:
        v.bytes_(8, kw["tensor_bytes"])
    return v.tobytes()


def _wrap_summary(values: list) -> bytes:
    w = Writer()
    for val in values:
        w.bytes_(1, val)
    return w.tobytes()


def _reference_edges():
    # reference-style exponential buckets (ref: core/lib/histogram/
    # histogram.cc InitDefaultBuckets): value-independent, so the device
    # buckets against a fixed grid and only the counts move
    limits = [-1e-12, 1e-12]
    v = 1e-12
    while v < 1e20:
        v *= 1.1
        limits.append(v)
    neg = [-lim for lim in limits if lim > 0]
    return sorted(set(neg + limits))


_EDGES = _reference_edges()
_N_BINS = len(_EDGES) + 1
# packed layout of a HistogramBucketCounts vector:
# [min, max, count, sum, sum_sq, bucket_counts...]
_PACKED_WIDTH = 5 + _N_BINS


def _emit_histo(w: Writer, mn, mx, num, sm, sm_sq, counts) -> Writer:
    w.double_always(1, float(mn))
    w.double_always(2, float(mx))
    w.double_always(3, float(num))
    w.double_always(4, float(sm))
    w.double_always(5, float(sm_sq))
    keep_limits, keep_counts = [], []
    bounds = _EDGES + [1e308]
    for i, c in enumerate(counts):
        if c > 0:
            keep_limits.append(bounds[min(i, len(bounds) - 1)])
            keep_counts.append(float(c))
    w.packed_doubles(6, keep_limits)
    w.packed_doubles(7, keep_counts)
    return w


def _histogram_proto_from_packed(vec: np.ndarray) -> Writer:
    """The Summary histogram from a device-computed HistogramBucketCounts
    vector."""
    vec = np.asarray(vec, dtype=np.float64).ravel()
    w = Writer()
    if vec.size < _PACKED_WIDTH or vec[2] == 0:
        return w
    return _emit_histo(w, vec[0], vec[1], vec[2], vec[3], vec[4],
                       vec[5:5 + _N_BINS])


def _lower_scalar_summary(ctx, op, inputs):
    val = float(np.asarray(inputs[0], np.float32).reshape(()))
    return [_wrap_summary([_summary_value(op.attrs["tag"],
                                          simple_value=val)])]


def _lower_histogram_summary(ctx, op, inputs):
    histo = _histogram_proto_from_packed(np.asarray(inputs[0]))
    return [_wrap_summary([_summary_value(op.attrs["tag"], histo=histo)])]


def _lower_tensor_summary(ctx, op, inputs):
    # a string TensorProto (field 8 string_val, dtype 1 = DT_STRING 7) of
    # the values' str(), with the text plugin's metadata, as the JAX
    # TextSummary lowering writes it
    tw = Writer()
    tw.varint_always(1, 7)
    for s in np.ravel(np.asarray(inputs[0])):
        tw.bytes_(8, s if isinstance(s, bytes) else str(s).encode())
    val = Writer()
    val.bytes_(1, op.attrs["tag"])
    val.message(8, tw)
    md, pd = Writer(), Writer()
    pd.bytes_(1, "text")
    md.message(1, pd)
    val.message(9, md)
    return [_wrap_summary([val.tobytes()])]


def _lower_merge_summary(ctx, op, inputs):
    parts = []
    for buf in inputs:
        if buf is not None:
            parts.extend(parse(bytes(buf)).get(1, []))
    return [_wrap_summary(parts)]


for _n, _fn in [("ScalarSummary", _lower_scalar_summary),
                ("HistogramSummary", _lower_histogram_summary),
                ("TextSummary", _lower_tensor_summary),
                ("MergeSummary", _lower_merge_summary)]:
    op_registry.register(_n, lower=_fn, is_stateful=True, runs_on_host=True,
                         host_sink_pure=True)


def histogram_bucket_counts(x: torch.Tensor) -> torch.Tensor:
    """``[min, max, count, sum, sum of squares, counts per bucket]`` of
    ``x`` in f32 on its device (the JAX ``HistogramBucketCounts``). The
    counts come from a sort and a search (no host sync, no atomics)."""
    xf = x.detach().reshape(-1).to(torch.float32)
    if xf.numel() == 0:
        return torch.zeros(_PACKED_WIDTH, dtype=torch.float32,
                           device=x.device)
    edges = torch.tensor(_EDGES, dtype=torch.float32, device=x.device)
    idx = torch.searchsorted(edges, xf, right=True)
    ends = torch.searchsorted(
        torch.sort(idx).values,
        torch.arange(_N_BINS + 1, device=x.device, dtype=idx.dtype))
    counts = (ends[1:] - ends[:-1]).to(torch.float32)
    head = torch.stack([xf.min(), xf.max(),
                        torch.full((), float(xf.numel()),
                                   dtype=torch.float32, device=x.device),
                        xf.sum(), (xf * xf).sum()])
    return torch.cat([head, counts])


op_registry.register(
    "HistogramBucketCounts",
    lower=lambda ctx, op, inputs: [histogram_bucket_counts(inputs[0])],
    infer_fn=lambda graph, attrs, inputs: [
        (shape_mod.TensorShape([_PACKED_WIDTH]), dtypes_mod.float32)])


def _summary_op(op_type, tag, tensor, collections, attrs=None, name=None):
    g = ops_mod.get_default_graph()
    t = ops_mod.convert_to_tensor(tensor)
    a = {"tag": str(tag)}
    a.update(attrs or {})
    node = g.create_op(op_type, [t], attrs=a, name=name or op_type,
                       output_specs=[(shape_mod.scalar(), dtypes_mod.string)])
    out = node.outputs[0]
    for c in (collections if collections is not None
              else [GraphKeys.SUMMARIES]):
        g.add_to_collection(c, out)
    return out


def scalar(name, tensor, collections=None, family=None):
    """(ref: summary.py:70 ``scalar``)."""
    tag = f"{family}/{name}" if family else name
    return _summary_op("ScalarSummary", tag, tensor, collections, name=name)


def histogram(name, values, collections=None, family=None):
    """(ref: summary.py ``histogram``): bucketed on the device."""
    tag = f"{family}/{name}" if family else name
    v = ops_mod.convert_to_tensor(values)
    if not (v.dtype.is_floating or v.dtype.is_integer):
        raise NotImplementedError(
            f"histogram of a {v.dtype.name} tensor is not ported")
    counts = ops_mod.get_default_graph().create_op(
        "HistogramBucketCounts", [v], attrs={},
        name=(name or "Histogram") + "_buckets",
        output_specs=[(shape_mod.TensorShape([_PACKED_WIDTH]),
                       dtypes_mod.float32)]).outputs[0]
    return _summary_op("HistogramSummary", tag, counts, collections,
                       attrs={"from_buckets": True}, name=name)


def _not_ported(what, needs):
    raise NotImplementedError(
        f"stf.summary.{what} is not ported: it needs {needs} (ROADMAP "
        "Queue 1 item 12, summary/ and lib/)")


def image(name, tensor, max_outputs=3, collections=None, family=None):
    _not_ported("image", "the PNG encoder lib/png.py")


def audio(name, tensor, sample_rate, max_outputs=3, collections=None,
          family=None):
    _not_ported("audio", "the WAV encoder lib/wav.py")


def text(name, tensor, collections=None):
    _not_ported("text", "string tensors on the host")


def tensor_summary(name, tensor, summary_description=None, collections=None):
    return _summary_op("TextSummary", name, tensor, collections, name=name)


def merge(inputs, collections=None, name=None):
    """(ref: summary.py:232 ``merge``)."""
    g = ops_mod.get_default_graph()
    node = g.create_op("MergeSummary", list(inputs), attrs={},
                       name=name or "MergeSummary",
                       output_specs=[(shape_mod.scalar(), dtypes_mod.string)])
    out = node.outputs[0]
    for c in collections or ():
        g.add_to_collection(c, out)
    return out


def merge_all(key=GraphKeys.SUMMARIES, scope=None):
    """(ref: summary.py:262 ``merge_all``)."""
    summaries = ops_mod.get_collection(key, scope)
    if not summaries:
        return None
    return merge(summaries)
