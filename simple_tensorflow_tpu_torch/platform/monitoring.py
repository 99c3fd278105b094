"""Process-global metrics and trace spans; the part of
``simple_tensorflow_tpu/platform/monitoring.py`` that the input pipeline,
the parse ops, the checkpoint plane and the numerics-health plane report
through: ``Counter`` (:310), ``IntGauge`` (:319), ``Sampler`` (:342) over
``ExponentialBuckets`` (:73), ``get_metric``, and the trace half
(``TraceBuffer`` :580, ``trace_collection`` :624, ``traceme`` :654,
``active_trace_buffers``).

Metric names are the JAX package's (``/stf/data/*``, ``/stf/checkpoint/*``,
``/stf/train/*``), so a counter reads the same in both packages. A metric
family owns labeled cells made on demand (``get_cell(*labels)``);
re-creating a family of the same name and shape returns the existing
cells. ``traceme(name, **meta)`` records a span into every trace buffer
active on the current thread and costs one thread-local read when there
is none. Left out: percentile samplers, string and bool gauges, the
exporters, ``record_span`` and the lock-witness metrics.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import sync as _sync

__all__ = ["Counter", "IntGauge", "Sampler", "Buckets",
           "ExponentialBuckets", "get_metric", "traceme",
           "trace_collection", "TraceBuffer", "active_trace_buffers"]

_registry_lock = _sync.Lock("monitoring/registry", rank=_sync.LEAF)
_registry: Dict[str, "Metric"] = {}


class Buckets:
    """Bucket boundaries of a :class:`Sampler`: ``boundaries[i]`` is the
    inclusive upper edge of bucket i; a last +inf bucket is implicit."""

    def __init__(self, boundaries: Sequence[float]):
        bs = [float(b) for b in boundaries]
        if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"bucket boundaries must increase: {bs}")
        self.boundaries: List[float] = bs


def ExponentialBuckets(scale: float, growth_factor: float,
                       bucket_count: int) -> Buckets:
    """(ref: monitoring/sampler.h ``Buckets::Exponential``): the edges
    ``scale * growth_factor ** i`` for i < ``bucket_count``."""
    if scale <= 0 or growth_factor <= 1 or bucket_count < 1:
        raise ValueError(
            f"ExponentialBuckets(scale={scale}, growth_factor="
            f"{growth_factor}, bucket_count={bucket_count}): need "
            "scale>0, growth_factor>1, bucket_count>=1")
    return Buckets([scale * growth_factor ** i for i in range(bucket_count)])


class CounterCell:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def increase_by(self, value: int = 1):
        if value < 0:
            raise ValueError(f"Counter can only increase (got {value})")
        with self._lock:
            self._value += int(value)

    def value(self) -> int:
        with self._lock:
            return self._value


class GaugeCell:
    __slots__ = ("_value", "_lock")

    def __init__(self, default):
        self._value = default
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    def value(self):
        with self._lock:
            return self._value


class SamplerCell:
    """Histogram cell: counts per bucket, sum, count, min and max."""

    __slots__ = ("_buckets", "_counts", "_sum", "_count", "_min", "_max",
                 "_lock")

    def __init__(self, buckets: Buckets):
        self._buckets = buckets
        self._counts = [0] * (len(buckets.boundaries) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = float("inf")
        self._max = float("-inf")
        self._lock = threading.Lock()

    def add(self, value: float):
        v = float(value)
        # a sample equal to an edge counts in the bucket it closes
        idx = bisect.bisect_left(self._buckets.boundaries, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def value(self) -> Dict[str, Any]:
        """``{count, sum, min, max, buckets}``; ``buckets`` pairs each
        upper edge (the last +inf) with its count."""
        with self._lock:
            edges = self._buckets.boundaries + [float("inf")]
            return {"count": self._count, "sum": self._sum,
                    "min": self._min if self._count else None,
                    "max": self._max if self._count else None,
                    "buckets": list(zip(edges, list(self._counts)))}


class Metric:
    """A named family of labeled cells (names are process-global)."""

    metric_type = "Metric"

    def __init__(self, name: str, description: str, *label_names: str):
        self.name = name
        self.description = description
        self.label_names = tuple(label_names)
        self._cells: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            existing = _registry.get(name)
            if existing is not None:
                if (type(existing) is not type(self)
                        or existing.label_names != self.label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.label_names}")
                self._cells = existing._cells
                self._lock = existing._lock
            _registry[name] = self

    def _new_cell(self):
        raise NotImplementedError

    def get_cell(self, *labels: str):
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes {len(self.label_names)} "
                f"label(s) {self.label_names}, got {labels!r}")
        key = tuple(str(v) for v in labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = self._new_cell()
            return cell

    def cells(self) -> Dict[Tuple, Any]:
        with self._lock:
            return dict(self._cells)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.metric_type, "description": self.description,
                "labels": list(self.label_names),
                "cells": {"|".join(k): c.value()
                          for k, c in self.cells().items()}}


class Counter(Metric):
    """(ref: monitoring/counter.h)."""

    metric_type = "Counter"

    def _new_cell(self):
        return CounterCell()


class IntGauge(Metric):
    """(ref: monitoring/gauge.h ``Gauge<int64>``)."""

    metric_type = "IntGauge"

    def _new_cell(self):
        return GaugeCell(0)


class Sampler(Metric):
    """(ref: monitoring/sampler.h): a histogram over fixed buckets."""

    metric_type = "Sampler"

    def __init__(self, name: str, buckets: Buckets, description: str,
                 *label_names: str):
        self.buckets = buckets
        super().__init__(name, description, *label_names)

    def _new_cell(self):
        return SamplerCell(self.buckets)


def get_metric(name: str) -> Optional[Metric]:
    with _registry_lock:
        return _registry.get(name)


class TraceBuffer:
    """Span sink: dicts ``{name, start_s (perf_counter), dur_s, tid,
    meta}``; appends are locked so a parent's worker threads can share
    it."""

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def append(self, span: Dict[str, Any]):
        with self._lock:
            self.spans.append(span)

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out, self.spans = self.spans, []
        return out


_trace_local = threading.local()


def _sinks() -> List[TraceBuffer]:
    sinks = getattr(_trace_local, "sinks", None)
    if sinks is None:
        sinks = _trace_local.sinks = []
    return sinks


def active_trace_buffers() -> List[TraceBuffer]:
    """The buffers installed on the current thread (a spawned thread
    starts with none: pipeline stages enter their parent's)."""
    return list(getattr(_trace_local, "sinks", None) or [])


class trace_collection:
    """Install ``buffer`` as a span sink of the current thread for the
    ``with`` block; nested collections stack."""

    def __init__(self, buffer: Optional[TraceBuffer] = None):
        self.buffer = buffer if buffer is not None else TraceBuffer()

    def __enter__(self) -> TraceBuffer:
        _sinks().append(self.buffer)
        return self.buffer

    def __exit__(self, *exc):
        sinks = _sinks()
        if self.buffer in sinks:
            sinks.remove(self.buffer)
        return False


class traceme:
    """Span context manager (ref: profiler TraceMe); free when no
    collection is active on this thread."""

    __slots__ = ("name", "meta", "_t0", "_sinks")

    def __init__(self, name: str, **meta):
        self.name = name
        self.meta = meta
        self._sinks = None

    def __enter__(self):
        sinks = getattr(_trace_local, "sinks", None)
        if sinks:
            self._sinks = list(sinks)
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sinks:
            dur = time.perf_counter() - self._t0
            span = {"name": self.name, "start_s": self._t0, "dur_s": dur,
                    "tid": threading.get_ident(), "meta": self.meta}
            for s in self._sinks:
                s.append(span)
        return False
