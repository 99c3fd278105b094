"""Host-side Dataset pipeline with device prefetch; the port's copy of
``simple_tensorflow_tpu/data/dataset.py``.

(ref: python/training/input.py, core/kernels/fifo_queue.cc.) Each
transformation both keeps a sequential generator composition (the
semantic ground truth) and records a stage ``Node``; iteration compiles
the chain through ``data/pipeline.py`` into a parallel stage pipeline
whenever any stage asks for parallelism (``num_parallel_reads``,
``map(num_parallel_calls=...)``, ``interleave``, ``prefetch``), else runs
the zero-thread sequential composition. Ordered parallel stages emit the
element stream of the sequential chain, byte for byte, and ``shuffle``
draws from the JAX package's ``np.random.RandomState`` chain, so both
packages yield the same streams (docs/DATA.md determinism contract).

``prefetch_to_device`` assembles batches in pinned host slots and copies
them to the card on a side stream from a pipeline thread
(``data/staging.py``), so a step reads batches already on the card.
Graph integration: ``iterator.get_next()`` returns ``IteratorGetNext``
outputs, a host op the Session runs before the device step and feeds
into it; ``Iterator.save_state``/``restore_state`` are the positions
``train.Saver`` checkpoints.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from ..framework import dtypes as dtypes_mod
from ..framework import errors
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from . import pipeline as pipeline_mod
from . import staging
from .pipeline import AUTOTUNE, Node

__all__ = ["Dataset", "TFRecordDataset", "Iterator", "AUTOTUNE",
           "make_one_shot_iterator"]


def _check_parallel_arg(n, what):
    if n is None:
        return None
    n = int(n)
    if n == AUTOTUNE:
        return AUTOTUNE
    if n < 1:
        raise ValueError(
            f"{what} must be a positive int or stf.data.AUTOTUNE, got {n}")
    return n


class Dataset:
    """Composable host pipeline. Each instance carries a re-iterable
    sequential generator factory plus a stage-graph node; parallel
    stages execute through the stf.data.pipeline engine."""

    def __init__(self, gen_factory: Callable[[], Iterable],
                 element_spec=None, node: Optional[Node] = None):
        self._factory = gen_factory
        self._node = node if node is not None else Node(
            "source", None, (gen_factory,))
        self.element_spec = element_spec
        # the host dataset whose elements have this one's shapes and
        # dtypes (prefetch_to_device's input): get_next's spec probe
        # runs it, with no stream, pinned pool or device copy
        self._spec_source: Optional["Dataset"] = None

    def _derive(self, node: Node) -> "Dataset":
        """New Dataset one stage downstream; the sequential factory is
        the forced-sequential compile of the same node chain."""
        return Dataset(
            lambda: pipeline_mod.build_iterator(node, sequential=True),
            node=node)

    # -- sources -------------------------------------------------------------
    @staticmethod
    def from_tensor_slices(tensors):
        if isinstance(tensors, dict):
            if not tensors:
                raise ValueError("from_tensor_slices: empty dict")
            arrays = {k: np.asarray(v) for k, v in tensors.items()}
            lengths = {k: a.shape[0] if a.ndim else None
                       for k, a in arrays.items()}
            if None in lengths.values() or len(set(lengths.values())) > 1:
                raise ValueError(
                    f"from_tensor_slices: incompatible leading dimensions "
                    f"{lengths}")
            n = next(iter(lengths.values()))

            def gen_dict():
                for i in range(n):
                    yield {k: a[i] for k, a in arrays.items()}

            return Dataset(gen_dict)
        if isinstance(tensors, (list, tuple)):
            arrays = tuple(np.asarray(t) for t in tensors)

            def gen():
                for i in range(arrays[0].shape[0]):
                    yield tuple(a[i] for a in arrays)

            return Dataset(gen)
        arr = np.asarray(tensors)

        def gen_single():
            for i in range(arr.shape[0]):
                yield arr[i]

        return Dataset(gen_single)

    @staticmethod
    def from_tensors(tensors):
        def gen():
            yield tensors

        return Dataset(gen)

    @staticmethod
    def from_generator(generator, output_types=None, output_shapes=None):
        return Dataset(lambda: generator())

    @staticmethod
    def range(*args):
        def gen():
            yield from (np.int64(i) for i in range(*args))

        return Dataset(gen)

    @staticmethod
    def zip(datasets):
        node = Node("zip", None, (tuple(datasets),))
        return Dataset(
            lambda: pipeline_mod.build_iterator(node, sequential=True),
            node=node)

    # -- transforms ----------------------------------------------------------
    def _seq(self, apply_fn: Callable) -> "Dataset":
        """Chain a sequential stage: ``apply_fn(upstream_iter)`` yields
        the transformed stream (fused inline by the pipeline engine)."""
        return self._derive(Node("seq", self._node, (apply_fn,)))

    def map(self, map_func, num_parallel_calls=None, deterministic=None):
        """Element-wise transform. ``num_parallel_calls`` > 1 (or
        AUTOTUNE) runs ``map_func`` on the shared stf.data worker pool;
        ``deterministic`` (default True) preserves the sequential
        element order exactly — ``deterministic=False`` emits results in
        completion order for extra throughput when order is irrelevant."""
        num_parallel_calls = _check_parallel_arg(
            num_parallel_calls, "map: num_parallel_calls")
        if deterministic is None:
            deterministic = True
        if num_parallel_calls is not None and num_parallel_calls != 1:
            return self._derive(Node(
                "pmap", self._node,
                (map_func, num_parallel_calls, bool(deterministic))))

        def apply(it):
            for x in it:
                yield map_func(x)

        return self._seq(apply)

    def interleave(self, map_func, cycle_length=2, block_length=1,
                   num_parallel_calls=None):
        """(ref: the reference's ParallelInterleaveDataset.) Maps each
        input element to a dataset and interleaves their elements:
        round-robin over ``cycle_length`` open inner datasets, taking
        ``block_length`` elements per visit; an exhausted inner dataset
        is removed and the next input element's dataset joins at the end
        of the cycle. ``num_parallel_calls`` prefetches that many inner
        datasets on worker threads WITHOUT changing the emitted order
        (the determinism contract in docs/DATA.md)."""
        cycle_length = int(cycle_length)
        block_length = int(block_length)
        if cycle_length < 1 or block_length < 1:
            raise ValueError(
                f"interleave: cycle_length/block_length must be >= 1, got "
                f"{cycle_length}/{block_length}")
        num_parallel_calls = _check_parallel_arg(
            num_parallel_calls, "interleave: num_parallel_calls")
        return self._derive(Node(
            "interleave", self._node,
            (map_func, cycle_length, block_length, num_parallel_calls)))

    def filter(self, predicate):
        def apply(it):
            for x in it:
                if predicate(x):
                    yield x

        return self._seq(apply)

    def batch(self, batch_size, drop_remainder=True):
        """drop_remainder defaults True: a captured step has static feed
        shapes."""
        return self._derive(Node(
            "batch", self._node,
            (int(batch_size), drop_remainder, _stack_batch)))

    def padded_batch(self, batch_size, padded_shapes=None,
                     padding_values=None, drop_remainder=True):
        """Batch variable-length elements, padding each component to a
        common shape (ref: the ``dynamic_pad=True`` mode of
        ``python/training/input.py batch`` — same contract, pipeline
        form).

        ``padded_shapes`` mirrors the element structure; dims that are
        None/-1 pad to the longest element IN THAT BATCH. Prefer fully
        static ``padded_shapes``: every distinct batch shape is another
        captured step. ``padding_values`` defaults to 0 (b"" for string
        components).
        """
        def stack(rows, alloc):
            return _pad_batch(rows, padded_shapes, padding_values)

        return self._derive(Node(
            "batch", self._node, (int(batch_size), drop_remainder, stack)))

    def parse_example(self, features, num_parallel_calls=None):
        """Parse serialized tf.Example elements into feature dicts
        (ref: the `parse_example` stage of the reference input pipeline,
        core/util/example_proto_fast_parsing.cc).

        Batch-aware: applied AFTER ``.batch(n)`` it parses the whole
        batch in one native call (all-dense float32/int64 FixedLen
        specs, and all RaggedFeature specs — padded values plus a
        ``<name>_lengths`` vector, ~10x the per-record Python path);
        applied before batching it parses records one at a time. Prefer
        ``TFRecordDataset(...).batch(n).parse_example(spec)``.

        ``num_parallel_calls`` > 1 (or AUTOTUNE) runs the parse on the
        shared stf.data worker pool as a threaded pipeline stage
        (order-preserving, same contract as ``map``).
        """
        from ..ops import parsing_ops

        num_parallel_calls = _check_parallel_arg(
            num_parallel_calls, "parse_example: num_parallel_calls")

        def as_proto_bytes(s):
            # latin-1 is byte-preserving, so a str that carries proto
            # bytes round-trips; real pipelines carry bytes already
            return s.encode("latin1") if isinstance(s, str) else bytes(s)

        # RaggedFeature parses to static padded arrays, so it stacks
        # fine either side of .batch(); only the COO VarLen triple
        # needs batch-level parsing
        has_varlen = any(isinstance(s, parsing_ops.VarLenFeature)
                         for s in features.values())

        def parse_one(x):
            if isinstance(x, (bytes, np.bytes_, str, np.str_)):
                if has_varlen:
                    raise ValueError(
                        "Dataset.parse_example with VarLenFeature "
                        "needs batched elements (its output is a "
                        "batch-level COO triple): call "
                        ".batch(n).parse_example(spec), and do not "
                        "re-batch the parsed sparse values.")
                parsed = parsing_ops.parse_example_py(
                    [as_proto_bytes(x)], features)
                return {k: v[0] if not isinstance(v, tuple) else v
                        for k, v in parsed.items()}
            return parsing_ops.parse_example_py(
                [as_proto_bytes(s) for s in
                 np.ravel(np.asarray(x, dtype=object))],
                features)

        if num_parallel_calls is not None and num_parallel_calls != 1:
            return self._derive(Node(
                "pmap", self._node, (parse_one, num_parallel_calls, True)))

        def apply(it):
            for x in it:
                yield parse_one(x)

        return self._seq(apply)

    def unbatch(self):
        def apply(it):
            for x in it:
                if isinstance(x, dict):
                    arrays = {k: np.asarray(v) for k, v in x.items()}
                    n = next(iter(arrays.values())).shape[0]
                    for i in range(n):
                        yield {k: a[i] for k, a in arrays.items()}
                    continue
                arrs = x if isinstance(x, tuple) else (x,)
                for i in range(np.asarray(arrs[0]).shape[0]):
                    row = tuple(np.asarray(a)[i] for a in arrs)
                    yield row if isinstance(x, tuple) else row[0]

        return self._seq(apply)

    def shuffle(self, buffer_size, seed=None, reshuffle_each_iteration=True):
        rng_box = [np.random.RandomState(seed)]

        def apply(it):
            rng = rng_box[0] if not reshuffle_each_iteration else \
                np.random.RandomState(rng_box[0].randint(1 << 31))
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) >= buffer_size:
                    i = rng.randint(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return self._seq(apply)

    def repeat(self, count=None):
        return self._derive(Node("repeat", self._node, (count,)))

    def take(self, count):
        def apply(it):
            for i, x in enumerate(it):
                if i >= count:
                    return
                yield x

        return self._seq(apply)

    def skip(self, count):
        def apply(it):
            for i, x in enumerate(it):
                if i >= count:
                    yield x

        return self._seq(apply)

    def prefetch(self, buffer_size=2):
        """Decouple producer from consumer through a bounded ring buffer
        filled by a background stage thread. ``buffer_size=AUTOTUNE``
        lets the autotuner grow the ring (up to 16) while consumers
        stall. Source/worker errors propagate to the consuming thread
        at the position they occurred — never silent end-of-data."""
        if buffer_size != AUTOTUNE:
            buffer_size = int(buffer_size)
            if buffer_size < 1:
                raise ValueError(
                    f"prefetch: buffer_size must be >= 1 or AUTOTUNE, "
                    f"got {buffer_size}")
        return self._derive(Node("prefetch", self._node, (buffer_size,)))

    def superbatch(self, n, drop_remainder=True):
        """Stack ``n`` consecutive elements (typically batches) along a
        new leading axis — the N-step "superbatch" that
        ``Session.run_steps(stacked_feeds=...)`` consumes: one
        host-to-device copy then feeds a window of N steps. Component
        structure (tuple/dict) is preserved; with ``drop_remainder``
        (default: static shapes) a trailing short window is dropped."""
        return self._derive(Node(
            "batch", self._node, (int(n), drop_remainder, _stack_batch)))

    def prefetch_to_device(self, buffer_size=2, sharding=None,
                           arena_staging=None, superbatch=None,
                           device=None):
        """Batches already on ``device`` (``models.common.resolve_device``;
        default the card) when the consumer asks for them, as torch
        tensors (strings stay numpy ``object`` arrays).

        A pipeline thread assembles each element in pinned host memory
        and copies it ``non_blocking`` to the card on a side stream,
        recording an event after the copy; ``buffer_size`` elements wait
        on the card, ``buffer_size`` more on the host. The consumer's
        stream waits on the event and is recorded on each tensor
        (``data/staging.py``). ``superbatch``: stack every N consecutive
        elements along a new leading axis first, one copy feeding a
        ``Session.run_steps(n=N, stacked_feeds=...)`` window (the staging
        lands in a ``superbatch_stage`` span).

        ``arena_staging`` (default on the card): assemble in a pool of
        ``ring_cap + 3`` pinned slots, the terminal ``batch``/
        ``superbatch`` stage stacking straight into a slot; a slot is
        reused only after its copy's event has completed. Off, each
        element is copied from pageable memory. On the CPU nothing is
        pinned and nothing waits. ``sharding``: not ported."""
        if sharding is not None:
            raise NotImplementedError(
                "prefetch_to_device(sharding=) is not ported (ROADMAP "
                "Queue 1 item 11: parallel and sharding)")
        from ..models.common import resolve_device

        base = self.superbatch(superbatch) if superbatch else self
        ring_cap = (pipeline_mod.PREFETCH_AUTOTUNE_MAX
                    if buffer_size == AUTOTUNE else int(buffer_size))

        def transfers(dev, pool):
            """The device stage (a pipeline thread): ``(element on the
            card, its copy's event)`` in stream order."""
            import contextlib

            from ..platform import monitoring

            staged = base
            if (pool is not None and base._node.kind == "batch"
                    and getattr(base._node.args[2], "supports_alloc",
                                False)):
                # the terminal stack assembles straight into a slot; a
                # clone, so the user's dataset is never flagged
                clone = Node("batch", base._node.parent, base._node.args)
                clone.alloc_pool = pool
                staged = base._derive(clone)
            stream = None
            if dev.type == "cuda":
                with staging._cuda_lock(dev):
                    stream = torch.cuda.Stream(dev)
            src = iter(staged.prefetch(buffer_size))
            try:
                for x in src:
                    slot = None
                    if isinstance(x, pipeline_mod.ArenaBatch):
                        x, slot = x.value, x.slot
                    with (monitoring.traceme("superbatch_stage",
                                             n_steps=superbatch)
                          if superbatch else contextlib.nullcontext()):
                        if pool is not None and slot is None:
                            slot, x = pool.stage(x)
                        out, event = staging.to_device(x, dev, stream)
                        if pool is not None:
                            pool.mark_in_flight(slot, event)
                    yield _OnDevice(out, event)
            finally:
                if hasattr(src, "close"):
                    src.close()
                if pool is not None:
                    pool.close()

        def gen():
            dev = resolve_device(device if device is not None else "cuda")
            use_pool = dev.type == "cuda" and arena_staging is not False
            pool = staging.PinnedPool(ring_cap + 3, dev) if use_pool \
                else None
            src = iter(Dataset(lambda: transfers(dev, pool)).prefetch(
                buffer_size))
            try:
                for item in src:
                    yield staging.hand_over(item.value, item.event, dev)
            finally:
                if hasattr(src, "close"):
                    src.close()

        out = Dataset(gen)
        out._spec_source = base
        return out

    def cache(self):
        box: List = []

        def apply(it):
            if box:
                yield from box[0]
                return
            items = []
            for x in it:
                items.append(x)
                yield x
            box.append(items)

        return self._seq(apply)

    # -- consumption ---------------------------------------------------------
    def __iter__(self):
        if pipeline_mod.chain_is_parallel(self._node):
            return pipeline_mod.build_iterator(self._node)
        return iter(self._factory())

    def as_numpy_iterator(self):
        return iter(self)

    def make_one_shot_iterator(self):
        return Iterator(self)

    def make_initializable_iterator(self):
        return Iterator(self, initializable=True)


class _OnDevice:
    """An element copied to the device and the event its copy recorded
    (None on the CPU), between the device stage and the consumer."""

    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value = value
        self.event = event


def _stack_one(vals, alloc=None):
    # bytes/str rows must stack as OBJECT arrays: numpy's fixed-width
    # 'S' dtype zero-pads and strips trailing NULs, which corrupts
    # serialized protos (a TFRecord batch is the common case here)
    if isinstance(vals[0], (bytes, str, np.bytes_, np.str_)):
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return out
    arrs = [np.asarray(v) for v in vals]
    if alloc is not None and arrs[0].dtype.kind not in "OSUV":
        out = alloc((len(arrs),) + arrs[0].shape, arrs[0].dtype)
        return np.stack(arrs, out=out)
    return np.stack(arrs)


def _pad_one(vals, padded_shape, padding_value):
    """Stack a list of np arrays, padding every dim to a common target."""
    if isinstance(vals[0], (bytes, str, np.bytes_, np.str_)):
        return _stack_one(vals)  # strings batch as object arrays, no pad
    arrs = [np.asarray(v) for v in vals]
    rank = arrs[0].ndim
    if any(a.ndim != rank for a in arrs):
        raise ValueError(
            f"padded_batch: rank mismatch within batch: "
            f"{[a.shape for a in arrs]}")
    if rank == 0:
        return np.stack(arrs)
    maxdims = [max(a.shape[d] for a in arrs) for d in range(rank)]
    if padded_shape is not None:
        padded_shape = list(padded_shape)
        if len(padded_shape) != rank:
            raise ValueError(
                f"padded_shapes rank {len(padded_shape)} != element rank "
                f"{rank}")
        target = []
        for d, (want, got) in enumerate(zip(padded_shape, maxdims)):
            want = -1 if want is None else int(want)
            if want == -1:
                target.append(got)
            elif want < got:
                raise ValueError(
                    f"padded_batch: element dim {d} is {got}, larger than "
                    f"padded shape {want}")
            else:
                target.append(want)
    else:
        target = maxdims
    kind = arrs[0].dtype.kind
    if kind in ("O", "S", "U"):
        # string components pad with b""/"" as documented; build an
        # OBJECT array — numpy's fixed-width 'S'/'U' would truncate or
        # NUL-pad longer entries (same hazard as _stack_one)
        if padding_value is None:
            padding_value = "" if kind == "U" else b""
        out = np.empty([len(arrs)] + target, dtype=object)
        out[...] = padding_value
    else:
        pv = 0 if padding_value is None else padding_value
        out = np.full([len(arrs)] + target, pv, dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
    return out


def _pad_batch(rows, padded_shapes, padding_values):
    """Pad+stack rows preserving tuple/dict element structure."""
    def comp(getter, shape, value):
        return _pad_one([getter(r) for r in rows], shape, value)

    if isinstance(rows[0], tuple):
        n = len(rows[0])
        shapes = padded_shapes if padded_shapes is not None else [None] * n
        values = padding_values if padding_values is not None else [None] * n
        return tuple(comp(lambda r, i=i: r[i], shapes[i], values[i])
                     for i in range(n))
    if isinstance(rows[0], dict):
        shapes = padded_shapes or {}
        values = padding_values or {}
        return {k: comp(lambda r, k=k: r[k], shapes.get(k),
                        values.get(k)) for k in rows[0]}
    return _pad_one(rows, padded_shapes, padding_values)


def _stack_batch(rows, alloc=None):
    if isinstance(rows[0], tuple):
        return tuple(_stack_one([r[i] for r in rows], alloc)
                     for i in range(len(rows[0])))
    if isinstance(rows[0], dict):
        return {k: _stack_one([r[k] for r in rows], alloc) for k in rows[0]}
    return _stack_one(rows, alloc)


# prefetch_to_device may hand this stack fn a pinned-slot allocator; stack
# fns without the flag (padded_batch's padding stack) get the element-wise
# pool.stage() copy instead
_stack_batch.supports_alloc = True


class TFRecordDataset(Dataset):
    """(ref: reader ops core/kernels/record_yielder +
    python TFRecordDataset). Uses the native record reader when
    built; ``num_parallel_reads`` (int or AUTOTUNE) fans the read out
    over file shards on reader threads that deliver record CHUNKS from
    the batched C++ call, emitted in strict shard order — the parallel
    stream is byte-identical to the sequential one."""

    def __init__(self, filenames, compression_type=None, buffer_size=None,
                 num_parallel_reads=None):
        if isinstance(filenames, (str, bytes)):
            filenames = [filenames]
        files = [f.decode() if isinstance(f, bytes) else str(f)
                 for f in filenames]
        comp = compression_type
        if isinstance(comp, bytes):
            comp = comp.decode()
        comp = (comp or "").upper()
        if comp not in ("", "GZIP"):
            raise errors.UnimplementedError(
                None, None,
                f"TFRecordDataset: compression_type={comp!r} is not "
                "supported (supported: None/'' and 'GZIP')")
        if buffer_size is not None:
            buffer_size = int(buffer_size)
            if buffer_size <= 0:
                raise ValueError(
                    f"TFRecordDataset: buffer_size must be > 0, got "
                    f"{buffer_size}")
        num_parallel_reads = _check_parallel_arg(
            num_parallel_reads, "TFRecordDataset: num_parallel_reads")
        if num_parallel_reads == 1:
            num_parallel_reads = None

        def open_chunks(path):
            from ..lib.io.tf_record import tf_record_chunks

            return tf_record_chunks(path, compression=comp,
                                    buffer_size=buffer_size)

        node = Node("tfrecord", None,
                    (files, open_chunks, num_parallel_reads))
        super().__init__(
            lambda: pipeline_mod.build_iterator(node, sequential=True),
            node=node)


_ITER_COUNT = [0]


def iterator_registry(graph=None):
    """The name -> Iterator map of ``graph``'s root graph (default: the
    default graph). Graph-scoped, NOT process-global: a graph owns the
    iterators its IteratorGetNext ops name, so dropping the graph
    (reset_default_graph) releases them — and with them the pipeline
    stage threads and ring buffers their streams pin. A process-global
    registry kept every iterator (one-shot iterators have no other
    reference) alive for the life of the process."""
    g = graph if graph is not None else ops_mod.get_default_graph()
    while getattr(g, "outer_graph", None) is not None:
        g = g.outer_graph
    return g._scoped_state.setdefault("__data_iterators__", {})


class Iterator:
    """Graph-facing iterator: ``get_next()`` returns the outputs of an
    ``IteratorGetNext`` op that pulls the next element during each
    ``Session.run`` (the reference's dequeue); iterating the Iterator
    itself pulls elements outside the graph (a ``run_steps`` superbatch),
    counted alike. Replacing the underlying stream (initializer,
    checkpoint restore) closes any pipeline backing the old one."""

    def __init__(self, dataset: Dataset, initializable=False):
        self._dataset = dataset
        self._it = None if initializable else iter(dataset)
        _ITER_COUNT[0] += 1
        self._name = f"dataset_iterator_{_ITER_COUNT[0]}"
        iterator_registry()[self._name] = self
        self._spec = None
        self._keys = None
        self._structure = "single"
        self._position = 0  # elements consumed; checkpointed by Saver

    def close(self):
        """Release the underlying stream (and any pipeline stage
        threads and pinned slots backing it). The iterator stays
        restorable: initializer / restore_state builds a fresh stream."""
        self._replace_stream(None)

    def _replace_stream(self, new_it):
        old, self._it = self._it, new_it
        if old is not None and hasattr(old, "close"):
            old.close()

    def _next_value(self):
        if self._it is None:
            raise errors.FailedPreconditionError(
                None, None, "Iterator not initialized; run initializer")
        try:
            val = next(self._it)
            self._position += 1
            return val
        except StopIteration:
            raise errors.OutOfRangeError(None, None, "End of sequence")

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self._next_value()
        except errors.OutOfRangeError:
            raise StopIteration from None

    # -- checkpointable position -----------------------------------------
    @property
    def name(self):
        return self._name

    def save_state(self):
        return {"position": self._position}

    def restore_state(self, state):
        """Re-create the underlying stream and skip forward to the saved
        position. Deterministic pipelines (generator composition, seeded
        shuffles, ORDERED parallel stages) reproduce the exact element
        stream, so skip-forward == resume (docs/DATA.md)."""
        pos = int(state.get("position", 0))
        self._replace_stream(iter(self._dataset))
        for _ in range(pos):
            try:
                next(self._it)
            except StopIteration:
                break
        self._position = pos

    @property
    def initializer(self):
        g = ops_mod.get_default_graph()
        return g.create_op("IteratorInit", [],
                           attrs={"iterator": self._name}, name="iter_init",
                           output_specs=[])

    def _probe_spec(self):
        """Type the outputs from the first element of the sequential
        compile (no stage threads), of the host dataset a device prefetch
        reads when there is one (no stream, pinned pool or copy)."""
        ds = self._dataset
        while ds._spec_source is not None:
            ds = ds._spec_source
        probe_it = pipeline_mod.build_iterator(ds._node, sequential=True,
                                               _count=False)
        try:
            first = next(probe_it)
        finally:
            if hasattr(probe_it, "close"):
                probe_it.close()
        if isinstance(first, dict):
            self._keys = sorted(first)
            items = [first[k] for k in self._keys]
            self._structure = "dict"
        elif isinstance(first, tuple):
            self._keys = None
            items = list(first)
            self._structure = "tuple"
        else:
            self._keys = None
            items = [first]
            self._structure = "single"
        self._spec = [_spec_of(x) for x in items]

    def get_next(self, name=None):
        if self._spec is None:
            self._probe_spec()
        g = ops_mod.get_default_graph()
        specs = [(shape_mod.TensorShape(list(sh)), dt)
                 for sh, dt in self._spec]
        op = g.create_op("IteratorGetNext", [],
                         attrs={"iterator": self._name},
                         name=name or "IteratorGetNext", output_specs=specs)
        outs = list(op.outputs)
        if self._structure == "dict":
            return dict(zip(self._keys, outs))
        if self._structure == "tuple":
            return tuple(outs)
        return outs[0]


def _spec_of(x):
    """``(shape, DType)`` of one element component."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), dtypes_mod.as_dtype(x.dtype)
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.kind in "USV":
        return a.shape, dtypes_mod.string
    return a.shape, dtypes_mod.as_dtype(a.dtype)


def _host_value(x):
    """A component as the host stage hands it on: a torch tensor as it
    is (on the card after ``prefetch_to_device``), strings as ``object``
    arrays, anything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.kind in "SU":
        return a.astype(object)
    return a


def _lower_get_next(ctx, op, inputs):
    it = iterator_registry(op.graph)[op.attrs["iterator"]]
    val = it._next_value()
    if isinstance(val, dict):
        items = [val[k] for k in it._keys]
    elif isinstance(val, tuple):
        items = list(val)
    else:
        items = [val]
    return [_host_value(x) for x in items]


def _lower_iter_init(ctx, op, inputs):
    it = iterator_registry(op.graph)[op.attrs["iterator"]]
    it._replace_stream(iter(it._dataset))
    return []


op_registry.register("IteratorGetNext", lower=_lower_get_next,
                     is_stateful=True, runs_on_host=True)
op_registry.register("IteratorInit", lower=_lower_iter_init,
                     is_stateful=True, runs_on_host=True)


def make_one_shot_iterator(dataset):
    return Iterator(dataset)
