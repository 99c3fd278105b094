"""Parallel host input-pipeline engine of the port's ``stf.data``; the
port's copy of ``simple_tensorflow_tpu/data/pipeline.py`` (host code, on
the port's ``platform/{monitoring,sync}.py``).

(ref: the reference's tf.data runtime — core/kernels/data/*_dataset_op.cc,
model.cc AUTOTUNE.)

A Dataset chain records a linear graph of ``Node`` specs; iteration
*compiles* that chain into a stage pipeline:

- **Sequential stages** (filter/take/shuffle/batch/...) stay plain
  generators fused into whichever thread consumes them.
- **Async stages** decouple through bounded ``RingBuffer``s with
  backpressure and run on worker threads: ``prefetch`` (one staging
  thread), ``map(num_parallel_calls=...)`` (a shared process-wide task
  pool; ordered mode preserves the exact sequential element order,
  unordered mode emits completion-order), ``interleave`` (per-slot
  puller threads), and sharded ``TFRecordDataset(num_parallel_reads=...)``
  reads (per-shard reader threads delivering *chunks* straight from the
  native batch record reader, emitted in strict shard order so the
  parallel stream is byte-identical to the sequential one).
- ``AUTOTUNE`` stages start small and a per-pipeline autotuner thread
  resizes their parallelism (and prefetch ring capacity) from stall-time
  and buffer-occupancy gauges.

Every async stage reports ``/stf/data/*`` metrics under the JAX package's
names and hands its worker threads the creating thread's trace buffers.
Every stage thread is a daemon named ``stf_data_<stage>``; closing a
pipeline cancels its stages and joins their threads (a thread that does
not end within ``JOIN_TIMEOUT_S`` is left to end on its own, as a
collected iterator's are).

Error contract: any stage exception (source, map_func, record
corruption) propagates to the consuming thread at the position the
element would have occupied; end-of-data is only ever reported after a
clean source exhaustion.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from ..platform import monitoring
from ..platform import sync as _sync

# Sentinel accepted by map/interleave/prefetch/num_parallel_reads: "let
# the autotuner pick and adjust" (same spelling as tf.data.AUTOTUNE).
AUTOTUNE = -1

# Ceiling the autotuner may grow an AUTOTUNE prefetch ring to;
# prefetch_to_device sizes its pinned slot pool from it.
PREFETCH_AUTOTUNE_MAX = 16

_DONE = object()

# distinct from _DONE: a timed RingBuffer.get that elapsed with the
# buffer still open and empty
TIMED_OUT = object()


class _Error:
    """Wraps an exception crossing a ring buffer / future boundary so it
    re-raises in the consuming thread at the right stream position."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


# ---------------------------------------------------------------------------
# metrics (process-global; registration is idempotent)
# ---------------------------------------------------------------------------

_elements = monitoring.Counter(
    "/stf/data/elements",
    "Elements emitted by each async pipeline stage", "stage")
_stalls = monitoring.Counter(
    "/stf/data/stall_micros",
    "Microseconds a stage boundary spent blocked: produce = waiting for "
    "downstream buffer space, consume = waiting for upstream data",
    "stage", "kind")
_occupancy = monitoring.IntGauge(
    "/stf/data/buffer_occupancy",
    "Elements currently buffered in a stage's output ring", "stage")
_parallelism_gauge = monitoring.IntGauge(
    "/stf/data/parallelism",
    "Live worker parallelism of a stage (AUTOTUNE resizes it)", "stage")
_autotune_adjustments = monitoring.Counter(
    "/stf/data/autotune_adjustments",
    "AUTOTUNE parallelism/capacity resize decisions", "stage", "direction")
_records_read = monitoring.Counter(
    "/stf/data/records_read", "TFRecords delivered by sharded readers")
_pipelines_started = monitoring.Counter(
    "/stf/data/pipelines_started",
    "Pipeline iterations begun, by execution mode", "mode")


# ---------------------------------------------------------------------------
# shared worker pool (element-level tasks: map_func calls, batch parses)
# ---------------------------------------------------------------------------

_pool_lock = _sync.Lock("data/worker_pool",
                        rank=_sync.RANK_LIFECYCLE)
_pool = None
_pool_size = 0


def worker_pool():
    """Process-wide thread pool for element-level tasks. Stream-scoped
    workers (shard readers, interleave slot pullers, prefetch stagers)
    run on dedicated per-stage threads instead — a long-lived producer
    parked in a bounded pool would deadlock the element tasks behind it.
    Size: STF_DATA_WORKERS or 2*cpu (min 4, max 32)."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None:
            import concurrent.futures as cf

            n = int(os.environ.get("STF_DATA_WORKERS", "0") or 0)
            if n <= 0:
                n = min(32, max(4, 2 * (os.cpu_count() or 2)))
            _pool_size = n
            _pool = cf.ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="stf_data_worker")
        return _pool


def pool_size() -> int:
    worker_pool()
    return _pool_size


# ---------------------------------------------------------------------------
# per-stage bookkeeping
# ---------------------------------------------------------------------------

class StageStats:
    """Metric cells for one pipeline stage + cheap unsynchronized
    mirrors the autotuner reads without touching the registry locks."""

    __slots__ = ("name", "elements", "_produce", "_consume",
                 "occupancy", "parallelism", "elements_n",
                 "produce_micros", "consume_micros")

    def __init__(self, name: str):
        self.name = name
        self.elements = _elements.get_cell(name)
        self._produce = _stalls.get_cell(name, "produce")
        self._consume = _stalls.get_cell(name, "consume")
        self.occupancy = _occupancy.get_cell(name)
        self.parallelism = _parallelism_gauge.get_cell(name)
        self.elements_n = 0
        self.produce_micros = 0
        self.consume_micros = 0

    def count(self, n: int = 1):
        self.elements.increase_by(n)
        self.elements_n += n

    def stall(self, kind: str, seconds: float):
        us = int(seconds * 1e6)
        if us <= 0:
            return
        if kind == "produce":
            self._produce.increase_by(us)
            self.produce_micros += us
        else:
            self._consume.increase_by(us)
            self.consume_micros += us


class RingBuffer:
    """Bounded buffer between stages. ``put`` blocks while full (the
    backpressure edge), ``get`` blocks while empty; ``close`` wakes every
    waiter (puts start returning False, gets drain then report _DONE).
    Capacity is live-adjustable (AUTOTUNE prefetch grows it).

    Both operations take an optional ``timeout`` (seconds): a timed
    ``put`` that cannot find space returns False with the buffer still
    open (distinguish via ``closed``); a timed ``get`` that finds no
    item returns the module's ``TIMED_OUT`` sentinel."""

    def __init__(self, capacity: int, stats: Optional[StageStats] = None):
        self._dq: deque = deque()
        self.capacity = max(1, int(capacity))
        self._mutex = _sync.Lock("data/ring_buffer",
                                 rank=_sync.RANK_QUEUE)
        self._not_empty = _sync.Condition(self._mutex)
        self._not_full = _sync.Condition(self._mutex)
        self._closed = False
        self._stats = stats

    @property
    def closed(self) -> bool:
        return self._closed

    @staticmethod
    def _wait(cond, deadline):
        if deadline is None:
            cond.wait(0.1)
            return True
        remaining = deadline - time.perf_counter()
        if remaining <= 0:
            return False
        cond.wait(min(remaining, 0.1))
        return True

    def put(self, item, timeout: Optional[float] = None) -> bool:
        with self._not_full:
            if self._closed:
                return False
            if len(self._dq) >= self.capacity:
                deadline = None if timeout is None \
                    else time.perf_counter() + timeout
                t0 = time.perf_counter()
                while len(self._dq) >= self.capacity and not self._closed:
                    if not self._wait(self._not_full, deadline):
                        break
                if self._stats is not None:
                    self._stats.stall("produce", time.perf_counter() - t0)
                if self._closed or len(self._dq) >= self.capacity:
                    return False
            self._dq.append(item)
            if self._stats is not None:
                self._stats.occupancy.set(len(self._dq))
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        """Next item; _DONE when closed and drained (cancellation path —
        producers signal normal end-of-stream by putting _DONE); with a
        ``timeout``, TIMED_OUT when it elapses with the buffer open."""
        with self._not_empty:
            if not self._dq:
                deadline = None if timeout is None \
                    else time.perf_counter() + timeout
                t0 = time.perf_counter()
                while not self._dq and not self._closed:
                    if not self._wait(self._not_empty, deadline):
                        break
                if self._stats is not None:
                    self._stats.stall("consume", time.perf_counter() - t0)
                if not self._dq:
                    return _DONE if self._closed else TIMED_OUT
            item = self._dq.popleft()
            if self._stats is not None:
                self._stats.occupancy.set(len(self._dq))
            self._not_full.notify()
            return item

    def set_capacity(self, capacity: int):
        with self._not_full:
            self.capacity = max(1, int(capacity))
            self._not_full.notify_all()

    def close(self):
        with self._mutex:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self):
        with self._mutex:
            return len(self._dq)


class _Knob:
    """One autotunable quantity (a stage's worker window or a ring's
    capacity). ``value`` is read by the stage on every scheduling
    decision, so autotuner writes take effect immediately."""

    __slots__ = ("stats", "value", "lo", "hi", "ring",
                 "_last_elems", "_last_consume", "_last_produce")

    def __init__(self, stats: StageStats, value: int, lo: int, hi: int,
                 ring: Optional[RingBuffer] = None):
        self.stats = stats
        self.value = value
        self.lo = lo
        self.hi = max(lo, hi)
        self.ring = ring  # when set, autotune resizes ring capacity too
        self._last_elems = 0
        self._last_consume = 0
        self._last_produce = 0
        stats.parallelism.set(value)

    def tick(self):
        """One autotune step: stall-per-element since the last tick
        decides the direction. A stage whose consumers wait long per
        element is the bottleneck -> widen; a stage that mostly waits on
        downstream buffer space overprovisions -> narrow."""
        st = self.stats
        d_elems = st.elements_n - self._last_elems
        d_consume = st.consume_micros - self._last_consume
        d_produce = st.produce_micros - self._last_produce
        self._last_elems = st.elements_n
        self._last_consume = st.consume_micros
        self._last_produce = st.produce_micros
        if d_elems <= 0 and d_consume <= 0:
            return
        wait_per_elem = d_consume / max(1, d_elems)
        produce_per_elem = d_produce / max(1, d_elems)
        if (wait_per_elem > 200.0 and produce_per_elem < wait_per_elem
                and self.value < self.hi):
            self.value += 1
            _autotune_adjustments.get_cell(st.name, "up").increase_by(1)
        elif wait_per_elem < 20.0 and self.value > self.lo:
            self.value -= 1
            _autotune_adjustments.get_cell(st.name, "down").increase_by(1)
        else:
            return
        st.parallelism.set(self.value)
        if self.ring is not None:
            self.ring.set_capacity(self.value)


# how long closing a pipeline waits for its stage threads
JOIN_TIMEOUT_S = 5.0


class PipelineRun:
    """Shared state of one pipeline iteration: cancellation, dedicated
    stage threads, buffers to close, autotune knobs, and the creating
    thread's traceme collections (installed into every stage thread so
    worker spans land in the caller's trace)."""

    AUTOTUNE_INTERVAL_S = 0.05

    def __init__(self):
        self.cancel = threading.Event()
        self._threads: List[threading.Thread] = []
        self._buffers: List[RingBuffer] = []
        self._knobs: List[_Knob] = []
        self._trace_sinks = monitoring.active_trace_buffers()
        self._closed = False
        self._autotune_started = False
        self._lock = _sync.Lock("data/pipeline_run",
                                rank=_sync.RANK_ENGINE)

    def spawn(self, name: str, fn: Callable[[], None]) -> threading.Thread:
        sinks = self._trace_sinks

        def run():
            import contextlib

            with contextlib.ExitStack() as stack:
                for b in sinks:
                    stack.enter_context(monitoring.trace_collection(b))
                try:
                    fn()
                except Exception:
                    # stage bodies forward their own errors through
                    # buffers; anything escaping here is a bug in the
                    # engine itself
                    if not self.cancel.is_set():
                        raise

        t = threading.Thread(target=run, name=f"stf_data_{name}",
                             daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()
        return t

    def register_buffer(self, buf: RingBuffer) -> RingBuffer:
        with self._lock:
            self._buffers.append(buf)
            closed = self._closed
        if closed:  # a stage started while the run was closing
            buf.close()
        return buf

    def register_knob(self, knob: _Knob) -> _Knob:
        # Knobs register lazily, from inside stage generator bodies on
        # their first element — NOT at pipeline build — so the autotuner
        # thread must start on first registration rather than once after
        # compile (when the knob list is still empty).
        with self._lock:
            self._knobs.append(knob)
            start = not self._autotune_started and not self._closed
            self._autotune_started = self._autotune_started or start
        if start:
            self._start_autotuner()
        return knob

    def _start_autotuner(self):
        def tune():
            while not self.cancel.wait(self.AUTOTUNE_INTERVAL_S):
                for knob in list(self._knobs):
                    knob.tick()

        self.spawn("autotune", tune)

    def close(self, join: bool = True):
        """Cancel every stage and close its buffers; with ``join``, wait
        up to ``JOIN_TIMEOUT_S`` for the stage threads (the calling one
        aside) to end."""
        with self._lock:
            closed, self._closed = self._closed, True
        if not closed:
            self.cancel.set()
            for b in self._buffers:
                b.close()
        if join:
            self.close_join()

    def close_join(self):
        me = threading.current_thread()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for t in list(self._threads):
            if t is not me:
                t.join(max(0.0, deadline - time.monotonic()))


class PipelineIterator:
    """Iterator over a compiled pipeline. ``close()`` (also driven by
    GC and end-of-stream) cancels stage threads and releases buffers —
    checkpoint restore replaces iterators mid-stream, so shutdown must
    not wait for sources to drain."""

    def __init__(self, run: PipelineRun, gen):
        self._run = run
        self._gen = gen

    def __iter__(self):
        return self

    def __next__(self):
        if self._gen is None:
            raise StopIteration
        try:
            return next(self._gen)
        except StopIteration:
            self.close()
            raise
        except BaseException:
            self.close()
            raise

    @property
    def closed(self) -> bool:
        return self._run is None and self._gen is None

    def close(self, join: bool = True):
        run, gen = self._run, self._gen
        self._run = None
        self._gen = None
        if run is not None:
            run.close(join=False)
        if gen is not None:
            try:
                gen.close()
            except Exception:
                pass
        if run is not None and join:
            run.close_join()

    def __del__(self):
        try:
            self.close(join=False)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# node spec (built by Dataset transforms, compiled here)
# ---------------------------------------------------------------------------

class Node:
    """One stage spec in a Dataset chain. ``kind`` selects the executor;
    ``args`` carry the transform payload. ``alloc_pool`` (batch-like
    nodes only) is installed by ``prefetch_to_device`` so batches
    assemble directly into pinned staging slots."""

    __slots__ = ("kind", "parent", "args", "alloc_pool")

    def __init__(self, kind: str, parent: Optional["Node"], args: tuple):
        self.kind = kind
        self.parent = parent
        self.args = args
        self.alloc_pool = None


def _chain(node: Node) -> List[Node]:
    out = []
    while node is not None:
        out.append(node)
        node = node.parent
    out.reverse()
    return out


def _is_parallel(node: Node) -> bool:
    if node.kind == "prefetch":
        return True
    if node.kind == "pmap":
        return True
    if node.kind == "interleave":
        return node.args[3] is not None  # num_parallel_calls
    if node.kind == "tfrecord":
        return node.args[2] is not None  # num_parallel_reads
    return False


def chain_is_parallel(node: Node) -> bool:
    return any(_is_parallel(n) for n in _chain(node))


def _resolve(n, default: int, cap: int):
    """num_parallel_* value -> (initial, lo, hi, autotuned)."""
    if n == AUTOTUNE:
        return min(default, cap), 1, cap, True
    n = int(n)
    return min(n, cap), min(n, cap), min(n, cap), False


# -- stage executors ---------------------------------------------------------

def _source_iter(node: Node):
    (factory,) = node.args
    return iter(factory())


def _zip_iter(node: Node):
    (datasets,) = node.args
    its = [iter(d) for d in datasets]
    try:
        while True:
            row = []
            for it in its:
                try:
                    row.append(next(it))
                except StopIteration:
                    return
            yield tuple(row)
    finally:
        for it in its:
            if hasattr(it, "close"):
                it.close()


def _seq_iter(node: Node, up):
    apply_fn = node.args[0]
    return apply_fn(up)


def _repeat_iter(run: Optional[PipelineRun], node: Node, up):
    """Epoch 0 consumes the already-compiled upstream iterator; later
    epochs recompile the upstream chain in the SAME execution mode
    (parallel upstream stages re-spin per epoch). ``yield from``
    delegates close() into the per-epoch PipelineIterator (PEP 380), so
    cancelling mid-epoch tears the epoch's stage threads down."""
    (count,) = node.args
    n = 0
    it = up
    while count is None or n < count:
        yield from it
        n += 1
        if count is None or n < count:
            it = build_iterator(node.parent, sequential=(run is None),
                                _count=False)


def _batch_iter(node: Node, up):
    batch_size, drop_remainder, stack_fn = node.args
    pool = node.alloc_pool
    buf = []
    for x in up:
        buf.append(x)
        if len(buf) == batch_size:
            yield _assemble(stack_fn, buf, pool)
            buf = []
    if buf and not drop_remainder:
        yield _assemble(stack_fn, buf, pool)


class ArenaBatch:
    """A batch assembled directly in a pinned staging slot; carried
    through prefetch rings to ``prefetch_to_device``, which copies
    ``value`` to the card and frees ``slot`` for reuse once that copy has
    completed (no host copy between batch assembly and the transfer)."""

    __slots__ = ("value", "slot")

    def __init__(self, value, slot):
        self.value = value
        self.slot = slot


def _assemble(stack_fn, rows, pool):
    if pool is None:
        return stack_fn(rows, None)
    slot, arena = pool.acquire()

    def alloc(shape, dtype):
        return arena.alloc_ndarray(shape, dtype)

    return ArenaBatch(stack_fn(rows, alloc), slot)


def _prefetch_iter(run: PipelineRun, node: Node, up, label: str):
    (capacity,) = node.args
    stats = StageStats(label)
    # an explicit buffer_size is honored exactly (the 16 cap bounds only
    # AUTOTUNE growth — a user asking for prefetch(64) gets 64 slots)
    if capacity is None:
        capacity = 2
    if capacity == AUTOTUNE:
        cap0, lo, hi, autotuned = 2, 1, PREFETCH_AUTOTUNE_MAX, True
    else:
        cap0 = int(capacity)
        lo = hi = cap0
        autotuned = False
    ring = run.register_buffer(RingBuffer(cap0, stats))
    if autotuned:
        run.register_knob(_Knob(stats, cap0, lo, hi, ring=ring))
    else:
        stats.parallelism.set(cap0)

    def work():
        try:
            for x in up:
                if not ring.put(x):
                    return
            ring.put(_DONE)
        except BaseException as e:  # noqa: BLE001 — NEVER convert a
            # source error into silent end-of-data
            ring.put(_Error(e))
        finally:
            _close(up)

    run.spawn(f"{label}_stage", work)
    while True:
        item = ring.get()
        if item is _DONE:
            return
        if isinstance(item, _Error):
            raise item.exc
        stats.count()
        yield item


def _close(it) -> None:
    """Close a stage's upstream iterator (a nested pipeline's threads
    end with it)."""
    if hasattr(it, "close"):
        try:
            it.close()
        except Exception:
            pass


def _call_guarded(fn, x):
    try:
        return fn(x)
    except BaseException as e:  # noqa: BLE001 — re-raised at position
        return _Error(e)


def _pmap_ordered_iter(run: PipelineRun, node: Node, up, label: str):
    fn, n, _det = node.args
    stats = StageStats(label)
    pool = worker_pool()
    value, lo, hi, autotuned = _resolve(n, 2, pool_size())
    knob = _Knob(stats, value, lo, hi)
    if autotuned:
        run.register_knob(knob)
    futures: deque = deque()
    exhausted = False
    upstream_exc = None
    while True:
        while (not exhausted and len(futures) < knob.value
               and not run.cancel.is_set()):
            try:
                x = next(up)
            except StopIteration:
                exhausted = True
                break
            except BaseException as e:  # noqa: BLE001 — at-position
                # contract: elements already mapped are delivered first,
                # the upstream error raises at the position it occupies
                exhausted = True
                upstream_exc = e
                break
            futures.append(pool.submit(_call_guarded, fn, x))
        if not futures:
            if upstream_exc is not None:
                raise upstream_exc
            return
        f = futures.popleft()
        t0 = time.perf_counter()
        res = f.result()
        stats.stall("consume", time.perf_counter() - t0)
        if isinstance(res, _Error):
            raise res.exc
        stats.count()
        yield res


def _pmap_unordered_iter(run: PipelineRun, node: Node, up, label: str):
    fn, n, _det = node.args
    stats = StageStats(label)
    pool = worker_pool()
    value, lo, hi, autotuned = _resolve(n, 2, pool_size())
    knob = _Knob(stats, value, lo, hi)
    if autotuned:
        run.register_knob(knob)
    ring = run.register_buffer(RingBuffer(max(2, 2 * hi), stats))
    cv = _sync.Condition(name="data/pmap_inflight",
                         rank=_sync.RANK_QUEUE)
    inflight = [0]

    def on_done(fut):
        # Runs on a shared-pool worker thread, so it must NEVER block:
        # a callback parked in ring.put holds a pool slot, and with
        # enough of them parked a second pool-using stage can never run
        # — permanent deadlock (the worker_pool invariant). inflight is
        # released by the CONSUMER as it takes each item, so ring
        # occupancy <= inflight <= hi < capacity and this put cannot
        # hit backpressure.
        ring.put(fut.result())  # _call_guarded: never raises

    def feed():
        err = None
        try:
            for x in up:
                with cv:
                    while (inflight[0] >= knob.value
                           and not run.cancel.is_set()):
                        cv.wait(0.1)
                    if run.cancel.is_set():
                        return
                    inflight[0] += 1
                pool.submit(_call_guarded, fn, x).add_done_callback(on_done)
        except BaseException as e:  # noqa: BLE001 — held until in-flight
            # results drain: already-mapped elements are delivered, the
            # upstream error follows at its stream position
            err = e
        with cv:
            while inflight[0] > 0 and not run.cancel.is_set():
                cv.wait(0.1)
        ring.put(_Error(err) if err is not None else _DONE)

    run.spawn(f"{label}_feeder", feed)
    while True:
        item = ring.get()
        if item is _DONE:
            return
        if isinstance(item, _Error):
            raise item.exc
        with cv:
            inflight[0] -= 1
            cv.notify_all()
        stats.count()
        yield item


def _tfrecord_iter(run: Optional[PipelineRun], node: Node, label: str):
    files, open_chunks, num_parallel_reads = node.args
    rec_cell = _records_read.get_cell()
    if run is None or num_parallel_reads is None:
        # sequential: shard after shard through the (chunked) reader
        for f in files:
            for chunk in open_chunks(f):
                rec_cell.increase_by(len(chunk))
                yield from chunk
        return
    stats = StageStats(label)
    value, lo, hi, autotuned = _resolve(
        num_parallel_reads, 4, min(16, max(1, len(files))))
    knob = _Knob(stats, value, lo, hi)
    if autotuned:
        run.register_knob(knob)
    queues: dict = {}

    def start_reader(i: int):
        q = run.register_buffer(RingBuffer(8, stats))  # 8 chunks in flight
        queues[i] = q

        def work():
            with monitoring.traceme("data_read_shard", file=files[i]):
                try:
                    for chunk in open_chunks(files[i]):
                        if not q.put(chunk):
                            return
                    q.put(_DONE)
                except BaseException as e:  # noqa: BLE001
                    q.put(_Error(e))

        run.spawn(f"{label}_shard{i}", work)

    next_to_start = 0
    for i in range(len(files)):
        if run.cancel.is_set():
            return
        # strict shard order out; parallelism = reading ahead of the
        # consumption point, so the stream matches sequential exactly
        while (next_to_start < len(files)
               and next_to_start < i + max(1, knob.value)):
            start_reader(next_to_start)
            next_to_start += 1
        q = queues.pop(i)
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, _Error):
                raise item.exc
            rec_cell.increase_by(len(item))
            stats.count(len(item))
            yield from item


class _InterleaveSlot:
    """One open inner dataset in the interleave cycle; parallel slots
    prefetch through a puller thread + ring, sequential slots iterate
    inline. Both expose the same next()/close() so the cycle algorithm
    (and therefore the emitted order) is identical."""

    def __init__(self, inner, run, stats, parallel, label, idx):
        self._it = iter(inner)
        self._ring = None
        if parallel and run is not None:
            ring = run.register_buffer(RingBuffer(8, stats))
            it = self._it

            def work():
                try:
                    for v in it:
                        if not ring.put(v):
                            return
                    ring.put(_DONE)
                except BaseException as e:  # noqa: BLE001
                    ring.put(_Error(e))
                finally:
                    _close(it)

            run.spawn(f"{label}_slot{idx}", work)
            self._ring = ring

    def next(self):
        if self._ring is None:
            return next(self._it)
        item = self._ring.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, _Error):
            raise item.exc
        return item

    def close(self):
        if self._ring is not None:
            self._ring.close()
        it = self._it
        self._it = None
        if hasattr(it, "close"):
            try:
                it.close()
            except Exception:
                pass


def _interleave_iter(run: Optional[PipelineRun], node: Node, up,
                     label: str):
    """Deterministic cycle interleave (both modes emit the SAME order):
    round-robin over up to cycle_length open inner datasets taking
    block_length elements per visit; an exhausted slot is removed and a
    fresh inner dataset (from the next input element) joins at the end
    of the cycle. num_parallel_calls only adds per-slot prefetch."""
    map_func, cycle_length, block_length, n = node.args
    stats = StageStats(label) if run is not None else None
    parallel_budget = 0
    knob = None
    if n is not None and run is not None:
        value, lo, hi, autotuned = _resolve(
            n, 2, min(int(cycle_length), pool_size()))
        knob = _Knob(stats, value, lo, hi)
        if autotuned:
            run.register_knob(knob)
        parallel_budget = value
    slots: List[_InterleaveSlot] = []
    upstream_live = True
    opened = [0]

    def refill():
        nonlocal upstream_live
        while upstream_live and len(slots) < cycle_length:
            try:
                x = next(up)
            except StopIteration:
                upstream_live = False
                return
            budget = knob.value if knob is not None else parallel_budget
            par = (n is not None and run is not None
                   and sum(1 for s in slots if s._ring is not None)
                   < budget)
            slots.append(_InterleaveSlot(map_func(x), run, stats, par,
                                         label, opened[0]))
            opened[0] += 1

    idx = 0
    try:
        refill()
        while slots:
            if idx >= len(slots):
                idx = 0
            slot = slots[idx]
            emitted = 0
            exhausted = False
            # no stall timing around slot.next(): a parallel slot's ring
            # already records its blocked-wait into these stats, and a
            # sequential slot's next() is inner-dataset COMPUTE, not
            # stall — timing it here would double-count the former and
            # feed the autotuner a phantom bottleneck for the latter
            while emitted < block_length:
                try:
                    v = slot.next()
                except StopIteration:
                    exhausted = True
                    break
                if stats is not None:
                    stats.count()
                emitted += 1
                yield v
            if exhausted:
                slot.close()
                del slots[idx]
                refill()
            else:
                idx += 1
    finally:
        for s in slots:
            s.close()


# ---------------------------------------------------------------------------
# compile + run
# ---------------------------------------------------------------------------

def build_iterator(node: Node, sequential: bool = False,
                   _count: bool = True):
    """Compile a Dataset chain into an iterator. ``sequential=True``
    forces the pre-engine nested-generator semantics (no threads, no
    metrics) — the reference stream for determinism tests and the
    fallback for externally-driven factories. ``_count=False`` keeps
    internal recompiles (repeat epochs, get_next spec probes) out of
    /stf/data/pipelines_started, which counts LOGICAL iterations."""
    chain = _chain(node)
    parallel = (not sequential) and any(_is_parallel(c) for c in chain)
    if _count:
        _pipelines_started.get_cell(
            "parallel" if parallel else "sequential").increase_by(1)
    run = PipelineRun() if parallel else None
    counts: dict = {}
    it = None
    for c in chain:
        label = f"{c.kind}:{counts.setdefault(c.kind, 0)}"
        counts[c.kind] += 1
        if c.kind == "source":
            it = _source_iter(c)
        elif c.kind == "zip":
            it = _zip_iter(c)
        elif c.kind == "tfrecord":
            it = _tfrecord_iter(run, c, label)
        elif c.kind == "seq":
            it = _seq_iter(c, it)
        elif c.kind == "repeat":
            it = _repeat_iter(run, c, it)
        elif c.kind == "batch":
            it = _batch_iter(c, it)
        elif c.kind == "pmap":
            if run is None or c.args[1] == 1:
                fn = c.args[0]
                it = map(fn, it)
            elif c.args[2]:  # deterministic (ordered)
                it = _pmap_ordered_iter(run, c, it, label)
            else:
                it = _pmap_unordered_iter(run, c, it, label)
        elif c.kind == "interleave":
            it = _interleave_iter(run, c, it, label)
        elif c.kind == "prefetch":
            if run is None:
                pass  # sequential build: prefetch is a no-op pass-through
            else:
                it = _prefetch_iter(run, c, it, label)
        else:
            raise ValueError(f"unknown pipeline stage kind {c.kind!r}")
    if run is None:
        return it
    return PipelineIterator(run, _root_gen(it))


def _root_gen(it):
    """Top-level generator so PipelineIterator.close() can unwind the
    whole fused stage stack with one gen.close()."""
    for x in it:
        yield x
