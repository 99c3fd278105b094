"""Event-file writer (ref: tensorflow/core/util/events_writer.cc,
python/summary/writer/writer.py); the port of ``simple_tensorflow_tpu/
summary/writer/writer.py``.

Writes TensorBoard-compatible event files: TFRecord-framed protobuf-wire
Event messages (wall_time=1 double, step=2 int64, file_version=3,
summary=5), drained from a queue by a background thread, as the
reference's EventFileWriter. Left out: ``add_graph`` (it writes nothing
until ``graph_io`` is ported), ``add_run_metadata`` (``RunOptions``
tracing) and ``FileWriterCache``.
"""

from __future__ import annotations

import os
import queue
import socket
import threading
import time

from ...lib.io.tf_record import TFRecordWriter
from ...lib.proto import Writer as ProtoWriter


def encode_event(wall_time, step=None, file_version=None,
                 summary_bytes=None) -> bytes:
    """One serialized Event."""
    w = ProtoWriter()
    w.double_always(1, wall_time)
    if step:
        w.varint(2, step)
    if file_version:
        w.bytes_(3, file_version)
    if summary_bytes:
        w.bytes_(5, summary_bytes)
    return w.tobytes()


class EventsWriter:
    """(ref: core/util/events_writer.cc): ``<prefix>.out.tfevents.<time>.
    <host>``, opened with the ``brain.Event:2`` version record. A name
    taken already (two writers of one directory opened within a second:
    ``MonitoredTrainingSession``'s step counter and summary hooks) gets a
    ``.<k>`` suffix; the JAX writer opens the same file twice, so one
    writer's records overwrite the other's."""

    def __init__(self, file_prefix):
        base = (f"{file_prefix}.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self._filename, k = base, 0
        while os.path.exists(self._filename):
            k += 1
            self._filename = f"{base}.{k}"
        os.makedirs(os.path.dirname(self._filename) or ".", exist_ok=True)
        self._writer = TFRecordWriter(self._filename)
        self._writer.write(encode_event(time.time(),
                                        file_version="brain.Event:2"))

    @property
    def filename(self):
        return self._filename

    def write_event(self, event_bytes):
        self._writer.write(event_bytes)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


class FileWriter:
    """(ref: python/summary/writer/writer.py:268 ``class FileWriter``)."""

    _SENTINEL = object()

    def __init__(self, logdir, graph=None, max_queue=10, flush_secs=120,
                 filename_suffix=None, session=None):
        self._logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._events_writer = EventsWriter(os.path.join(logdir, "events"))
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._flush_secs = flush_secs
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="stf_summary_writer")
        self._worker.start()

    def get_logdir(self):
        return self._logdir

    def _run(self):
        last_flush = time.time()
        while True:
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                item = None
            if item is self._SENTINEL:
                self._events_writer.flush()
                return
            if item is not None:
                try:
                    self._events_writer.write_event(item)
                finally:
                    self._queue.task_done()
            if time.time() - last_flush > self._flush_secs:
                self._events_writer.flush()
                last_flush = time.time()

    def add_event(self, event_bytes):
        if not self._closed:
            self._queue.put(event_bytes)

    def add_summary(self, summary, global_step=None):
        """(ref: writer.py:92 ``add_summary``). ``summary``: the bytes a
        summary op fetched."""
        if summary is None:
            return
        if hasattr(summary, "tobytes"):
            summary = summary.tobytes()
        if isinstance(summary, str):
            summary = summary.encode("latin-1")
        self.add_event(encode_event(time.time(), step=int(global_step or 0),
                                    summary_bytes=bytes(summary)))

    def add_summary_value(self, tag, value, global_step=None):
        """One scalar written directly (``StepCounterHook``)."""
        v = ProtoWriter()
        v.bytes_(1, tag)
        v.float32_always(2, float(value))
        s = ProtoWriter()
        s.message(1, v)
        self.add_event(encode_event(time.time(), step=int(global_step or 0),
                                    summary_bytes=s.tobytes()))

    def add_graph(self, graph, global_step=None):
        """Nothing is written: GraphDef serialization (``graph_io``) is
        not ported."""

    def add_session_log(self, session_log, global_step=None):
        pass

    def flush(self):
        """Wait until the queue is written, then flush the file."""
        if not self._closed:
            self._queue.join()
        self._events_writer.flush()

    def close(self):
        if not self._closed:
            self._closed = True
            self._queue.put(self._SENTINEL)
            self._worker.join()
            self._events_writer.close()

    def reopen(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
