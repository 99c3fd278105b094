"""The ``stf_ckpt_writer`` background thread; the port of
``simple_tensorflow_tpu/checkpoint/writer.py`` (``PendingCheckpoint``
:31, ``CheckpointWriter`` :56, ``get_writer``, ``wait_until_finished``,
``shutdown_writer`` :184-200).

One process-global daemon thread drains a FIFO of checkpoint-commit
jobs, so async saves from any session commit in submission order (the
``checkpoint`` state file only moves forward) and the step loop's cost
per save is the barrier snapshot plus one queue put. A job's failure is
counted (``/stf/checkpoint/write_errors``) and re-raised to the caller on
its next ``save()`` / ``wait_until_finished()``: an async save never
fails silently.

The thread starts at the first submit; ``shutdown_writer()`` drains the
queue and stops it, and the next submit starts it again. Left out: the
flight recorder's ``checkpoint`` error event and the checked join's
wedge dump (telemetry is not ported).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional

from ..platform import monitoring
from ..platform import sync as _sync
from . import metrics as _m

_THREAD_NAME = "stf_ckpt_writer"


class PendingCheckpoint:
    """Handle of one queued async checkpoint write."""

    __slots__ = ("description", "_done", "error", "result")

    def __init__(self, description: str = ""):
        self.description = description
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        self.result: Any = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Block until the write committed; re-raises its failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"checkpoint write {self.description!r} still pending "
                f"after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class CheckpointWriter:
    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._lock = _sync.Lock("checkpoint/writer_queue",
                                rank=_sync.RANK_QUEUE)
        # submit() against a concurrent stop(): a job queued behind the
        # stop sentinel on a thread about to return would be stranded
        self._lifecycle = _sync.Lock("checkpoint/writer_lifecycle",
                                     rank=_sync.RANK_LIFECYCLE,
                                     blocking_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._idle = threading.Event()
        self._idle.set()

    def submit(self, job: Callable[[], Any],
               description: str = "") -> PendingCheckpoint:
        pending = PendingCheckpoint(description)
        with self._lifecycle:
            with self._lock:
                self._ensure_thread()
                self._idle.clear()
                self._q.put((job, pending))
                _m.pending_writes.get_cell().set(self._q.qsize())
        return pending

    def _ensure_thread(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run,
                                        name=_THREAD_NAME, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                # fail, never strand, anything that slipped in behind the
                # sentinel: every waiter completes, with the error
                while True:
                    try:
                        leftover = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if leftover is not None:
                        _, p = leftover
                        p.error = RuntimeError(
                            "checkpoint writer stopped before this "
                            f"write committed: {p.description!r}")
                        _m.write_errors.get_cell().increase_by(1)
                        p._done.set()
                    self._q.task_done()
                self._q.task_done()
                _m.pending_writes.get_cell().set(0)
                if self._q.unfinished_tasks == 0:
                    self._idle.set()
                return
            job, pending = item
            t0 = time.perf_counter()
            try:
                with monitoring.traceme("checkpoint_write",
                                        what=pending.description):
                    pending.result = job()
            except BaseException as e:  # noqa: BLE001 - surfaced to caller
                pending.error = e
                _m.write_errors.get_cell().increase_by(1)
            finally:
                _m.write_seconds.get_cell().add(time.perf_counter() - t0)
                pending._done.set()
                self._q.task_done()
                with self._lock:
                    _m.pending_writes.get_cell().set(max(0, self._q.qsize()))
                    if self._q.unfinished_tasks == 0:
                        self._idle.set()
                # drop the job now: kept until the next item, its closure
                # would pin the snapshot's device copies while idle
                del job, pending, item

    def wait_until_finished(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job has completed (success or
        failure: each job's error surfaces through its handle). False on
        timeout."""
        return self._idle.wait(timeout)

    def stop(self, timeout: float = 5.0) -> bool:
        """Drain the queued jobs, then stop the thread. Idempotent; the
        next submit() starts it again. Returns False when the thread did
        not end within ``timeout``."""
        with self._lifecycle:
            with self._lock:
                t = self._thread
                if t is None or not t.is_alive():
                    self._thread = None
                    return True
                self._q.put(None)
            t.join(timeout)
            alive = t.is_alive()
            with self._lock:
                if self._thread is t and not alive:
                    self._thread = None
            return not alive

    @property
    def alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()


_WRITER = CheckpointWriter()


def get_writer() -> CheckpointWriter:
    return _WRITER


def wait_until_finished(timeout: Optional[float] = None) -> bool:
    """Drain every pending async checkpoint write of the process."""
    return _WRITER.wait_until_finished(timeout)


def shutdown_writer(timeout: float = 5.0) -> bool:
    return _WRITER.stop(timeout)
