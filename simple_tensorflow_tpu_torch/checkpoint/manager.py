"""``CheckpointManager`` and the async save engine; the port of
``simple_tensorflow_tpu/checkpoint/manager.py`` (``AsyncSaverEngine``
:40, ``CheckpointManager`` :157).

``AsyncSaverEngine`` gives a ``train.Saver`` an async save: the step loop
pays the barrier snapshot (``Session.snapshot_device_state``: device
copies enqueued after the last step, and the host state) and one queue
put; the ``stf_ckpt_writer`` thread copies the snapshot to the host,
serializes and commits it (``snapshot.write_native_checkpoint``: data,
then index, then the ``checkpoint`` state file, each atomic), applies the
Saver's retention, and a failure re-raises on the caller's next
``save()`` or ``wait_until_finished()``. The data file's bytes are a
blocking save's.

``CheckpointManager`` owns a directory: retention (``max_to_keep``,
``keep_checkpoint_every_n_hours``), integrity checks on restore,
``restore_or_initialize`` (the newest checkpoint that verifies, older
ones after a corrupt one, else the initializer), and adoption of the
checkpoints a directory already holds. Left out: the flight recorder's
``checkpoint`` events (telemetry is not ported) and orbax backends.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

from ..framework import errors
from ..platform import monitoring
from ..platform import sync as _sync
from . import metrics as _m
from . import snapshot as snapshot_mod
from . import writer as writer_mod

_log = logging.getLogger(__name__)


class AsyncSaverEngine:
    """The async save path over a ``train.Saver``'s variables and
    retention bookkeeping (the native format)."""

    def __init__(self, saver):
        if getattr(saver, "_backend", "native") not in ("native", "async"):
            raise ValueError(
                "AsyncSaverEngine writes the native stf-bundle format; "
                f"got a backend={saver._backend!r} Saver")
        self._saver = saver
        self._lock = _sync.Lock("checkpoint/manager", rank=_sync.RANK_ENGINE)
        self._pending: List[writer_mod.PendingCheckpoint] = []
        self._unraised_error: Optional[BaseException] = None

    def _collect_errors(self):
        with self._lock:
            done = [p for p in self._pending if p.done]
            self._pending = [p for p in self._pending if not p.done]
            for p in done:
                if p.error is not None and self._unraised_error is None:
                    self._unraised_error = p.error

    def check_error(self):
        """Raise, once, the first failure of an earlier write."""
        self._collect_errors()
        with self._lock:
            err, self._unraised_error = self._unraised_error, None
        if err is not None:
            raise err

    def save(self, sess, save_path, global_step=None, latest_filename=None,
             write_meta_graph=True, write_state=True) -> str:
        """Snapshot, enqueue the write, return the prefix. The saver's
        ``last_save_stats`` gets the step loop's seconds (``"snapshot"``:
        the device copies and host state; ``"put"``: the enqueue;
        ``"stall"``: both); the writer adds ``"d2h"``, ``"serialize"``,
        ``"commit"``, ``"write"`` and ``"bytes"`` when it commits."""
        from ..train import saver as saver_mod

        self.check_error()
        saver = self._saver
        t0 = time.perf_counter()
        step_val = saver_mod.resolve_global_step(sess, global_step)
        prefix = f"{save_path}-{step_val}" if step_val is not None \
            else save_path
        snap = snapshot_mod.capture_training_state(
            sess, saver._vars(sess.graph))
        snap.step = step_val
        graph = sess.graph
        t1 = time.perf_counter()
        stats = {"snapshot": t1 - t0,
                 "snapshot_bytes": snap.nbytes()}

        def job():
            w0 = time.perf_counter()
            arrays = snap.materialize()
            timings = {}
            doc = snapshot_mod.write_native_checkpoint(
                prefix, arrays, snap.tensor_index, snap.host_state, timings)
            # the host file is durable: drop the device copies now
            snap.release_device_state()
            del arrays
            if write_meta_graph:
                saver._write_meta_graph(prefix, graph)
            # the state file last: only a whole checkpoint becomes latest
            saver._manage_old(prefix)
            if write_state:
                saver_mod.update_checkpoint_state(
                    os.path.dirname(prefix) or ".", prefix,
                    [p for p, _ in saver._last_checkpoints],
                    latest_filename)
            stats.update(d2h=snap.timings["d2h"], bytes=doc["data_bytes"],
                         write=time.perf_counter() - w0, **timings)
            _m.saves.get_cell("async").increase_by(1)
            _m.bytes_written.get_cell().increase_by(doc["data_bytes"])
            return prefix

        pending = writer_mod.get_writer().submit(job, description=prefix)
        with self._lock:
            self._pending.append(pending)
        stats["put"] = time.perf_counter() - t1
        stats["stall"] = time.perf_counter() - t0
        saver.last_save_stats = stats
        _m.save_stall_seconds.get_cell("async").add(stats["stall"])
        return prefix

    def wait_until_finished(self, timeout: Optional[float] = None):
        with self._lock:
            pendings = list(self._pending)
        for p in pendings:
            if not p._done.wait(timeout):
                raise TimeoutError(
                    f"checkpoint write {p.description!r} still pending")
        self.check_error()


class CheckpointManager:
    """A directory's checkpoint plane (the JAX package's
    ``docs/CHECKPOINT.md``)."""

    def __init__(self, directory, max_to_keep=5,
                 keep_checkpoint_every_n_hours=10000.0,
                 checkpoint_basename="model.ckpt", saver=None,
                 var_list=None, async_save=True, write_meta_graph=False,
                 latest_filename=None):
        from ..train import saver as saver_mod

        self._directory = str(directory)
        self._latest_filename = latest_filename
        self._write_meta_graph = write_meta_graph
        os.makedirs(self._directory, exist_ok=True)
        if saver is None:
            saver = saver_mod.Saver(
                var_list=var_list, max_to_keep=max_to_keep,
                keep_checkpoint_every_n_hours=keep_checkpoint_every_n_hours)
        self._saver = saver
        # adopt the directory's checkpoints: retention counts them
        st = saver_mod.get_checkpoint_state(self._directory, latest_filename)
        if st is not None and st.all_model_checkpoint_paths:
            self._saver.recover_last_checkpoints(
                st.all_model_checkpoint_paths)
        self._async = bool(async_save) and \
            getattr(saver, "_backend", "native") in ("native", "async")
        self._engine = AsyncSaverEngine(saver) if self._async else None
        self._save_path = os.path.join(self._directory, checkpoint_basename)

    @property
    def directory(self) -> str:
        return self._directory

    @property
    def saver(self):
        return self._saver

    @property
    def latest_checkpoint(self) -> Optional[str]:
        from ..train import saver as saver_mod

        return saver_mod.latest_checkpoint(self._directory,
                                           self._latest_filename)

    @property
    def checkpoints(self) -> List[str]:
        """Every registered checkpoint prefix, oldest first."""
        from ..train import saver as saver_mod

        st = saver_mod.get_checkpoint_state(self._directory,
                                            self._latest_filename)
        return list(st.all_model_checkpoint_paths) if st else []

    def save(self, sess, global_step=None, blocking: Optional[bool] = None
             ) -> str:
        """Checkpoint the session's training state: async by default
        (returns once the barrier snapshot is taken); ``blocking=True``
        (or a manager made with ``async_save=False``) also waits for the
        commit."""
        if self._engine is not None:
            prefix = self._engine.save(
                sess, self._save_path, global_step=global_step,
                latest_filename=self._latest_filename,
                write_meta_graph=self._write_meta_graph)
            if blocking:
                self._engine.wait_until_finished()
            return prefix
        return self._saver.save(
            sess, self._save_path, global_step=global_step,
            latest_filename=self._latest_filename,
            write_meta_graph=self._write_meta_graph)

    def verify(self, checkpoint_path: Optional[str] = None) -> List[str]:
        """The integrity problems of one checkpoint (default: the latest);
        empty when it verifies."""
        path = checkpoint_path or self.latest_checkpoint
        if path is None:
            return [f"{self._directory}: no checkpoint found"]
        return snapshot_mod.verify_checkpoint(path)

    def restore(self, sess, checkpoint_path: Optional[str] = None,
                verify: bool = True) -> str:
        """Restore the training state from ``checkpoint_path`` (default:
        the latest), verified first (``DataLossError``)."""
        from ..train import saver as saver_mod

        path = checkpoint_path or self.latest_checkpoint
        if path is None or not saver_mod.checkpoint_exists(path):
            _m.restores.get_cell("not_found").increase_by(1)
            raise errors.NotFoundError(
                None, None,
                f"No checkpoint found at {path or self._directory}")
        t0 = time.perf_counter()
        with monitoring.traceme("checkpoint_restore", prefix=path):
            if verify:
                problems = snapshot_mod.verify_checkpoint(path)
                if problems:
                    _m.restores.get_cell("verify_failed").increase_by(1)
                    raise errors.DataLossError(
                        None, None,
                        f"Checkpoint {path} failed verification:\n  "
                        + "\n  ".join(problems))
            # verified above, or verification declined: no second hash
            self._saver.restore(sess, path, verify_checksum=False)
        _m.restores.get_cell("ok").increase_by(1)
        _m.restore_seconds.get_cell().add(time.perf_counter() - t0)
        return path

    def restore_or_initialize(self, sess, init_op=None,
                              init_feed_dict=None, init_fn=None,
                              verify: bool = True) -> Optional[str]:
        """Restore the newest checkpoint that verifies (older ones after
        a corrupt one), else run the initializer(s). Returns the restored
        prefix, or None when the session was initialized."""
        seen = set()
        candidates = []
        latest = self.latest_checkpoint
        if latest:
            candidates.append(latest)
            seen.add(latest)
        for p in reversed(self.checkpoints):
            if p not in seen:
                candidates.append(p)
                seen.add(p)
        for path in candidates:
            problems = snapshot_mod.verify_checkpoint(path) if verify \
                else []
            if problems:
                _m.restores.get_cell("verify_failed").increase_by(1)
                _log.warning("CheckpointManager: %s failed verification "
                             "(%s); trying an older checkpoint.", path,
                             "; ".join(problems))
                continue
            try:
                self.restore(sess, path, verify=False)
                return path
            except errors.OpError as e:
                _m.restores.get_cell("error").increase_by(1)
                _log.warning("CheckpointManager: restore of %s failed "
                             "(%s); trying an older checkpoint.", path, e)
        if init_op is not None:
            sess.run(init_op, feed_dict=init_feed_dict)
        if init_fn is not None:
            init_fn(sess)
        return None

    def wait_until_finished(self, timeout: Optional[float] = None):
        """Block until every async save of this manager has committed;
        re-raises the first failure."""
        if self._engine is not None:
            self._engine.wait_until_finished(timeout)

    def close(self):
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # a deferred write error must not mask the exception in flight
        try:
            self.close()
        except Exception:  # noqa: BLE001
            if exc and exc[0] is None:
                raise
        return False
