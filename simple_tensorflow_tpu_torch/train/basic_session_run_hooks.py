"""Standard hooks (ref: tensorflow/python/training/
basic_session_run_hooks.py); the port of ``simple_tensorflow_tpu/train/
basic_session_run_hooks.py``: ``SecondOrStepTimer``, ``StopAtStepHook``,
``CheckpointSaverHook`` and ``CheckpointSaverListener``,
``StepCounterHook``, ``LoggingTensorHook``, ``NanTensorHook``,
``SummarySaverHook``, ``GlobalStepWaiterHook``, ``FinalOpsHook`` and
``FeedFnHook``, each with the JAX hook's ``until_next_trigger`` vote and
its behaviour step for step (the window sizes a MonitoredSession picks
and the steps hooks save at are the JAX package's; ``tests/
test_torch_monitored_session.py`` holds them equal).

``CheckpointSaverHook`` saves asynchronously by default, as in JAX
(``save_async=True``: ``checkpoint/manager.py`` ``AsyncSaverEngine``; the
trigger step pays the barrier snapshot and the writer thread commits
while the next window runs); its save at ``end`` waits for every write.

``StepCounterHook.last_perf`` is the JAX hook's MFU report:
``cost_model.predicted_vs_measured`` of the run's fetches at the measured
seconds a step, the static estimate cached by fetches, and None
where the cost model cannot price the fetches.

Differences: a hook closes at ``end`` the ``FileWriter`` it made for its
``output_dir`` (the JAX hooks leave theirs open); ``ProfilerHook`` raises
``NotImplementedError`` until ``RunOptions`` tracing is ported (ROADMAP
Queue 1, front-end item 2).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from . import session_run_hook
from . import training_util

_log = logging.getLogger(__name__)

SessionRunHook = session_run_hook.SessionRunHook
SessionRunArgs = session_run_hook.SessionRunArgs


def _writer_for(writer, output_dir):
    """``(writer, made here)``: the given writer, or a ``FileWriter`` of
    ``output_dir``."""
    if writer is None and output_dir:
        from ..summary.writer.writer import FileWriter

        return FileWriter(output_dir), True
    return writer, False


def _finish_writer(writer, own):
    """At a hook's ``end``: flush a given writer; close one the hook made
    (its file is complete and its thread stops)."""
    if writer is not None:
        writer.close() if own else writer.flush()


class SecondOrStepTimer:
    """(ref: basic_session_run_hooks.py:48)."""

    def __init__(self, every_secs=None, every_steps=None):
        if (every_secs is None) == (every_steps is None):
            raise ValueError("exactly one of every_secs/every_steps required")
        self._every_secs = every_secs
        self._every_steps = every_steps
        self._last_time = None
        self._last_step = None

    def should_trigger_for_step(self, step):
        if self._last_step is None:
            return True
        if step == self._last_step:
            return False
        if self._every_secs is not None:
            return time.time() >= self._last_time + self._every_secs
        return step >= self._last_step + self._every_steps

    def update_last_triggered_step(self, step):
        now = time.time()
        elapsed_secs = None if self._last_time is None \
            else now - self._last_time
        elapsed_steps = None if self._last_step is None \
            else step - self._last_step
        self._last_time, self._last_step = now, step
        return elapsed_secs, elapsed_steps

    def last_triggered_step(self):
        return self._last_step

    @property
    def every_steps(self):
        return self._every_steps

    def steps_until_trigger(self, step):
        """Steps until this timer next fires (the hook's window vote): 1
        when time-based or when it has never fired."""
        if self._every_steps is None or self._last_step is None:
            return 1
        return max(1, self._last_step + self._every_steps - step)


class StopAtStepHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:331)."""

    def __init__(self, num_steps=None, last_step=None):
        if (num_steps is None) == (last_step is None):
            raise ValueError("exactly one of num_steps/last_step required")
        self._num_steps = num_steps
        self._last_step = last_step
        self._global_step_tensor = None

    def begin(self):
        self._global_step_tensor = training_util.get_global_step()
        if self._global_step_tensor is None:
            raise RuntimeError("Global step must be created for "
                               "StopAtStepHook")

    def after_create_session(self, session, coord):
        if self._last_step is None:
            gs = int(np.asarray(session.run(self._global_step_tensor._ref)))
            self._last_step = gs + self._num_steps

    def before_run(self, run_context):
        return SessionRunArgs(self._global_step_tensor._ref)

    def after_run(self, run_context, run_values):
        if int(np.asarray(run_values.results)) >= self._last_step:
            run_context.request_stop()

    def until_next_trigger(self, global_step):
        # a window must not overshoot the stop step
        if self._last_step is None:
            return 1
        return max(1, self._last_step - global_step)


class CheckpointSaverHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:404): a save when the session is
    created, at the timer's triggers and at ``end``. Async by default
    (module docstring); ``save_async=False``, or a Saver of another
    backend, saves in line. Windows split at save steps either way."""

    def __init__(self, checkpoint_dir, save_secs=None, save_steps=None,
                 saver=None, checkpoint_basename="model.ckpt", scaffold=None,
                 listeners=None, save_async=True):
        self._checkpoint_dir = checkpoint_dir
        self._save_path = os.path.join(checkpoint_dir, checkpoint_basename)
        self._saver = saver
        self._scaffold = scaffold
        self._timer = SecondOrStepTimer(every_secs=save_secs,
                                        every_steps=save_steps)
        self._listeners = listeners or []
        self._save_async = save_async
        self._async_engine = None

    def begin(self):
        self._global_step_tensor = training_util.get_global_step()
        if self._global_step_tensor is None:
            raise RuntimeError("Global step required for "
                               "CheckpointSaverHook")
        for lis in self._listeners:
            lis.begin()

    def _get_saver(self):
        if self._saver is not None:
            return self._saver
        if self._scaffold is not None and self._scaffold.saver is not None:
            return self._scaffold.saver
        from .saver import Saver

        self._saver = Saver()
        return self._saver

    def after_create_session(self, session, coord):
        self._save(session, int(np.asarray(
            session.run(self._global_step_tensor._ref))))

    def before_run(self, run_context):
        return SessionRunArgs(self._global_step_tensor._ref)

    def after_run(self, run_context, run_values):
        step = int(np.asarray(run_values.results))
        if self._timer.should_trigger_for_step(step):
            self._timer.update_last_triggered_step(step)
            self._save(run_context.session, step)

    def until_next_trigger(self, global_step):
        # a save inside a window splits the window at the save step
        return self._timer.steps_until_trigger(global_step)

    def end(self, session):
        # the last save waits: the process may exit right after end()
        self._save(session, int(np.asarray(
            session.run(self._global_step_tensor._ref))), blocking=True)

    def _engine_for(self, saver):
        """The async engine of this hook's saver, or None to save through
        ``saver.save`` (``save_async=False``, another backend, or a
        ``backend="async"`` Saver, its own engine)."""
        if not self._save_async or \
                getattr(saver, "_backend", None) != "native":
            return None
        if self._async_engine is None:
            from ..checkpoint.manager import AsyncSaverEngine

            self._async_engine = AsyncSaverEngine(saver)
        return self._async_engine

    def _save(self, session, step, blocking=False):
        for lis in self._listeners:
            lis.before_save(session, step)
        saver = self._get_saver()
        engine = self._engine_for(saver)
        if engine is not None:
            engine.save(session, self._save_path, global_step=step)
            if blocking:
                engine.wait_until_finished()
        else:
            saver.save(session, self._save_path, global_step=step)
            if blocking:
                saver.wait_until_finished()
        for lis in self._listeners:
            lis.after_save(session, step)


class CheckpointSaverListener:
    def begin(self):
        pass

    def before_save(self, session, global_step_value):
        pass

    def after_save(self, session, global_step_value):
        pass

    def end(self, session, global_step_value):
        pass


def _flatten(structure):
    """The leaves of nested lists, tuples and dicts (dicts by sorted
    key)."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure) for x in _flatten(structure[k])]
    if isinstance(structure, (list, tuple)):
        return [x for item in structure for x in _flatten(item)]
    return [structure]


class StepCounterHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:547): steps a second at each
    trigger, logged and written as ``global_step/sec``; ``last_perf``
    the MFU report (module docstring)."""

    def __init__(self, every_n_steps=100, every_n_secs=None, output_dir=None,
                 summary_writer=None, report_mfu=True):
        self._timer = SecondOrStepTimer(every_secs=every_n_secs,
                                        every_steps=every_n_steps
                                        if every_n_secs is None else None)
        self._summary_writer = summary_writer
        self._output_dir = output_dir
        self._report_mfu = report_mfu
        self._own_writer = False
        self._est_cache = None  # (key, CostEstimate): graph walk done once
        self.last_steps_per_sec = None
        self.last_perf = None

    def begin(self):
        self._global_step_tensor = training_util.get_global_step()
        self._summary_writer, self._own_writer = _writer_for(
            self._summary_writer, self._output_dir)

    def before_run(self, run_context):
        return SessionRunArgs(self._global_step_tensor._ref)

    def until_next_trigger(self, global_step):
        # steps are counted from the global_step delta, so a window up to
        # the next report keeps steps/sec exact
        return self._timer.steps_until_trigger(global_step)

    def _perf_report(self, run_context, sec_per_step):
        """Best-effort: the caller's fetches drive the cost model; a
        fetch the model can't cost must never break the training loop."""
        try:
            from ..framework import cost_model
            from ..framework import graph as ops_mod

            items = [f for f in _flatten(run_context.original_args.fetches)
                     if isinstance(f, (ops_mod.Tensor, ops_mod.Operation))
                     or hasattr(f, "_ref")]
            if not items:
                return None
            # the static estimate is a full graph walk: cached per fetches,
            # so every trigger only pays the measured side
            key = tuple(id(i) for i in items)
            if self._est_cache is None or self._est_cache[0] != key:
                self._est_cache = (key, cost_model.estimate(items))
            return cost_model.predicted_vs_measured(
                items, measured_seconds=sec_per_step,
                est=self._est_cache[1])
        except Exception:
            _log.debug("StepCounterHook: no MFU report for these fetches",
                       exc_info=True)
            return None

    def after_run(self, run_context, run_values):
        step = int(np.asarray(run_values.results))
        if not self._timer.should_trigger_for_step(step):
            return
        secs, steps = self._timer.update_last_triggered_step(step)
        if secs is None or secs <= 0:
            return
        self.last_steps_per_sec = steps / secs
        _log.info("global_step/sec: %.4g", self.last_steps_per_sec)
        perf_report = (self._perf_report(run_context, secs / steps)
                       if self._report_mfu else None)
        if perf_report is not None:
            self.last_perf = perf_report
        if self._summary_writer is not None:
            self._summary_writer.add_summary_value(
                "global_step/sec", self.last_steps_per_sec, step)

    def end(self, session):
        _finish_writer(self._summary_writer, self._own_writer)


class LoggingTensorHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:167)."""

    def __init__(self, tensors, every_n_iter=None, every_n_secs=None,
                 at_end=False, formatter=None):
        if isinstance(tensors, dict):
            self._tag_order = list(tensors)
            self._tensors = tensors
        else:
            self._tag_order = [getattr(t, "name", str(i))
                               for i, t in enumerate(tensors)]
            self._tensors = dict(zip(self._tag_order, tensors))
        self._formatter = formatter
        self._timer = SecondOrStepTimer(every_secs=every_n_secs,
                                        every_steps=every_n_iter)
        self._at_end = at_end
        self._iter = 0
        self._should_log = False

    def _log_values(self, vals):
        if self._formatter:
            _log.info(self._formatter(vals))
        else:
            _log.info(", ".join(f"{tag} = {vals[tag]}"
                                for tag in self._tag_order))

    def before_run(self, run_context):
        self._should_log = self._timer.should_trigger_for_step(self._iter)
        if self._should_log:
            return SessionRunArgs(self._tensors)
        return None

    def after_run(self, run_context, run_values):
        if self._should_log:
            self._timer.update_last_triggered_step(self._iter)
            self._log_values(run_values.results)
        self._iter += 1

    def end(self, session):
        if self._at_end:
            self._log_values(session.run(self._tensors))


class NanLossDuringTrainingError(RuntimeError):
    pass


class NanTensorHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:635)."""

    def __init__(self, loss_tensor, fail_on_nan_loss=True):
        self._loss_tensor = loss_tensor
        self._fail = fail_on_nan_loss

    def before_run(self, run_context):
        return SessionRunArgs(self._loss_tensor)

    def after_run(self, run_context, run_values):
        if np.isnan(np.asarray(run_values.results)).any():
            if self._fail:
                raise NanLossDuringTrainingError("NaN loss during training.")
            _log.warning("NaN loss; stopping training.")
            run_context.request_stop()


class SummarySaverHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:683). As the JAX hook: the
    summary op is fetched while the timer has never fired (its first
    run), and later only when ``should_trigger_for_step`` holds for the
    step it last fired at, which it never does; so it writes its first
    summary only, and once ``save_steps`` have passed its vote is 1
    (ROADMAP Queue 3, reference-side facts)."""

    def __init__(self, save_steps=None, save_secs=None, output_dir=None,
                 summary_writer=None, scaffold=None, summary_op=None):
        self._summary_op = summary_op
        self._scaffold = scaffold
        self._output_dir = output_dir
        self._summary_writer = summary_writer
        self._timer = SecondOrStepTimer(every_secs=save_secs,
                                        every_steps=save_steps)
        self._should = False
        self._own_writer = False

    def begin(self):
        self._global_step_tensor = training_util.get_global_step()
        self._summary_writer, self._own_writer = _writer_for(
            self._summary_writer, self._output_dir)

    def _get_op(self):
        if self._summary_op is not None:
            return self._summary_op
        if self._scaffold is not None:
            return self._scaffold.summary_op
        from ..summary import summary as summary_mod

        return summary_mod.merge_all()

    def before_run(self, run_context):
        op = self._get_op()
        last = self._timer.last_triggered_step()
        self._should = (op is not None and
                        self._timer.should_trigger_for_step(last or 0) or
                        last is None)
        fetches = {"step": self._global_step_tensor._ref}
        if self._should and op is not None:
            fetches["summary"] = op
        return SessionRunArgs(fetches)

    def after_run(self, run_context, run_values):
        step = int(np.asarray(run_values.results["step"]))
        if "summary" in run_values.results and self._summary_writer and \
                self._timer.should_trigger_for_step(step):
            self._timer.update_last_triggered_step(step)
            self._summary_writer.add_summary(run_values.results["summary"],
                                             step)

    def until_next_trigger(self, global_step):
        return self._timer.steps_until_trigger(global_step)

    def end(self, session):
        _finish_writer(self._summary_writer, self._own_writer)


class GlobalStepWaiterHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:775)."""

    def __init__(self, wait_until_step):
        self._wait_until_step = wait_until_step

    def begin(self):
        self._global_step_tensor = training_util.get_global_step()

    def until_next_trigger(self, global_step):
        return 1 << 30  # waits before runs; no per-step observation

    def before_run(self, run_context):
        if self._wait_until_step <= 0:
            return None
        while True:
            gs = int(np.asarray(run_context.session.run(
                self._global_step_tensor._ref)))
            if gs >= self._wait_until_step:
                return None
            time.sleep(0.5)


class FinalOpsHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:812)."""

    def __init__(self, final_ops, final_ops_feed_dict=None):
        self._final_ops = final_ops
        self._feed = final_ops_feed_dict
        self.final_ops_values = None

    def until_next_trigger(self, global_step):
        return 1 << 30  # only acts at end()

    def end(self, session):
        if self._final_ops is not None:
            self.final_ops_values = session.run(self._final_ops,
                                                feed_dict=self._feed)


class FeedFnHook(SessionRunHook):
    def __init__(self, feed_fn):
        self._feed_fn = feed_fn

    def before_run(self, run_context):
        return SessionRunArgs(fetches=None, feed_dict=self._feed_fn())


class ProfilerHook(SessionRunHook):
    """(ref: basic_session_run_hooks.py:846): not ported; it traces a run
    through ``RunOptions(trace_level=SOFTWARE_TRACE)``, which the port's
    Session does not have yet (ROADMAP Queue 1, front-end item 2)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ProfilerHook waits for RunOptions tracing in the port's "
            "Session (ROADMAP Queue 1, front-end item 2)")
