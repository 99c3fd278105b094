"""Preemption-safe training: SIGTERM, drain, save, clean stop; the port
of ``simple_tensorflow_tpu/checkpoint/preemption.py``.

1. ``install_preemption_handler()`` puts a chaining handler on SIGTERM
   that only sets a flag (a handler installed before it still runs; a
   process that ignores SIGTERM keeps ignoring it: nothing is installed).
2. The window in flight (a ``run_steps`` window: n replays of the
   captured step) finishes: its end is the consistent state a checkpoint
   needs.
3. ``PreemptionHandler`` (a SessionRunHook) sees the flag at the next
   ``after_run``, saves through the blocking ``Saver`` and requests a
   stop; once the flag is up its fusion vote is 1, so the drain adds at
   most one step.
4. On restart ``MonitoredTrainingSession(checkpoint_dir=...)`` restores
   that checkpoint: variables, optimizer slots, ``global_step`` and the
   RNG run counter.

Left out: the flight recorder's dump and the monitoring counters
(telemetry is not ported), and ``CheckpointManager`` saves.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Optional

from ..train.session_run_hook import SessionRunHook

_log = logging.getLogger(__name__)

# plain attribute writes only: this state is touched from a signal
# handler, which runs on the main thread between two bytecodes; a lock
# taken there can deadlock against the interrupted frame
_requested = False
_requested_at: Optional[float] = None
_reason: Optional[str] = None
_prev_handler = None
_installed = False


def _mark_requested(reason: str) -> bool:
    global _requested, _requested_at, _reason
    if _requested:
        return False
    _requested_at = time.time()
    _reason = reason
    _requested = True  # set last: readers see a fully stamped state
    return True


def preemption_requested() -> bool:
    """Whether a preemption was requested (polled by the drain path)."""
    return _requested


def request_preemption(reason: str = "manual") -> None:
    """Programmatic preemption: the same drain, save and stop, no
    signal."""
    _mark_requested(reason)


def reset_preemption_state() -> None:
    """Clear the request flag (tests; a resumed run in the same
    process)."""
    global _requested, _requested_at, _reason
    _requested = False
    _requested_at = None
    _reason = None


def install_preemption_handler() -> bool:
    """Install the chaining SIGTERM handler (main thread only;
    idempotent). Returns whether a handler is active."""
    global _prev_handler, _installed
    if _installed:
        return True
    try:
        prev = signal.getsignal(signal.SIGTERM)
        if prev is None or prev == signal.SIG_IGN:
            # a C-level handler owns SIGTERM, or the process chose to
            # ignore it: preemption-on-TERM would change that contract
            return False

        def _on_sigterm(signum, frame):
            _mark_requested("sigterm")
            if callable(prev) and prev != signal.SIG_DFL:
                prev(signum, frame)  # a user handler keeps running

        signal.signal(signal.SIGTERM, _on_sigterm)
        _prev_handler = prev
        _installed = True
        return True
    except ValueError:
        return False  # not the main thread


def uninstall_preemption_handler() -> None:
    """Put back the SIGTERM handler that was there before."""
    global _prev_handler, _installed
    if not _installed:
        return
    try:
        signal.signal(signal.SIGTERM, _prev_handler)
    except (ValueError, TypeError):
        pass
    _prev_handler = None
    _installed = False


class PreemptionHandler(SessionRunHook):
    """The hook half of the flow (also appended by
    ``MonitoredTrainingSession(checkpoint_dir=...)``). Saves through an
    explicit ``saver``, the scaffold's, the graph's first, else a new
    ``train.Saver``, always blocking, to
    ``checkpoint_dir/checkpoint_basename-<global_step>``."""

    def __init__(self, checkpoint_dir=None, manager=None, saver=None,
                 scaffold=None, checkpoint_basename="model.ckpt",
                 install: bool = True):
        if manager is not None:
            raise NotImplementedError(
                "PreemptionHandler(manager=...): CheckpointManager is not "
                "ported (ROADMAP Queue 1 item 10); pass checkpoint_dir")
        if checkpoint_dir is None:
            raise ValueError("PreemptionHandler needs a checkpoint_dir")
        self._checkpoint_dir = checkpoint_dir
        self._saver = saver
        self._scaffold = scaffold
        self._basename = checkpoint_basename
        self._install = install
        self._installed_here = False
        self._saved = False
        self.last_saved_prefix: Optional[str] = None

    def begin(self):
        from ..train import training_util

        self._global_step_tensor = training_util.get_global_step()
        if self._install:
            self._installed_here = install_preemption_handler()

    def until_next_trigger(self, global_step):
        # once preemption is requested, stop fusing: drain in at most one
        # more step, then save at its end
        return 1 if preemption_requested() else (1 << 30)

    def after_run(self, run_context, run_values):
        if not preemption_requested() or self._saved:
            return
        self._drain_and_save(run_context.session)
        run_context.request_stop()

    def end(self, session):
        if preemption_requested() and not self._saved:
            # the loop ended (e.g. StopAtStepHook) before a post-signal
            # run: persist the final state all the same
            self._drain_and_save(session)
        if self._installed_here:
            uninstall_preemption_handler()
            self._installed_here = False

    def _drain_and_save(self, session):
        from ..train.saver import resolve_global_step

        self._saved = True
        step = resolve_global_step(session, self._global_step_tensor)
        prefix = self._resolve_saver().save(
            session, os.path.join(self._checkpoint_dir, self._basename),
            global_step=step)
        self.last_saved_prefix = prefix
        _log.info("PreemptionHandler: drained and saved %s at "
                  "global_step=%s; requesting stop.", prefix, step)

    def _resolve_saver(self):
        if self._saver is not None:
            return self._saver
        if self._scaffold is not None and \
                getattr(self._scaffold, "saver", None) is not None:
            return self._scaffold.saver
        from ..framework import graph as ops_mod
        from ..train.saver import Saver

        savers = ops_mod.get_default_graph().get_collection(
            ops_mod.GraphKeys.SAVERS)
        self._saver = savers[0] if savers else Saver()
        return self._saver
