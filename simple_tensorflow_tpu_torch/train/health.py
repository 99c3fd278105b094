"""stf.train.health: the training side of the numerics-health plane
(``debug/numerics.py``); the port of ``simple_tensorflow_tpu/train/
health.py``.

The plane itself lives in the Session: a training-shaped plan is
instrumented with one ``NumericSummary`` launch over its taps whenever the
resolved mode is not "off", ``run_steps`` windows included. This module
adds :class:`NumericsHealthHook`, a periodic log line (global gradient
norm, update ratio, nonfinite taps) read from the process
:class:`~..debug.numerics.HealthPlane` and a summary at ``end``.
``MonitoredTrainingSession`` adds one when the resolved mode
(``ConfigProto(numerics=)`` > the process default > ``STF_NUMERICS``) is
not "off" and the caller passed none.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Any, Callable, Dict, Optional

from .session_run_hook import SessionRunHook

_log = logging.getLogger(__name__)
_NUMERICS = __name__.rsplit(".", 2)[0] + ".debug.numerics"


def resolved_mode(config=None) -> str:
    """The numerics mode a Session built with ``config`` runs under. When
    ``debug.numerics`` was never imported, ``STF_NUMERICS`` alone decides
    (the module reads the same variable), so a job with the plane off
    never imports it."""
    mode = getattr(config, "numerics", None) if config is not None \
        else None
    if mode is not None:
        return mode
    mod = sys.modules.get(_NUMERICS)
    if mod is not None:
        return mod.get_numerics_mode()
    env = os.environ.get("STF_NUMERICS", "").strip().lower()
    return env if env in ("metrics", "raise", "dump") else "off"


class NumericsHealthHook(SessionRunHook):
    """Log the plane's view of training every ``every_n_steps`` observed
    steps (the plane's steps: a window advances several at once), and a
    recap at ``end``. It only reads the plane and never splits a window
    (``until_next_trigger``)."""

    def __init__(self, every_n_steps: int = 100,
                 log_fn: Optional[Callable[[str], None]] = None):
        if every_n_steps < 1:
            raise ValueError(
                f"every_n_steps must be >= 1, got {every_n_steps}")
        self._every_n = int(every_n_steps)
        self._log_fn = log_fn
        self._last_logged = 0

    def _log(self, msg: str) -> None:
        if self._log_fn is not None:
            self._log_fn(msg)
        else:
            _log.info("%s", msg)

    @staticmethod
    def _plane_info() -> Dict[str, Any]:
        from ..debug import numerics as numerics_mod

        return numerics_mod.get_plane().info()

    def begin(self):
        self._last_logged = int(self._plane_info()["steps_observed"])

    @staticmethod
    def _format_entry(entry: Dict[str, Any]) -> str:
        parts = [f"numerics health @ step {entry['step']}"]
        if entry.get("grad_norm") is not None:
            parts.append(f"grad_norm={entry['grad_norm']:.6g}")
        if entry.get("update_ratio") is not None:
            parts.append(f"update_ratio={entry['update_ratio']:.6g}")
        parts.append(f"max_abs={entry['max_abs']:.6g}")
        if entry.get("nonfinite_taps"):
            parts.append(f"NONFINITE_TAPS={entry['nonfinite_taps']}")
        return " ".join(parts)

    def after_run(self, run_context, run_values):
        info = self._plane_info()
        steps = int(info["steps_observed"])
        if steps - self._last_logged < self._every_n or \
                not info["history"]:
            return
        self._last_logged = steps
        self._log(self._format_entry(info["history"][-1]))

    def end(self, session):
        info = self._plane_info()
        msg = (f"numerics health: observed {info['steps_observed']} "
               f"steps, {info['anomalies']} anomalies, "
               f"{len(info['taps'])} taps, mode={info['mode']}")
        last = info.get("last_anomaly")
        if last:
            msg += (f"; last anomaly at step {last['step']} "
                    f"({len(last['taps'])} taps)")
            if last.get("dump_root"):
                msg += f", dump at {last['dump_root']}"
        self._log(msg)

    def until_next_trigger(self, global_step):
        # the plane observes inside the window: never split one for it
        return 1 << 30
