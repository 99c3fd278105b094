"""The SessionRunHook protocol (ref: tensorflow/python/training/
session_run_hook.py); the port's copy of ``simple_tensorflow_tpu/train/
session_run_hook.py``, with the ``until_next_trigger`` vote on
``run_steps`` windows."""

from __future__ import annotations

import collections


class SessionRunHook:
    def begin(self):
        pass

    def after_create_session(self, session, coord):
        pass

    def before_run(self, run_context):
        return None

    def after_run(self, run_context, run_values):
        pass

    def end(self, session):
        pass

    def until_next_trigger(self, global_step):
        """How many more steps this hook lets run before it must observe
        a run boundary: a MonitoredSession caps every ``run_steps`` window
        at the least vote, so a hook that triggers at step K observes at
        K. 1 (the default) sees every step; step-periodic hooks return the
        distance to their next trigger; hooks with no per-step needs
        return a large value."""
        return 1


SessionRunArgs = collections.namedtuple(
    "SessionRunArgs", ["fetches", "feed_dict", "options"])
SessionRunArgs.__new__.__defaults__ = (None, None)

SessionRunValues = collections.namedtuple(
    "SessionRunValues", ["results", "options", "run_metadata"])


class SessionRunContext:
    def __init__(self, original_args, session):
        self._original_args = original_args
        self._session = session
        self._stop_requested = False

    @property
    def original_args(self):
        return self._original_args

    @property
    def session(self):
        return self._session

    @property
    def stop_requested(self):
        return self._stop_requested

    def request_stop(self):
        self._stop_requested = True
