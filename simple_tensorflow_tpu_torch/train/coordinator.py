"""``Coordinator`` (ref: tensorflow/python/training/coordinator.py); the
part of ``simple_tensorflow_tpu/train/coordinator.py`` a MonitoredSession
uses: ``request_stop`` and ``should_stop``. Left out: thread
registration, ``join`` and the exception hand-off (the port runs no
queue runners)."""

from __future__ import annotations

import threading


class Coordinator:
    """(ref: coordinator.py:49 ``class Coordinator``)."""

    def __init__(self):
        self._stop_event = threading.Event()

    def request_stop(self, ex=None):
        self._stop_event.set()

    def should_stop(self):
        return self._stop_event.is_set()
