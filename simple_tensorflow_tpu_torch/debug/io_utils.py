"""Debug tensor sinks; the part of ``simple_tensorflow_tpu/debug/
io_utils.py`` that writes a dump directory: :class:`FileSink`, one
``run_<n>/`` subdirectory per run with a ``.npy`` file per tensor and a
``manifest.json`` (the layout ``debug/analyzer.py`` reads). Left out: the
``tcp://`` ``SocketSink``, ``DebugListener`` and ``sink_for_url``."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np


class DebugSink:
    """Publish interface (ref: debug_io_utils.h
    ``DebugIO::PublishDebugTensor``)."""

    def publish(self, run_index: int, name: str, value, **meta) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileSink(DebugSink):
    def __init__(self, root: str):
        self._root = root
        os.makedirs(root, exist_ok=True)
        self._manifests: Dict[int, Dict[str, Any]] = {}

    def publish(self, run_index, name, value, **meta):
        """Write ``value`` as ``run_<run_index>/<name>.npy`` (``/`` and
        ``:`` as ``_``) and record it, with ``meta``, in the run's
        manifest."""
        run_dir = os.path.join(self._root, f"run_{run_index}")
        os.makedirs(run_dir, exist_ok=True)
        safe = name.replace("/", "_").replace(":", "_")
        np.save(os.path.join(run_dir, safe + ".npy"), np.asarray(value))
        man = self._manifests.setdefault(run_index, {})
        man[name] = {"file": safe + ".npy", **meta}
        with open(os.path.join(run_dir, "manifest.json"), "w") as f:
            json.dump({"time": time.time(), "tensors": man}, f, indent=1)


def publish_debug_tensor(sinks, run_index: int, name: str, value) -> None:
    for s in sinks:
        s.publish(run_index, name, value)
