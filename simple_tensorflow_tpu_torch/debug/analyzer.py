"""Offline reader of dump directories (ref: tensorflow/python/debug/lib/
debug_data.py ``DebugDumpDir``); the part of ``simple_tensorflow_tpu/
debug/analyzer.py`` that reads what ``debug/io_utils.FileSink`` writes
(``run_<n>/<tensor>.npy`` and ``manifest.json``, the numerics plane's
``dump`` mode among them): :class:`DebugDumpDir` lists, queries and
filters the tensors across runs (``find_inf_or_nan`` reads the manifests'
flags, no tensor file). Left out: the command-line front end and
``debug/cli.py``."""

from __future__ import annotations

import fnmatch
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np


class DebugTensorDatum:
    """One dumped tensor (ref: debug_data.py ``DebugTensorDatum``)."""

    def __init__(self, run_dir: str, tensor_name: str, meta: dict):
        self.tensor_name = tensor_name
        self.run_dir = run_dir
        self._file = meta["file"]
        self.flagged_inf_or_nan = bool(meta.get("has_inf_or_nan"))
        self._value = None

    def load_tensor(self) -> np.ndarray:
        """Read the dump from disk WITHOUT caching (predicate sweeps over
        big dump roots must not pin everything in memory)."""
        return np.load(os.path.join(self.run_dir, self._file),
                       allow_pickle=False)

    def get_tensor(self) -> np.ndarray:
        if self._value is None:
            self._value = self.load_tensor()
        return self._value

    @property
    def shape(self):
        return tuple(self.get_tensor().shape)

    @property
    def dtype(self):
        return self.get_tensor().dtype

    def stats(self) -> Dict[str, float]:
        v = np.asarray(self.get_tensor(), np.float64)
        finite = v[np.isfinite(v)] if v.size else v
        return {
            "size": int(v.size),
            "nan": int(np.isnan(v).sum()),
            "inf": int(np.isinf(v).sum()),
            "min": float(finite.min()) if finite.size else float("nan"),
            "max": float(finite.max()) if finite.size else float("nan"),
            "mean": float(finite.mean()) if finite.size else float("nan"),
        }


class DebugDumpDir:
    """All runs under one dump root (ref: debug_data.py:510
    ``DebugDumpDir``)."""

    def __init__(self, dump_root: str):
        if not os.path.isdir(dump_root):
            raise ValueError(f"dump root {dump_root!r} does not exist")
        self.dump_root = dump_root
        self._runs: Dict[int, Dict[str, DebugTensorDatum]] = {}
        for entry in sorted(os.listdir(dump_root)):
            if not entry.startswith("run_"):
                continue
            run_dir = os.path.join(dump_root, entry)
            manifest = os.path.join(run_dir, "manifest.json")
            if not os.path.isfile(manifest):
                continue
            with open(manifest) as f:
                doc = json.load(f)
            try:
                n = int(entry.split("_", 1)[1])
            except ValueError:
                continue  # stray dir (run_backup, run_1_old): not a run
            self._runs[n] = {
                name: DebugTensorDatum(run_dir, name, meta)
                for name, meta in doc.get("tensors", {}).items()}

    @property
    def runs(self) -> List[int]:
        return sorted(self._runs)

    @property
    def size(self) -> int:
        return sum(len(t) for t in self._runs.values())

    def dumped_tensor_names(self, run: Optional[int] = None) -> List[str]:
        if run is not None:
            return sorted(self._runs.get(run, {}))
        names = set()
        for t in self._runs.values():
            names.update(t)
        return sorted(names)

    def watch_key_to_data(self, tensor_name: str,
                          run: Optional[int] = None
                          ) -> List[DebugTensorDatum]:
        """All dumps of one tensor (ordered by run)."""
        runs = [run] if run is not None else self.runs
        return [self._runs[r][tensor_name] for r in runs
                if tensor_name in self._runs.get(r, {})]

    def get_tensor(self, tensor_name: str, run: int) -> np.ndarray:
        return self._runs[run][tensor_name].get_tensor()

    def find(self, predicate: Callable[[str, np.ndarray], bool],
             first_n: int = 0,
             run: Optional[int] = None) -> List[DebugTensorDatum]:
        """Data matching ``predicate(name, value)`` (ref: debug_data.py
        ``DebugDumpDir.find`` — the tensor-filter hook the CLI's
        ``lt -f has_inf_or_nan`` uses). Tensors are loaded WITHOUT the
        per-datum cache — a predicate sweep over a multi-GB dump root
        must not pin the whole set in memory."""
        out = []
        runs = self._select_runs(run)
        for r in runs:
            for name, datum in sorted(self._runs[r].items()):
                if predicate(name, datum.load_tensor()):
                    out.append(datum)
                    if first_n and len(out) >= first_n:
                        return out
        return out

    def find_inf_or_nan(self, first_n: int = 0,
                        run: Optional[int] = None
                        ) -> List[DebugTensorDatum]:
        """Uses the per-tensor flag precomputed in the dump manifests —
        no tensor files are read (a dump root can hold GBs)."""
        out = []
        for r in self._select_runs(run):
            for _, datum in sorted(self._runs[r].items()):
                if datum.flagged_inf_or_nan:
                    out.append(datum)
                    if first_n and len(out) >= first_n:
                        return out
        return out

    def _select_runs(self, run: Optional[int]) -> List[int]:
        if run is None:
            return self.runs
        if run not in self._runs:
            raise ValueError(f"run {run} not in dump root "
                             f"(have {self.runs})")
        return [run]

    def query(self, pattern: str) -> List[str]:
        """Glob over dumped tensor names."""
        return [n for n in self.dumped_tensor_names()
                if fnmatch.fnmatch(n, pattern)]
