"""``Saver``: checkpoint save and restore (ref: tensorflow/python/training/
saver.py); the port of ``simple_tensorflow_tpu/train/saver.py`` with its
native backend.

The format is the JAX package's stf-bundle (``checkpoint/snapshot.py``):
``<prefix>.stfz`` and ``<prefix>.index.json`` (version 2: sha256 of the
data file, its size, the host state), and the ``checkpoint`` state file
(JSON) behind ``latest_checkpoint`` and ``max_to_keep``. Either package
reads the other's checkpoints: the same keys (the variables' store names,
the optimizer's flat slots ``Adam/Adam/fused_m_g0`` ... included), the
same dtypes (64-bit variables narrowed, bf16 as raw 2-byte values), the
same host state (``rng_run_counter``, and ``iterators``, the positions
of the graph's data iterators, when it has any).

With no ``var_list``, a Saver saves and restores the global variables of
the session's graph (the JAX saver takes the default graph's: the same
graph whenever the session's graph is the default one).

A save only reads the store (``VariableStore.version`` stays, so a
captured step stays valid); a restore copies into a live session's
tensors in place where shape and dtype match (addresses stay), and loads
new entries otherwise. A checkpoint whose data file does not match its
recorded checksum raises ``DataLossError`` before anything is loaded.

``backend="async"`` saves through the async plane
(``checkpoint/manager.py`` ``AsyncSaverEngine``): ``save`` returns once
the barrier snapshot is taken and the ``stf_ckpt_writer`` thread commits
the same bytes a blocking save writes; ``wait_until_finished`` waits for
the writes and re-raises the first failure. ``save`` writes the graph's
meta graph beside the checkpoint (``<prefix>.meta``, the JAX package's
JSON format, ``framework/graph_io.py``) unless ``write_meta_graph`` is
False; ``import_meta_graph`` and ``export_meta_graph`` read and write
one. A graph's meta graph can be gigabytes (its constants: the flat Adam
slots' zero initial values), so a Saver whose graph has not changed
since its last ``.meta`` links the new one to that file (a copy where
links fail): the same bytes, written once. Not ported:
``backend="orbax"`` (sharded saves, ROADMAP Queue 1 item 11) raises
``NotImplementedError``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from ..checkpoint import atomic as atomic_io
from ..checkpoint import metrics as ckpt_metrics
from ..checkpoint import snapshot as snapshot_mod
from ..framework import errors
from ..framework import graph as ops_mod

_log = logging.getLogger(__name__)


class CheckpointState:
    def __init__(self, model_checkpoint_path="",
                 all_model_checkpoint_paths=None):
        self.model_checkpoint_path = model_checkpoint_path
        self.all_model_checkpoint_paths = all_model_checkpoint_paths or []


def _state_path(directory, latest_filename=None):
    return os.path.join(directory, latest_filename or "checkpoint")


def update_checkpoint_state(save_dir, model_checkpoint_path,
                            all_model_checkpoint_paths=None,
                            latest_filename=None):
    """(ref: saver.py ``update_checkpoint_state``), committed atomically:
    the state file is the pointer that makes a checkpoint "latest"."""
    state = {
        "model_checkpoint_path": model_checkpoint_path,
        "all_model_checkpoint_paths": all_model_checkpoint_paths or
        [model_checkpoint_path],
    }
    atomic_io.atomic_write_json(_state_path(save_dir, latest_filename),
                                state, label="state")


def get_checkpoint_state(checkpoint_dir, latest_filename=None):
    path = _state_path(checkpoint_dir, latest_filename)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return CheckpointState(d.get("model_checkpoint_path", ""),
                           d.get("all_model_checkpoint_paths", []))


def checkpoint_exists(checkpoint_prefix):
    return os.path.exists(checkpoint_prefix + ".stfz")


def latest_checkpoint(checkpoint_dir, latest_filename=None):
    """(ref: saver.py:1612 ``latest_checkpoint``)."""
    st = get_checkpoint_state(checkpoint_dir, latest_filename)
    if st and st.model_checkpoint_path and \
            checkpoint_exists(st.model_checkpoint_path):
        return st.model_checkpoint_path
    return None


def _prefix(checkpoint_prefix):
    return (checkpoint_prefix[:-len(".stfz")]
            if checkpoint_prefix.endswith(".stfz") else checkpoint_prefix)


def load_checkpoint_values(checkpoint_prefix) -> Dict[str, np.ndarray]:
    """``{variable name: ndarray}`` of a checkpoint (npz keys with ``|``
    for ``/``); bf16 values come back as their raw 2-byte entries
    (``V2``), exactly as stored."""
    prefix = _prefix(checkpoint_prefix)
    try:
        snapshot_mod._refuse_sharded(
            snapshot_mod.read_index(prefix).get("tensors", {}))
    except (OSError, json.JSONDecodeError):
        pass  # no index: every entry is a whole tensor
    with np.load(prefix + ".stfz", allow_pickle=False) as data:
        return {k.replace("|", "/"): data[k] for k in data.files}


def resolve_global_step(sess, global_step):
    """The integer a checkpoint prefix is suffixed with: an int passes
    through, a Variable or Tensor is read (from the store when it can
    be: no run), None stays None."""
    if global_step is None:
        return None
    if isinstance(global_step, (int, np.integer)):
        return int(global_step)
    try:
        return int(sess.variable_value(global_step).item())
    except (KeyError, AttributeError):
        pass
    target = global_step._ref if hasattr(global_step, "_ref") \
        else global_step
    return int(np.asarray(sess.run(target)))


def _iter_ordinal(name):
    """Creation ordinal of an auto-named iterator ('dataset_iterator_7'
    -> 7); unparseable names sort last, stably."""
    tail = name.rsplit("_", 1)[-1]
    return (0, int(tail)) if tail.isdigit() else (1, 0)


def _restore_host_state(sess, host_state):
    """The session's RNG run counter and its graph's data iterator
    positions from a checkpoint's host state (the JAX package's
    :151-187), so a resumed run draws the same dropout masks and the
    same batches. Iterator names come from a process-wide counter: when
    a saved name is missing and the counts match, saved and live
    iterators are paired by creation order; a saved iterator with no live
    one is skipped."""
    if not host_state:
        return
    if "rng_run_counter" in host_state:
        sess._run_counter = int(host_state["rng_run_counter"])
    iterators = host_state.get("iterators") or {}
    if not iterators:
        return
    from ..data import dataset as dataset_mod

    reg = dataset_mod.iterator_registry(sess.graph)
    mapping = {}
    if any(n not in reg for n in iterators) and len(iterators) == len(reg):
        saved = sorted(iterators, key=_iter_ordinal)
        live = sorted(reg, key=_iter_ordinal)
        mapping = dict(zip(saved, live))
        if any(a != b for a, b in mapping.items()):
            _log.info("Saver.restore: aligning %d data iterator(s) by "
                      "creation order (checkpoint names %s -> live names "
                      "%s)", len(mapping), saved, live)
    for name, st in iterators.items():
        # an alignment, when made, is used alone: a mix of exact and
        # mapped lookups could pair one live iterator with two states
        it = reg.get(mapping[name]) if mapping else reg.get(name)
        if it is not None:
            it.restore_state(st)


class Saver:
    """(ref: python/training/saver.py:1040 ``class Saver``)."""

    def __init__(self, var_list=None, reshape=False, sharded=False,
                 max_to_keep=5, keep_checkpoint_every_n_hours=10000.0,
                 name=None, restore_sequentially=False, saver_def=None,
                 builder=None, defer_build=False, allow_empty=False,
                 write_version=2, pad_step_number=False, backend="native"):
        if backend == "orbax":
            raise NotImplementedError(
                "Saver(backend='orbax') is not ported (sharded saves, "
                "ROADMAP Queue 1 item 11); use backend='native' or 'async'")
        if backend not in ("native", "async"):
            raise ValueError(f"Unknown Saver backend {backend!r}")
        self._var_list = var_list
        self._max_to_keep = max_to_keep
        self._keep_every_s = keep_checkpoint_every_n_hours * 3600.0
        self._backend = backend
        self._async_engine = None
        # (the graph's signature, the .meta file) of the last meta graph
        # written: an unchanged graph's next .meta is a link to it
        self._last_meta = None
        # (prefix, save time): keep_checkpoint_every_n_hours decides on the
        # checkpoint's own timestamp, as the reference does
        self._last_checkpoints: List[tuple] = []
        self._next_keep_time = time.time() + self._keep_every_s
        # seconds and bytes of the last save. Blocking: d2h, serialize,
        # commit, bytes (the data file), seconds (the whole save). Async:
        # the step loop's snapshot, put and stall, then, once the writer
        # committed, its d2h, serialize, commit, write and bytes
        self.last_save_stats: Dict[str, float] = {}
        ops_mod.get_default_graph().add_to_collection(
            ops_mod.GraphKeys.SAVERS, self)

    def _vars(self, graph):
        """``{checkpoint key: Variable}``: ``var_list``, else the global
        variables and saveables of ``graph`` (the session's; the JAX saver
        reads the default graph's, the same graph whenever the session's
        graph is the default one)."""
        vl = self._var_list
        if vl is None:
            vl = (graph.get_collection(ops_mod.GraphKeys.GLOBAL_VARIABLES) +
                  graph.get_collection(ops_mod.GraphKeys.SAVEABLE_OBJECTS))
        if isinstance(vl, dict):
            return dict(vl)
        return {(v.var_name if hasattr(v, "var_name") else v.name): v
                for v in vl}

    # -- save ----------------------------------------------------------------
    def save(self, sess, save_path, global_step=None, latest_filename=None,
             meta_graph_suffix="meta", write_meta_graph=True,
             write_state=True):
        """(ref: saver.py:1453 ``Saver.save``): read every variable from
        the store (no run, no version move), serialize, commit; returns
        the prefix ``save_path[-step]``. ``backend="async"`` returns once
        the barrier snapshot is taken (module docstring)."""
        if self._backend == "async":
            if self._async_engine is None:
                from ..checkpoint.manager import AsyncSaverEngine

                self._async_engine = AsyncSaverEngine(self)
            return self._async_engine.save(
                sess, save_path, global_step=global_step,
                latest_filename=latest_filename,
                write_meta_graph=write_meta_graph, write_state=write_state)
        t0 = time.perf_counter()
        step_val = resolve_global_step(sess, global_step)
        prefix = f"{save_path}-{step_val}" if step_val is not None \
            else save_path
        store = sess._variable_store
        index, arrays = {}, {}
        for key, v in self._vars(sess.graph).items():
            name = v.var_name if hasattr(v, "var_name") else key
            if name not in store.values:
                raise errors.FailedPreconditionError(
                    None, None,
                    f"Variable {name} is uninitialized; cannot save.")
            t = store.values[name]
            arrays[key] = snapshot_mod.host_array(t)
            index[key] = {"dtype": snapshot_mod.dtype_name(t),
                          "shape": list(t.shape), "store_name": name,
                          "sharding": None}
        host_state = sess.snapshot_host_state()
        stats = {"d2h": time.perf_counter() - t0}
        doc = snapshot_mod.write_native_checkpoint(prefix, arrays, index,
                                                   host_state, stats)
        stats["bytes"] = doc["data_bytes"]
        if write_meta_graph:
            self._write_meta_graph(prefix, sess.graph, meta_graph_suffix)
        self._manage_old(prefix)
        if write_state:
            update_checkpoint_state(os.path.dirname(prefix) or ".", prefix,
                                    [p for p, _ in self._last_checkpoints],
                                    latest_filename)
        stats["seconds"] = time.perf_counter() - t0
        self.last_save_stats = stats
        ckpt_metrics.saves.get_cell("blocking").increase_by(1)
        ckpt_metrics.save_stall_seconds.get_cell("blocking").add(
            stats["seconds"])
        ckpt_metrics.bytes_written.get_cell().increase_by(stats["bytes"])
        return prefix

    def _write_meta_graph(self, prefix, graph, suffix="meta"):
        """``graph``'s meta graph as ``<prefix>.<suffix>``; a link to the
        last one this Saver wrote when the graph is unchanged since (the
        graph is append-only: its op count and collection sizes say).
        The checkpoint's tensors are saved already: a graph that does not
        serialize is logged, as in the JAX package
        (``train/saver.py:299-310``)."""
        from ..framework import graph_io

        path = f"{prefix}.{suffix}"
        sig = (id(graph), len(graph.get_operations()),
               tuple(sorted((k, len(v))
                            for k, v in graph._collections.items())))
        try:
            if os.path.lexists(path):
                os.remove(path)
            last = self._last_meta
            if last is not None and last[0] == sig and \
                    os.path.exists(last[1]):
                try:
                    os.link(last[1], path)
                except OSError:
                    shutil.copyfile(last[1], path)
            else:
                graph_io.export_meta_graph(path, graph=graph)
            self._last_meta = (sig, path)
        except (OSError, TypeError, ValueError) as e:
            _log.warning("Saver: meta-graph export to %s failed (%s); "
                         "checkpoint tensors were saved.", path, e)

    def _manage_old(self, new_prefix):
        self._last_checkpoints.append((new_prefix, time.time()))
        while (self._max_to_keep and
               len(self._last_checkpoints) > self._max_to_keep):
            old, saved_at = self._last_checkpoints.pop(0)
            if saved_at > self._next_keep_time:
                # kept for good: the checkpoint's own save time crossed the
                # keep interval, which then moves on by one interval
                self._next_keep_time += self._keep_every_s
                continue
            for suffix in (".stfz", ".index.json", ".meta"):
                try:
                    os.remove(old + suffix)
                except OSError:
                    pass
            if os.path.isdir(old + ".orbax"):
                shutil.rmtree(old + ".orbax", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, sess, save_path, verify_checksum=True):
        """(ref: saver.py:1560 ``Saver.restore``): verify the data file
        against its recorded checksum (``DataLossError``), load every
        variable into the store (in place where it exists) and the
        session's RNG run counter."""
        if not checkpoint_exists(save_path):
            raise errors.NotFoundError(
                None, None, f"Checkpoint {save_path} not found")
        idx_doc = snapshot_mod.read_index(save_path)
        index = idx_doc["tensors"]
        snapshot_mod._refuse_sharded(index)
        with open(save_path + ".stfz", "rb") as f:
            payload = f.read()
        expected = idx_doc.get("checksum") if verify_checksum else None
        if expected is not None:
            actual = atomic_io.checksum_bytes(payload)
            if actual != expected:
                raise errors.DataLossError(
                    None, None,
                    f"Checkpoint {save_path}.stfz is corrupt: checksum "
                    f"{actual} != recorded {expected}")
        store = sess._variable_store
        with np.load(io.BytesIO(payload), allow_pickle=False) as data:
            for key, v in self._vars(sess.graph).items():
                safe = snapshot_mod.npz_key(key)
                if safe not in data.files:
                    raise errors.NotFoundError(
                        None, None,
                        f"Key {key} not found in checkpoint {save_path}")
                value = snapshot_mod.tensor_from_entry(
                    data[safe], (index.get(key) or {}).get("dtype"))
                name = v.var_name if hasattr(v, "var_name") else key
                _load_in_place(store, name, value,
                               v if hasattr(v, "dtype") else None)
        _restore_host_state(sess, idx_doc.get("host_state"))

    @property
    def last_checkpoints(self):
        return [p for p, _ in self._last_checkpoints]

    def set_last_checkpoints_with_time(self, pairs):
        self._last_checkpoints = [(p, t) for p, t in pairs]

    def recover_last_checkpoints(self, checkpoint_paths):
        self._last_checkpoints = [(p, time.time())
                                  for p in checkpoint_paths
                                  if checkpoint_exists(p)]

    def wait_until_finished(self, timeout=None):
        """Block until every async save of this Saver has committed (a
        blocking save has when ``save`` returns); re-raises the first
        failure of a background write."""
        if self._async_engine is not None:
            self._async_engine.wait_until_finished(timeout)

    def as_saver_def(self):
        return {"format": "stf-bundle-v1"}

    def to_proto(self, export_scope=None):
        return self.as_saver_def()

    @staticmethod
    def from_proto(saver_def, import_scope=None):
        return Saver()


def import_meta_graph(meta_graph_or_file, clear_devices=False,
                      import_scope=None, **kwargs):
    """(ref: saver.py ``import_meta_graph``): rebuild a meta graph's
    nodes, collections and variables into the default graph; returns a
    ``Saver`` over the rebuilt variables."""
    from ..framework import graph_io

    graph_io.import_meta_graph(meta_graph_or_file,
                               import_scope=import_scope)
    return Saver()


def export_meta_graph(filename=None, meta_info_def=None, graph_def=None,
                      saver_def=None, collection_list=None, as_text=False,
                      graph=None, **kwargs):
    """(ref: saver.py ``export_meta_graph``)."""
    from ..framework import graph_io

    return graph_io.export_meta_graph(filename, graph=graph,
                                      collection_list=collection_list)


def _load_in_place(store, name, value: torch.Tensor, variable):
    """``value`` into the store entry ``name``: copied into the existing
    tensor when its shape and dtype match (its address, and so a captured
    step, stays), else loaded as a new entry."""
    if variable is not None:
        value = value.to(variable.dtype.base_dtype.torch_dtype)
    cur = store.values.get(name)
    if cur is not None and tuple(cur.shape) == tuple(value.shape) and \
            cur.dtype == value.dtype:
        cur.copy_(value.to(cur.device))
    else:
        store.load(name, value, variable)
