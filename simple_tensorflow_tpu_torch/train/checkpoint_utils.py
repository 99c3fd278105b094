"""Checkpoint inspection (ref: tensorflow/python/training/
checkpoint_utils.py); the port of ``simple_tensorflow_tpu/train/
checkpoint_utils.py``: ``CheckpointReader``, ``load_checkpoint``,
``load_variable``, ``list_variables``. bf16 values read as their raw
2-byte entries, as ``saver.load_checkpoint_values``. Left out:
``init_from_checkpoint``."""

from __future__ import annotations

import numpy as np

from ..framework import errors
from . import saver as saver_mod


class CheckpointReader:
    """(ref: tensorflow/c/checkpoint_reader.cc)."""

    def __init__(self, prefix):
        if not saver_mod.checkpoint_exists(prefix):
            raise errors.NotFoundError(None, None,
                                       f"Checkpoint {prefix} not found")
        self._prefix = prefix
        from ..checkpoint.snapshot import read_index

        self._index = read_index(prefix)["tensors"]

    def get_variable_to_shape_map(self):
        return {k: list(v["shape"]) for k, v in self._index.items()}

    def get_variable_to_dtype_map(self):
        return {k: v["dtype"] for k, v in self._index.items()}

    def has_tensor(self, name):
        return name in self._index

    def get_tensor(self, name):
        with np.load(self._prefix + ".stfz") as data:
            return data[name.replace("/", "|")]


def load_checkpoint(ckpt_dir_or_file):
    path = ckpt_dir_or_file
    if not saver_mod.checkpoint_exists(path):
        latest = saver_mod.latest_checkpoint(ckpt_dir_or_file)
        if latest is None:
            raise errors.NotFoundError(None, None,
                                       f"No checkpoint at {ckpt_dir_or_file}")
        path = latest
    return CheckpointReader(path)


def load_variable(ckpt_dir_or_file, name):
    return load_checkpoint(ckpt_dir_or_file).get_tensor(name)


def list_variables(ckpt_dir_or_file):
    reader = load_checkpoint(ckpt_dir_or_file)
    return sorted(reader.get_variable_to_shape_map().items())
