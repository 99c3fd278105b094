"""Gradient and value clipping (port of ``simple_tensorflow_tpu/ops/
clip_ops.py:1-72``; ref: tensorflow/python/ops/clip_ops.py):
``clip_by_value`` (``ClipByValue``), ``clip_by_norm``, ``global_norm``
(``sqrt(2 * AddN(L2Loss(t) ...))``, the L2 losses in f32) and
``clip_by_global_norm``, built from the same ops as in JAX. Left out:
``IndexedSlices`` gradients (the port's gradients are dense) and
``clip_by_average_norm``.
"""

from __future__ import annotations

from ..framework import graph as ops_mod
from . import math_ops
from .op_util import make_op


def clip_by_value(t, clip_value_min, clip_value_max, name=None):
    x = ops_mod.convert_to_tensor(t)
    lo = ops_mod.convert_to_tensor(clip_value_min, dtype=x.dtype.base_dtype)
    hi = ops_mod.convert_to_tensor(clip_value_max, dtype=x.dtype.base_dtype)
    return make_op("ClipByValue", [x, lo, hi], name=name)


def clip_by_norm(t, clip_norm, axes=None, name=None):
    x = ops_mod.convert_to_tensor(t)
    l2 = math_ops.sqrt(math_ops.reduce_sum(math_ops.square(x), axis=axes,
                                           keepdims=True))
    clip_norm_t = ops_mod.convert_to_tensor(clip_norm,
                                            dtype=x.dtype.base_dtype)
    scale = clip_norm_t / math_ops.maximum(l2, clip_norm_t)
    return math_ops.multiply(x, scale, name=name)


def global_norm(t_list, name=None):
    from . import nn_ops

    half_squared = [nn_ops.l2_loss(math_ops.cast(
        ops_mod.convert_to_tensor(t), "float32"))
        for t in t_list if t is not None]
    return math_ops.sqrt(
        math_ops.multiply(math_ops.add_n(half_squared),
                          ops_mod.convert_to_tensor(2.0)), name=name)


def clip_by_global_norm(t_list, clip_norm, use_norm=None, name=None):
    """(ref: clip_ops.py:201 ``clip_by_global_norm``): ``(clipped list,
    global norm)``; each tensor scaled by ``clip_norm / max(norm,
    clip_norm)``."""
    if use_norm is None:
        use_norm = global_norm(t_list)
    clip_norm_t = ops_mod.convert_to_tensor(clip_norm, dtype="float32")
    scale = clip_norm_t / math_ops.maximum(use_norm, clip_norm_t)
    clipped = []
    for t in t_list:
        if t is None:
            clipped.append(None)
        else:
            t = ops_mod.convert_to_tensor(t)
            clipped.append(t * math_ops.cast(scale, t.dtype.base_dtype))
    return clipped, use_norm
