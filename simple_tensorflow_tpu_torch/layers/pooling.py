"""``max_pooling2d``: port of ``simple_tensorflow_tpu/layers/pooling.py``
(:113) for NHWC input."""

from __future__ import annotations

from ..ops import nn_ops


def max_pooling2d(inputs, pool_size: int, strides: int, padding="valid"):
    """Max pooling with a square window and stride; TF ``"same"`` pads
    with -inf."""
    return nn_ops.max_pool(inputs, [1, pool_size, pool_size, 1],
                           [1, strides, strides, 1], padding.upper())
