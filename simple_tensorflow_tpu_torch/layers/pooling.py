"""Max pooling: the graph ``MaxPooling2D``/``max_pooling2d`` of
``simple_tensorflow_tpu/layers/pooling.py`` (:37, :113) and the eager
:func:`_max_pooling2d_impl` the port's ResNet uses, both NHWC. Left out of
the graph layers: average pooling, 1-D/3-D pooling and
``channels_first``."""

from __future__ import annotations

from ..ops import nn_ops
from .base import Layer


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


class MaxPooling2D(Layer):
    def __init__(self, pool_size, strides, padding="valid",
                 data_format="channels_last", name=None):
        super().__init__(name=name or "max_pooling2d")
        if data_format != "channels_last":
            raise NotImplementedError("channels_first is not ported")
        self.pool_size = _norm_tuple(pool_size, 2)
        self.strides = _norm_tuple(strides, 2)
        self.padding = padding.upper()

    def call(self, inputs):
        return nn_ops.max_pool(inputs, [1] + list(self.pool_size) + [1],
                               [1] + list(self.strides) + [1], self.padding,
                               data_format="NHWC")


def max_pooling2d(inputs, pool_size, strides, padding="valid",
                  data_format="channels_last", name=None):
    return MaxPooling2D(pool_size, strides, padding, data_format,
                        name=name)(inputs)


def _max_pooling2d_impl(inputs, pool_size: int, strides: int,
                        padding="valid"):
    """Eager max pooling with a square window and stride; TF ``"same"``
    pads with -inf."""
    return nn_ops._max_pool_impl(inputs, [1, pool_size, pool_size, 1],
                                 [1, strides, strides, 1], padding.upper())
