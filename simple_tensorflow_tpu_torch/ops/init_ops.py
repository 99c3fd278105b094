"""Initializers of the port (port of the part of ``simple_tensorflow_tpu/
ops/init_ops.py`` the MNIST, transformer, ResNet and RNN graphs reach:
``Zeros``, ``Ones`` (:38), ``Constant`` (:48), ``RandomUniform`` (:63),
``RandomNormal`` (:74), ``TruncatedNormal`` (:84), ``VarianceScaling``
(:108) and ``glorot_uniform_initializer`` (:206)). Each returns a graph
tensor, so initialization runs on the device inside the initializer run.
A draw in bf16 is drawn in f32 and cast, as the JAX ``_ru``/``_tn`` do.
``VarianceScaling`` with ``"truncated_normal"`` (or ``"normal"``, which
the JAX package maps to the same draw) divides its stddev by
0.87962566103423978, the stddev of a unit normal truncated to (-2, 2).
``Constant`` is a ``Const`` of the value, filled or reshaped to the
shape. Left out: the orthogonal, identity and uniform-unit-scaling
initializers.
"""

from __future__ import annotations

import math

import numpy as np

from ..framework import constant_op
from ..framework import dtypes as dtypes_mod
from . import random_ops


class Initializer:
    def __call__(self, shape, dtype=None, partition_info=None):
        raise NotImplementedError


class Zeros(Initializer):
    def __init__(self, dtype=dtypes_mod.float32):
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        from . import array_ops

        return array_ops.zeros(shape, dtype or self.dtype)


class Ones(Initializer):
    def __init__(self, dtype=dtypes_mod.float32):
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        from . import array_ops

        return array_ops.ones(shape, dtype or self.dtype)


class Constant(Initializer):
    def __init__(self, value=0, dtype=dtypes_mod.float32,
                 verify_shape=False):
        self.value = value
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        dt = dtypes_mod.as_dtype(dtype or self.dtype)
        arr = np.asarray(self.value, dtype=dt.np_dtype)
        if arr.shape == ():
            arr = np.full(tuple(int(s) for s in shape), arr,
                          dtype=dt.np_dtype)
        else:
            arr = arr.reshape(tuple(int(s) for s in shape))
        return constant_op.constant(arr)


class RandomUniform(Initializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed=None,
                 dtype=dtypes_mod.float32):
        self.minval, self.maxval, self.seed = minval, maxval, seed
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        return random_ops.random_uniform(shape, self.minval, self.maxval,
                                         dtype or self.dtype,
                                         seed=self.seed)


class RandomNormal(Initializer):
    def __init__(self, mean=0.0, stddev=1.0, seed=None,
                 dtype=dtypes_mod.float32):
        self.mean, self.stddev, self.seed = mean, stddev, seed
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        return random_ops.random_normal(shape, self.mean, self.stddev,
                                        dtype or self.dtype, seed=self.seed)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, stddev=1.0, seed=None,
                 dtype=dtypes_mod.float32):
        self.mean, self.stddev, self.seed = mean, stddev, seed
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        return random_ops.truncated_normal(shape, self.mean, self.stddev,
                                           dtype or self.dtype,
                                           seed=self.seed)


class VarianceScaling(Initializer):
    """(ref: init_ops.py ``variance_scaling_initializer``)."""

    def __init__(self, scale=1.0, mode="fan_in",
                 distribution="truncated_normal", seed=None,
                 dtype=dtypes_mod.float32):
        if mode not in ("fan_in", "fan_out", "fan_avg"):
            raise ValueError(f"bad mode {mode}")
        self.scale, self.mode, self.distribution = scale, mode, distribution
        self.seed = seed
        self.dtype = dtypes_mod.as_dtype(dtype)

    def __call__(self, shape, dtype=None, partition_info=None):
        fan_in, fan_out = _compute_fans(shape)
        scale = self.scale
        if self.mode == "fan_in":
            scale /= max(1.0, fan_in)
        elif self.mode == "fan_out":
            scale /= max(1.0, fan_out)
        else:
            scale /= max(1.0, (fan_in + fan_out) / 2.0)
        if self.distribution in ("truncated_normal", "normal"):
            stddev = math.sqrt(scale) / 0.87962566103423978
            return random_ops.truncated_normal(shape, 0.0, stddev,
                                               dtype or self.dtype,
                                               self.seed)
        limit = math.sqrt(3.0 * scale)
        return random_ops.random_uniform(shape, -limit, limit,
                                         dtype or self.dtype, self.seed)


def _compute_fans(shape):
    shape = [int(s) for s in shape]
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for dim in shape[:-2]:
        receptive *= dim
    return shape[-2] * receptive, shape[-1] * receptive


zeros_initializer = Zeros
ones_initializer = Ones
constant_initializer = Constant
random_uniform_initializer = RandomUniform
random_normal_initializer = RandomNormal
truncated_normal_initializer = TruncatedNormal


def variance_scaling_initializer(scale=1.0, mode="fan_in",
                                 distribution="truncated_normal", seed=None,
                                 dtype=dtypes_mod.float32):
    return VarianceScaling(scale, mode, distribution, seed, dtype)


def glorot_uniform_initializer(seed=None, dtype=dtypes_mod.float32):
    return VarianceScaling(1.0, "fan_avg", "uniform", seed, dtype)
