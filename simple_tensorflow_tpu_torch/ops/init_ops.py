"""Initializers of the port (port of the part of ``simple_tensorflow_tpu/
ops/init_ops.py`` the MNIST graphs reach: ``Zeros``, ``VarianceScaling``
(:108) and ``glorot_uniform_initializer`` (:206)). Each returns a graph
tensor, so initialization runs on the device inside the initializer run.
Left out: the constant, normal, truncated-normal, orthogonal and identity
initializers.
"""

from __future__ import annotations

import math

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


class VarianceScaling(Initializer):
    """(ref: init_ops.py ``variance_scaling_initializer``); only the
    ``"uniform"`` distribution is ported."""

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
        if self.distribution != "uniform":
            raise NotImplementedError(
                f"VarianceScaling distribution {self.distribution!r} is not "
                "ported (only 'uniform')")
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


def variance_scaling_initializer(scale=1.0, mode="fan_in",
                                 distribution="truncated_normal", seed=None,
                                 dtype=dtypes_mod.float32):
    return VarianceScaling(scale, mode, distribution, seed, dtype)


def glorot_uniform_initializer(seed=None, dtype=dtypes_mod.float32):
    return VarianceScaling(1.0, "fan_avg", "uniform", seed, dtype)
