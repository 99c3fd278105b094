"""Core layers: the graph ``Dense``/``dense`` and ``Flatten``/``flatten``
of ``simple_tensorflow_tpu/layers/core.py`` (:12, :67, :287), and the
eager :class:`DenseModule` the port's ``nn.Module`` models use. Left out
of the graph layers: ``Dropout`` (use ``stf.nn.dropout``), regularizers
and constraints.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import array_ops, init_ops, math_ops, nn_ops
from .base import Layer


class Dense(Layer):
    """(ref: core.py:48 ``class Dense``): ``inputs @ kernel`` then
    ``bias_add``, then the activation, as graph ops."""

    def __init__(self, units, activation=None, use_bias=True,
                 kernel_initializer=None, bias_initializer=None,
                 trainable=True, name=None):
        super().__init__(trainable=trainable, name=name or "dense")
        self.units = int(units)
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer or init_ops.Zeros()

    def build(self, input_shape):
        in_dim = input_shape[-1].value
        if in_dim is None:
            raise ValueError("Dense needs known last dim")
        self.kernel = self.add_variable(
            "kernel", [in_dim, self.units],
            initializer=self.kernel_initializer)
        if self.use_bias:
            self.bias = self.add_variable(
                "bias", [self.units], initializer=self.bias_initializer)
        self.built = True

    def call(self, inputs):
        rank = inputs.shape.rank
        if rank is not None and rank > 2:
            flat = array_ops.reshape(inputs, [-1, inputs.shape[-1].value])
            out = math_ops.matmul(flat, self.kernel._ref)
            out_shape = [d.value if d.value is not None else -1
                         for d in inputs.shape[:-1]] + [self.units]
            out = array_ops.reshape(out, out_shape)
        else:
            out = math_ops.matmul(inputs, self.kernel._ref)
        if self.use_bias:
            out = nn_ops.bias_add(out, self.bias._ref)
        if self.activation is not None:
            out = self.activation(out)
        return out


def dense(inputs, units, activation=None, use_bias=True,
          kernel_initializer=None, bias_initializer=None, trainable=True,
          name=None):
    return Dense(units, activation, use_bias, kernel_initializer,
                 bias_initializer, trainable, name)(inputs)


class Flatten(Layer):
    """(ref: core.py:287 ``class Flatten``)."""

    def call(self, inputs):
        n = 1
        for d in inputs.shape.as_list()[1:]:
            if d is None:
                raise ValueError("Flatten needs static non-batch dims")
            n *= d
        return array_ops.reshape(inputs, [-1, n])


def flatten(inputs, name=None):
    return Flatten(name=name or "flatten")(inputs)


class DenseModule(nn.Module):
    """``x @ kernel + bias`` (matmul then bias add, as ``stf.layers.dense``),
    optionally followed by an activation. ``kernel`` is ``(in, out)`` as in
    JAX; ``dtype`` is the parameters' dtype: the JAX layer creates its
    kernel and bias in its input's dtype (``layers/base.py:98-99``). The
    product is a plain large matrix product, left to ``torch.matmul`` as the
    JAX package left it to XLA."""

    def __init__(self, in_features: int, out_features: int,
                 activation=None, dtype=torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(
            in_features, out_features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                             device=device))
        self.activation = activation

    def forward(self, x):
        y = torch.matmul(x, self.kernel) + self.bias
        if self.activation is not None:
            y = self.activation(y)
        return y
