"""Batch normalisation over the last (channel) axis: the graph
``BatchNormalization`` layer and ``batch_normalization`` of
``simple_tensorflow_tpu/layers/normalization.py`` (:14-87), and the eager
:class:`BatchNormalizationModule` of the port's ``ResNet``.

Both keep f32 ``gamma``/``beta`` and ``moving_mean``/``moving_variance``
whatever the activations' dtype. In training they normalise with the
batch statistics through :class:`..ops.nn_impl.FusedBatchNormFunction`
(the graph layer through the ``FusedBatchNorm`` op). The graph layer
also builds the moving-average assigns and puts them in ``UPDATE_OPS``
(:59-65), as the JAX layer does; ``minimize`` never runs that collection,
so a ``train_op`` of either package leaves ``moving_mean``/
``moving_variance`` at their initial values. The eager module does what
``train_op`` does: it keeps them as buffers and does not update them. At
inference both normalise with them."""

from __future__ import annotations

import torch
from torch import nn

from ..framework import graph as ops_mod
from ..ops import init_ops, nn_impl, state_ops
from .base import Layer


class BatchNormalization(Layer):
    """(ref: normalization.py:59 ``class BatchNormalization``)."""

    def __init__(self, axis=-1, momentum=0.99, epsilon=1e-3, center=True,
                 scale=True, beta_initializer=None, gamma_initializer=None,
                 moving_mean_initializer=None,
                 moving_variance_initializer=None, trainable=True,
                 fused=True, name=None):
        super().__init__(trainable=trainable,
                         name=name or "batch_normalization")
        self.axis = axis
        self.momentum = momentum
        self.epsilon = epsilon
        self.center = center
        self.scale = scale
        self.beta_initializer = beta_initializer or init_ops.Zeros()
        self.gamma_initializer = gamma_initializer or init_ops.Ones()
        self.moving_mean_initializer = (moving_mean_initializer
                                        or init_ops.Zeros())
        self.moving_variance_initializer = (moving_variance_initializer
                                            or init_ops.Ones())
        self.fused = fused

    def build(self, input_shape):
        ch = input_shape[self.axis].value
        self.gamma = self.add_variable("gamma", [ch], dtype="float32",
                                       initializer=self.gamma_initializer,
                                       trainable=self.scale)
        self.beta = self.add_variable("beta", [ch], dtype="float32",
                                      initializer=self.beta_initializer,
                                      trainable=self.center)
        self.moving_mean = self.add_variable(
            "moving_mean", [ch], dtype="float32",
            initializer=self.moving_mean_initializer, trainable=False)
        self.moving_variance = self.add_variable(
            "moving_variance", [ch], dtype="float32",
            initializer=self.moving_variance_initializer, trainable=False)
        self.built = True

    def call(self, inputs, training=False):
        if self.axis not in (-1, inputs.shape.rank - 1):
            raise NotImplementedError("BatchNormalization over another "
                                      "axis than the last is not ported")
        if training:
            y, batch_mean, batch_var = nn_impl.fused_batch_norm(
                inputs, self.gamma._ref, self.beta._ref,
                epsilon=self.epsilon, data_format="NHWC", is_training=True)
            mom = ops_mod.convert_to_tensor(self.momentum, dtype="float32")
            upd_mean = state_ops.assign(
                self.moving_mean._ref,
                self.moving_mean._ref * mom + batch_mean * (1.0 - mom))
            upd_var = state_ops.assign(
                self.moving_variance._ref,
                self.moving_variance._ref * mom + batch_var * (1.0 - mom))
            self.add_update([upd_mean.op, upd_var.op])
            return y
        y, _, _ = nn_impl.fused_batch_norm(
            inputs, self.gamma._ref, self.beta._ref,
            mean=self.moving_mean._ref, variance=self.moving_variance._ref,
            epsilon=self.epsilon, data_format="NHWC", is_training=False)
        return y


def batch_normalization(inputs, axis=-1, momentum=0.99, epsilon=1e-3,
                        center=True, scale=True, beta_initializer=None,
                        gamma_initializer=None, moving_mean_initializer=None,
                        moving_variance_initializer=None, training=False,
                        trainable=True, name=None, reuse=None, fused=True):
    layer = BatchNormalization(
        axis=axis, momentum=momentum, epsilon=epsilon, center=center,
        scale=scale, beta_initializer=beta_initializer,
        gamma_initializer=gamma_initializer,
        moving_mean_initializer=moving_mean_initializer,
        moving_variance_initializer=moving_variance_initializer,
        trainable=trainable, fused=fused, name=name)
    return layer(inputs, training=training)


class BatchNormalizationModule(nn.Module):
    """f32 ``gamma``/``beta`` parameters and f32 ``moving_mean``/
    ``moving_variance`` buffers, whatever the activations' dtype. The JAX
    layer's ``momentum`` feeds only the moving-average assigns that never
    run, so the port takes none."""

    def __init__(self, channels: int, epsilon: float = 1e-3, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("moving_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("moving_variance",
                             torch.ones(channels, device=device))

    def forward(self, x):
        y, _, _ = nn_impl.fused_batch_norm(
            x, self.gamma, self.beta, mean=self.moving_mean,
            variance=self.moving_variance, epsilon=self.epsilon,
            is_training=self.training)
        return y
