"""2-D convolution layers: the graph ``Conv2D``/``conv2d`` of
``simple_tensorflow_tpu/layers/convolutional.py`` (``_Conv``/``Conv2D``
:19-79, ``conv2d`` :185) for NHWC activations, and the eager
:class:`Conv2DModule` the port's ``nn.Module`` models use. Left out of the
graph layers: 1-D/3-D, transposed and separable convolutions,
``channels_first``, dilation and regularizers.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import init_ops, nn_ops
from .base import Layer


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


class Conv2D(Layer):
    """(ref: convolutional.py:335 ``class Conv2D``): ``conv2d`` then
    ``bias_add``, then the activation, as graph ops."""

    def __init__(self, filters, kernel_size, strides=1, padding="valid",
                 activation=None, use_bias=True, kernel_initializer=None,
                 bias_initializer=None, trainable=True, name=None):
        super().__init__(trainable=trainable, name=name or "conv2d")
        self.filters = int(filters)
        self.kernel_size = _norm_tuple(kernel_size, 2)
        self.strides = _norm_tuple(strides, 2)
        self.padding = padding.upper()
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer or init_ops.Zeros()

    def build(self, input_shape):
        in_ch = input_shape[-1].value
        self.kernel = self.add_variable(
            "kernel", list(self.kernel_size) + [in_ch, self.filters],
            initializer=self.kernel_initializer)
        if self.use_bias:
            self.bias = self.add_variable(
                "bias", [self.filters], initializer=self.bias_initializer)
        self.built = True

    def call(self, inputs):
        out = nn_ops.conv2d(inputs, self.kernel._ref,
                            strides=[1] + list(self.strides) + [1],
                            padding=self.padding, data_format="NHWC",
                            dilations=[1, 1, 1, 1])
        if self.use_bias:
            out = nn_ops.bias_add(out, self.bias._ref, data_format="NHWC")
        if self.activation is not None:
            out = self.activation(out)
        return out


def conv2d(inputs, filters, kernel_size, **kwargs):
    return Conv2D(filters, kernel_size, **kwargs)(inputs)


class Conv2DModule(nn.Module):
    """A 2-D convolution of NHWC input with TF padding (``"same"`` or
    ``"valid"``), without an activation. ``kernel`` is stored contiguous
    OIHW (``(filters, in, kh, kw)``), the layout ``F.conv2d`` takes, and
    handed to :func:`..ops.nn_ops._conv2d_impl` as its HWIO view, the JAX
    variable's layout (``convert`` transposes checkpoints). The kernel
    stays a contiguous view into the optimizer's flat buffer: do not move
    the module to ``channels_last``, which would replace its ``.data``;
    the activations carry that layout instead. ``dtype`` is the
    parameters' dtype (the JAX layer's input dtype)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: str = "valid", use_bias=True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.strides = int(strides)
        self.padding = padding.upper()
        self.kernel = nn.Parameter(torch.zeros(
            filters, in_channels, kernel_size, kernel_size, dtype=dtype,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(filters, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x):
        s = self.strides
        y = nn_ops._conv2d_impl(x, self.kernel.permute(2, 3, 1, 0),
                                [1, s, s, 1], self.padding)
        if self.bias is not None:
            y = y + self.bias
        return y
