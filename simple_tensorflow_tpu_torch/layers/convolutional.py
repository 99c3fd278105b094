"""``Conv2D``: port of ``simple_tensorflow_tpu/layers/convolutional.py``
(``_Conv``/``Conv2D`` :19-79) for NHWC activations."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import nn_ops


class Conv2D(nn.Module):
    """A 2-D convolution of NHWC input with TF padding (``"same"`` or
    ``"valid"``), without an activation. ``kernel`` is stored contiguous
    OIHW (``(filters, in, kh, kw)``), the layout ``F.conv2d`` takes, and
    handed to :func:`..ops.nn_ops.conv2d` as its HWIO view, the JAX
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
        y = nn_ops.conv2d(x, self.kernel.permute(2, 3, 1, 0), [1, s, s, 1],
                          self.padding)
        if self.bias is not None:
            y = y + self.bias
        return y
