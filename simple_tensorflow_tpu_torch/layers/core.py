"""``Dense``: port of ``simple_tensorflow_tpu/layers/core.py:Dense`` (and
``dense`` :67)."""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
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
