"""``BatchNormalizationModule``: the eager port of ``simple_tensorflow_tpu/
layers/normalization.py`` (:14-87) over the last (channel) axis (the
graph ``BatchNormalization`` layer is not ported yet).

Training mode (``module.train()``) normalises with the batch statistics
through :class:`..ops.nn_impl.FusedBatchNormFunction`. The JAX layer also
builds moving-average assigns and puts them in ``UPDATE_OPS``
(:59-65); ``minimize`` never runs that collection, so a JAX ``train_op``
leaves ``moving_mean``/``moving_variance`` at their initial values. The
port does what ``train_op`` does: it keeps them as buffers and does not
update them. Inference mode (``module.eval()``) normalises with them."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import nn_impl


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
