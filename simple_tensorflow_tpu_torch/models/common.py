"""Building blocks of the port's transformer models.

Port of ``simple_tensorflow_tpu/models/common.py`` (``layer_norm``,
``split_heads``, ``merge_heads``; ``dense`` is
:class:`..layers.core.DenseModule`) and the port's device rule. Parameter
names follow the JAX variables, so a module's ``state_dict`` key is the
JAX variable path with ``.`` for ``/`` (``…/ln1/gamma``, ``…/q/kernel``,
``…/q/bias``). Dense kernels are ``(in, out)`` as in JAX. Parameters are
trainable; the serving model switches their gradients off.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_ops import fused_layer_norm


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device needs a card: no
    silent move to the CPU. On CUDA, f32 matrix products and cuDNN's f32
    convolutions (the ResNet path's) are pinned to full f32, no TF32: the
    precision the JAX package runs its f32 programs at."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on an NVIDIA "
                "GPU by default — pass device='cpu' to run the kernels' "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


class LayerNorm(nn.Module):
    """f32 ``gamma``/``beta`` (whatever the activations' dtype, as
    ``common.layer_norm`` creates them) and the LayerNorm kernels over the
    last axis."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return fused_layer_norm(x, self.gamma, self.beta, eps=self.eps)


def split_heads(x, b, s, heads, head_dim):
    """(B,S,H*D) -> (B,H,S,D)."""
    return x.reshape(b, s, heads, head_dim).permute(0, 2, 1, 3)


def merge_heads(x, b, s, hidden):
    """(B,H,S,D) -> (B,S,H*D)."""
    return x.permute(0, 2, 1, 3).reshape(b, s, hidden)
