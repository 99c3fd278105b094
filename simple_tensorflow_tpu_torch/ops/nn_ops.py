"""``stf.nn`` ops of the port that are not fused kernels of the JAX
package, with the JAX package's layouts at their boundaries (NHWC
activations, HWIO filters, TF ``SAME``/``VALID`` padding):

- ``dropout``, as ``simple_tensorflow_tpu/ops/nn_ops.py:dropout`` (:699)
  builds it and ``_dropout_lower`` (:388-398) lowers it, drawing JAX's
  threefry bits from an explicit key (a JAX session derives the key per
  step and per op; :class:`..framework.random_seed.StepRNG` is the port's
  counterpart). It runs the Dropout kernel, or its plain version under
  :func:`.fused_ops.plain_versions`.
- ``conv2d`` (``_conv2d_impl`` :164) and ``max_pool`` (``_max_pool_impl``
  :352): a plain convolution is left to ``F.conv2d`` (cuDNN on the card),
  as the JAX package leaves it to XLA outside any Pallas kernel. PyTorch's
  ``padding=`` is symmetric, so TF ``SAME`` padding, which puts the odd
  element at the bottom/right (stride 2), is padded explicitly.
- ``relu``, ``l2_loss`` (:53) and ``sparse_softmax_cross_entropy_with_
  logits`` (:67-109), the last through the softmax-xent kernels without
  smoothing: the function the JAX registry's routed lowering computes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .fused_ops import using_plain_versions
from .kernels.dropout import DropoutFunction
from .kernels.softmax_xent import softmax_cross_entropy


def dropout(x, keep_prob: float, key):
    """``where(uniform(key, x.shape) < keep_prob, x / keep_prob, 0)``
    with ``keep_prob`` in ``x``'s dtype for the division; ``key`` is a raw
    threefry key (two uint32 words). ``keep_prob == 1`` returns ``x``, as
    the JAX function does; one that rounds to 0 in f32 (below about
    7e-46) is refused on every device. Differentiable."""
    keep_prob = float(keep_prob)
    if not (0.0 < np.float32(keep_prob) and keep_prob <= 1.0):
        raise ValueError(f"keep_prob must be in (0, 1] in f32: {keep_prob}")
    if keep_prob == 1.0:
        return x
    return DropoutFunction.apply(x, keep_prob, tuple(int(w) for w in key),
                                 using_plain_versions())


def relu(x):
    return torch.relu(x)


def l2_loss(x):
    """``0.5 * sum(x**2)`` summed in f32, cast back to ``x``'s dtype."""
    return (0.5 * torch.sum(torch.square(x.float()))).to(x.dtype)


def sparse_softmax_cross_entropy_with_logits(labels, logits):
    """Per-example ``-log softmax(logits)[label]`` in the logits' dtype:
    ``logits (..., classes)``, int ``labels (...)``."""
    loss = softmax_cross_entropy(logits, labels,
                                 plain=using_plain_versions())
    return loss.to(logits.dtype)


def same_padding(size: int, k: int, stride: int) -> tuple:
    """TF ``SAME`` padding of one spatial axis: ``(before, after)``, the
    odd element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x, ksize, strides, padding):
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID': {padding!r}")
    return (same_padding(x.shape[1], ksize[0], strides[0]),
            same_padding(x.shape[2], ksize[1], strides[1]))


def _spatial(v, name):
    """(h, w) of an NHWC 4-list ``[1, h, w, 1]``."""
    v = tuple(int(s) for s in v)
    if len(v) != 4 or v[0] != 1 or v[3] != 1:
        raise ValueError(f"{name} must be [1, h, w, 1] (NHWC): {v}")
    return v[1:3]


def conv2d(x, filter, strides, padding):  # noqa: A002 (the TF name)
    """2-D convolution of NHWC ``x`` with an HWIO ``filter``, NHWC out.
    Strides ``[1, sh, sw, 1]``. The filter is handed to ``F.conv2d`` as
    the OIHW tensor it views (a port ``Conv2D`` stores its kernel
    contiguous OIHW, so no copy); ``x`` goes as the NCHW view of NHWC
    memory (channels_last), so activations stay in the JAX layout."""
    sh, sw = _spatial(strides, "strides")
    kh, kw = filter.shape[:2]
    (pt, pb), (pl, pr) = _pads(x, (kh, kw), (sh, sw), padding)
    w = filter.permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=(sh, sw),
                     padding=(pt, pl))
    else:
        xp = F.pad(x, (0, 0, pl, pr, pt, pb))
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


def max_pool(x, ksize, strides, padding):
    """Max pooling of NHWC ``x``; ``ksize``/``strides`` ``[1, h, w, 1]``;
    ``SAME`` pads with -inf, as ``reduce_window`` with a -inf init."""
    kh, kw = _spatial(ksize, "ksize")
    sh, sw = _spatial(strides, "strides")
    (pt, pb), (pl, pr) = _pads(x, (kh, kw), (sh, sw), padding)
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), stride=(sh, sw))
    return y.permute(0, 2, 3, 1)
