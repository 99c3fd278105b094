"""Dropout with JAX's threefry bits: the CUDA kernel ``csrc/dropout.cu``
and its plain PyTorch version.

Replaces the JAX package's ``Dropout`` op (``simple_tensorflow_tpu/ops/
nn_ops.py:_dropout_lower``, :388-398), which is composed XLA rather than
Pallas: ``u = jax.random.uniform(key, x.shape)``, ``keep = u <
keep_prob``, ``out = where(keep, x / kp, 0)`` with ``kp = keep_prob`` in
``x``'s dtype (0.8984375 for 0.9 in bf16) and a true division. Given the
same raw threefry key (two uint32 words), both versions here draw JAX's
bits (:mod:`...framework.prng`), so they drop what the JAX program drops.
The backward is the same function of the cotangent under the same key;
nothing is saved. Bounded by integer operations on the card (the
threefry rounds); the source note in ``csrc/dropout.cu`` says more.
"""

from __future__ import annotations

import numpy as np
import torch

from ...framework import prng
from . import _build
from .common import (DTYPE_CODES, check_cuda_arg, check_status,
                     count_launch, uses_kernel)


def _kp(keep_prob: float, dtype) -> float:
    """``keep_prob`` rounded to ``dtype``, as ``jnp.asarray(keep_prob,
    dtype)``."""
    return float(torch.tensor(keep_prob, dtype=torch.float64).to(dtype))


def dropout_plain(x, keep_prob, key):
    """The op in PyTorch ops: the uniform draw from :func:`prng.
    uniform_torch`, the compare against the f32 ``keep_prob``, and a
    division by a device tensor (a Python-scalar divisor would become a
    product with its reciprocal on CUDA)."""
    u = prng.uniform_torch(key, x.shape, x.device)
    keep = u < torch.full((), np.float32(keep_prob), dtype=torch.float32,
                          device=x.device)
    kp = torch.full((), _kp(keep_prob, x.dtype), dtype=x.dtype,
                    device=x.device)
    return torch.where(keep, x / kp, torch.zeros_like(x))


def _launch(name, x, keep_prob, key):
    check_cuda_arg("x", x, DTYPE_CODES, x.dim())
    k0, k1 = (int(w) for w in np.asarray(key, np.uint32))
    out = torch.empty_like(x)
    status = _build.library().stf_dropout(
        x.data_ptr(), out.data_ptr(), x.numel(), k0, k1,
        float(np.float32(keep_prob)), _kp(keep_prob, x.dtype),
        DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    check_status(name, status)
    count_launch(name)
    return out


def dropout_fwd(x, keep_prob, key):
    """``where(u < keep_prob, x / kp, 0)`` for any shape; CPU tensors
    take the plain version, CUDA tensors launch the kernel."""
    if not uses_kernel(x):
        return dropout_plain(x, keep_prob, key)
    return _launch("dropout", x, keep_prob, key)


def dropout_bwd(g, keep_prob, key):
    """The backward: the same function of the cotangent ``g``, launched
    under its own counter."""
    if not uses_kernel(g):
        return dropout_plain(g, keep_prob, key)
    return _launch("dropout_bwd", g, keep_prob, key)


class DropoutFunction(torch.autograd.Function):
    """Forward and backward of :func:`dropout_fwd`; nothing is saved but
    the key. ``plain=True`` runs the plain version on any device."""

    @staticmethod
    def forward(ctx, x, keep_prob, key, plain):
        ctx.args = (keep_prob, key, plain)
        if plain:
            return dropout_plain(x, keep_prob, key)
        return dropout_fwd(x.contiguous(), keep_prob, key)

    @staticmethod
    def backward(ctx, g):
        keep_prob, key, plain = ctx.args
        if plain:
            return dropout_plain(g, keep_prob, key), None, None, None
        return dropout_bwd(g.contiguous(), keep_prob, key), None, None, None
