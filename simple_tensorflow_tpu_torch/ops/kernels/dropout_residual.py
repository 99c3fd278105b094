"""Fused ``residual + dropout(x + bias)``: the CUDA kernel
``csrc/dropout_residual.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``simple_tensorflow_tpu/ops/pallas/
dropout_residual.py:_kernel`` (called at :71) and its custom VJP
(``_dbr_bwd_rule``, :99-115). The keep mask is K0, the counter hash of
(seed, salt 0, global row, column) (``common.counter_keep_mask_plain``),
so the backward regenerates it from the int32 seed and nothing is saved:

- forward: ``out = (residual + where(keep, (x + bias) * f32(1/kp), 0))``
  in f32, rounded once to ``x``'s dtype;
- backward: ``dx = where(keep, g * f32(1/kp), 0)`` (the kernel run on
  ``g`` with no residual, counted as ``dropout_residual_bwd``), ``dres =
  g``, and with a bias ``dbias = Σ_rows dx`` summed in f32 by PyTorch, as
  JAX sums it outside Pallas.

The kernel-level functions take ``(rows, n)`` contiguous tensors;
:func:`dropout_bias_residual` takes any ``(..., n)``. Bytes and integer
operations are close on the card; the source note in
``csrc/dropout_residual.cu`` says what the design does.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (DTYPE_CODES, check_cuda_arg, check_status,
                     count_launch, counter_keep_mask_plain, keep_threshold,
                     scale_kept, seed_word, uses_kernel)


def keep_mask_plain(rows, n, seed, keep_prob, device):
    """The ``(rows, n)`` keep mask of the kernel (salt 0)."""
    rr = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    cc = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return counter_keep_mask_plain(seed_word(seed), 0, rr, cc, keep_prob)


def dropout_residual_fwd_plain(x, residual, bias=None, *, rate, seed):
    """The forward on ``(rows, n)`` tensors, as ``_kernel`` computes it."""
    keep_prob = 1.0 - rate
    xf = x.float()
    if bias is not None:
        xf = xf + bias.float()
    keep = keep_mask_plain(x.shape[0], x.shape[1], seed, keep_prob, x.device)
    return (residual.float() + scale_kept(xf, keep, keep_prob)).to(x.dtype)


def dropout_residual_bwd_plain(g, *, rate, seed):
    """``dx = where(keep, g * f32(1/kp), 0)`` in ``g``'s dtype."""
    keep_prob = 1.0 - rate
    keep = keep_mask_plain(g.shape[0], g.shape[1], seed, keep_prob, g.device)
    return scale_kept(g.float(), keep, keep_prob).to(g.dtype)


def _launch(name, x, residual, bias, rate, seed):
    check_cuda_arg("x", x, DTYPE_CODES, 2)
    rows, n = x.shape
    if residual is not None:
        check_cuda_arg("residual", residual, (x.dtype,), 2)
        if residual.shape != x.shape:
            raise ValueError(f"residual {tuple(residual.shape)} must be "
                             f"{tuple(x.shape)}")
    if bias is not None:
        check_cuda_arg("bias", bias, (x.dtype,), 1)
        if bias.shape[0] != n:
            raise ValueError(f"bias {tuple(bias.shape)} must be ({n},)")
    keep_prob = 1.0 - rate
    out = torch.empty_like(x)
    status = _build.library().stf_dropout_residual(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), rows, n,
        seed_word(seed), keep_threshold(keep_prob), 1.0 / keep_prob,
        DTYPE_CODES[x.dtype], _build.stream_handle(x.device))
    check_status(name, status)
    count_launch(name)
    return out


def dropout_residual_fwd(x, residual, bias=None, *, rate, seed):
    """The forward on ``(rows, n)`` tensors; CPU tensors take the plain
    version, CUDA tensors launch the kernel."""
    tensors = [x, residual] + ([bias] if bias is not None else [])
    if not uses_kernel(*tensors):
        return dropout_residual_fwd_plain(x, residual, bias, rate=rate,
                                          seed=seed)
    return _launch("dropout_residual", x, residual, bias, rate, seed)


def dropout_residual_bwd(g, *, rate, seed):
    """``dx`` on ``(rows, n)``; CPU tensors take the plain version, CUDA
    tensors launch the kernel."""
    if not uses_kernel(g):
        return dropout_residual_bwd_plain(g, rate=rate, seed=seed)
    return _launch("dropout_residual_bwd", g, None, None, rate, seed)


class DropoutResidualFunction(torch.autograd.Function):
    """Forward and backward of ``(rows, n)`` tensors; nothing is saved
    but the dtypes: the backward regenerates the mask from the seed.
    ``plain=True`` runs the plain versions on any device."""

    @staticmethod
    def forward(ctx, x, residual, bias, rate, seed, plain):
        fwd = dropout_residual_fwd_plain if plain else dropout_residual_fwd
        ctx.args = (rate, seed, plain, residual.dtype,
                    None if bias is None else bias.dtype)
        return fwd(x, residual, bias, rate=rate, seed=seed)

    @staticmethod
    def backward(ctx, g):
        rate, seed, plain, res_dtype, bias_dtype = ctx.args
        bwd = dropout_residual_bwd_plain if plain else dropout_residual_bwd
        g = g.contiguous()
        dbias = None
        if bias_dtype is None:
            dx = bwd(g, rate=rate, seed=seed)
        else:
            # dbias sums the f32 dx before its cast, as the JAX rule does
            dx_f = bwd(g.float(), rate=rate, seed=seed)
            dx = dx_f.to(g.dtype)
            dbias = dx_f.sum(dim=0).to(bias_dtype)
        return dx, g.to(res_dtype), dbias, None, None, None


def dropout_bias_residual(x, residual, bias=None, *, rate, seed,
                          plain=False):
    """``residual + dropout(x + bias)`` for ``x``/``residual (..., n)``,
    ``bias (n,)`` or None, an int32 ``seed``; returns ``x``'s dtype and
    shape. Differentiable in ``x``, ``residual`` and ``bias``."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"rate must be in (0, 1): {rate}")
    shape = x.shape
    n = shape[-1]
    out = DropoutResidualFunction.apply(
        x.reshape(-1, n).contiguous(), residual.reshape(-1, n).contiguous(),
        bias, float(rate), seed_word(seed), bool(plain))
    return out.reshape(shape)
