"""Fused ``residual + dropout(x + bias)``: the CUDA kernel
``csrc/dropout_residual.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``simple_tensorflow_tpu/ops/pallas/
dropout_residual.py:_kernel`` (called at :71) and its custom VJP
(``_dbr_bwd_rule``, :99-115). The keep mask is K0, the counter hash of
(seed, salt 0, global row, column) (``common.counter_keep_mask_plain``),
so the backward regenerates it from the int32 seed and nothing is saved
but the seed, as the JAX VJP saves nothing. The seed is a host int, or a
one-element int32 tensor on the card (a row of a compiled Session step's
seed buffer) that the kernel's seed-pointer entry reads there:

- forward: ``out = (residual + where(keep, (x + bias) * f32(1/kp), 0))``
  in f32, rounded once to ``x``'s dtype;
- backward: ``dx = where(keep, g * f32(1/kp), 0)`` (the kernel run on
  ``g`` with no residual, counted as ``dropout_residual_bwd``), ``dres =
  g``, and with a bias ``dbias = Σ_rows dx`` summed in f32 by PyTorch, as
  JAX sums it outside Pallas.

The kernel-level functions take ``(rows, n)`` contiguous tensors;
:func:`dropout_bias_residual` takes any ``(..., n)``. Bound by bytes on
the card. The kernel has a vector path, a warp per row with 16-byte loads
and the row hash taken once a row, for the rows :func:`vectors_per_lane`
admits, and a general path, one element a thread, for any other width or
a misaligned view; the source note in ``csrc/dropout_residual.cu`` says
more.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (DTYPE_CODES, cdiv, check_cuda_arg, check_status,
                     count_launch, counter_keep_mask_plain, device_seed,
                     keep_threshold, scale_kept, seed_word, uses_kernel)

# 16-byte vectors a lane the vector path holds: those of the shipped
# widths, d_model 512 and 1024 (a row of at most 1024 values)
VEC_NV = {torch.bfloat16: (2, 4), torch.float32: (4, 8)}
# rows below which the general path's grid (a block per 256 columns of a
# row) keeps more SMs busy than the vector path's warp per row
VEC_MIN_ROWS = 128


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


def vectors_per_lane(rows, n, dtype, *tensors) -> int:
    """Which kernel takes ``rows`` rows of ``n`` values of ``dtype``: the
    vector path's 16-byte vectors a lane (a warp per row; at least
    ``VEC_MIN_ROWS`` rows of whole vectors, every tensor's data 16-byte
    aligned), the least count in ``VEC_NV[dtype]`` that holds the row, or
    0 for the general path (also for a row longer than the largest)."""
    per_vec = 16 // (torch.finfo(dtype).bits // 8)
    if rows < VEC_MIN_ROWS or n % per_vec or \
            any(t.data_ptr() % 16 for t in tensors):
        return 0
    need = cdiv(n // per_vec, 32)
    return next((nv for nv in VEC_NV[dtype] if nv >= need), 0)


def _check(x, residual, bias):
    check_cuda_arg("x", x, DTYPE_CODES, 2)
    if residual is not None:
        check_cuda_arg("residual", residual, (x.dtype,), 2)
        if residual.shape != x.shape:
            raise ValueError(f"residual {tuple(residual.shape)} must be "
                             f"{tuple(x.shape)}")
    if bias is not None:
        check_cuda_arg("bias", bias, (x.dtype,), 1)
        if bias.shape[0] != x.shape[1]:
            raise ValueError(f"bias {tuple(bias.shape)} must be "
                             f"({x.shape[1]},)")


def launch(name, x, residual, bias, rate, seed, nv):
    """One launch on checked CUDA tensors, counted under ``name``: the
    vector path with ``nv`` vectors a lane, or the general path for ``nv
    == 0``. A seed tensor (:func:`.common.seed_word`) launches the
    seed-pointer entry, counted under ``{name}_device_seed``."""
    rows, n = x.shape
    keep_prob = 1.0 - rate
    out = torch.empty_like(x)
    seed = seed_word(seed)
    on_device = device_seed(seed, x.device)
    lib = _build.library()
    entry = lib.stf_dropout_residual_seed_ptr if on_device \
        else lib.stf_dropout_residual
    status = entry(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), rows, n,
        seed.data_ptr() if on_device else seed, keep_threshold(keep_prob),
        1.0 / keep_prob, nv, DTYPE_CODES[x.dtype],
        _build.stream_handle(x.device))
    name += "_device_seed" if on_device else ""
    check_status(name, status)
    count_launch(name)
    return out


def _launch(name, x, residual, bias, rate, seed):
    _check(x, residual, bias)
    tensors = [t for t in (x, residual, bias) if t is not None]
    return launch(name, x, residual, bias, rate, seed,
                  vectors_per_lane(*x.shape, x.dtype, *tensors))


def dropout_residual_fwd(x, residual, bias=None, *, rate, seed):
    """The forward on ``(rows, n)`` tensors; CPU tensors take the plain
    version, CUDA tensors launch the kernel of the path
    :func:`vectors_per_lane` picks."""
    tensors = [x, residual] + ([bias] if bias is not None else [])
    if not uses_kernel(*tensors):
        return dropout_residual_fwd_plain(x, residual, bias, rate=rate,
                                          seed=seed)
    return _launch("dropout_residual", x, residual, bias, rate, seed)


def dropout_residual_bwd(g, *, rate, seed):
    """``dx`` on ``(rows, n)``; CPU tensors take the plain version, CUDA
    tensors launch the kernel of the path :func:`vectors_per_lane`
    picks."""
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
