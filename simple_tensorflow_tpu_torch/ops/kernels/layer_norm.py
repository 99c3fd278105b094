"""LayerNorm forward and backward: the CUDA kernels ``csrc/layer_norm.cu``
and their plain PyTorch versions.

Replaces the TPU kernels ``simple_tensorflow_tpu/ops/pallas/layer_norm.py:
_fwd_kernel`` (called at :71) and ``_bwd_kernel`` (called at :109). The
forward returns the row statistics ``mean``/``rstd`` (f32) beside the
output when asked, as ``_fwd`` does, and the backward reads them.
:func:`layer_norm` is differentiable through :class:`LayerNormFunction`
(the JAX ``custom_vjp``). Bounded by bytes on the card: each element is
read and written once. Both kernels have a vector path, a warp per row
holding the row in registers as 16-byte vectors, for the rows
:func:`vectors_per_lane` admits (the model widths 256-1024, BERT's 768
among them), and a general strided path for any other width or a
misaligned view; the source note in ``csrc/layer_norm.cu`` says more.
"""

from __future__ import annotations

import torch

from . import _build
from .common import (DTYPE_CODES, cdiv, check_cuda_arg, check_status,
                     count_launch, uses_kernel)

# rows of one backward block: its column partial sums are one row of the
# (blocks, n) workspace the second pass reduces. The general path's block
# of 256 threads walks 32 rows; the vector path's 8 warps walk 2 rows each
# (256 blocks at the training shape's 4096 rows)
BWD_ROWS_PER_BLOCK = 32
BWD_VEC_ROWS_PER_BLOCK = 16
# 16-byte vectors a lane the vector paths (forward and backward) hold: at
# most 32 values a lane (kMaxNv in the .cu)
VEC_NV = {torch.bfloat16: (1, 2, 3, 4),
          torch.float32: (1, 2, 3, 4, 5, 6, 7, 8)}


def layer_norm_plain(x, gamma, beta, *, eps=1e-6, return_stats=False):
    """Row LayerNorm over the last axis with f32 statistics and the
    centred variance; output in x's dtype. With ``return_stats`` also the
    f32 ``mean`` and ``rstd`` of each row, shaped ``x.shape[:-1]``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (xc * rstd * gamma.float() + beta.float()).to(x.dtype)
    if return_stats:
        return y, mean[..., 0], rstd[..., 0]
    return y


def layer_norm_bwd_plain(x, gamma, mean, rstd, dout):
    """The backward of ``_bwd_kernel``: ``(dx, dgamma, dbeta)`` for
    ``x, dout (rows, n)``, f32 ``gamma (n,)`` and the forward's f32
    ``mean``/``rstd (rows,)``. dx in x's dtype; dgamma/dbeta in gamma's."""
    xf = x.float()
    do = dout.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    wdo = do * gamma.float()
    c1 = wdo.mean(dim=-1, keepdim=True)
    c2 = (wdo * xhat).mean(dim=-1, keepdim=True)
    dx = ((wdo - c1 - xhat * c2) * rstd[:, None]).to(x.dtype)
    dg = (do * xhat).sum(dim=0).to(gamma.dtype)
    db = do.sum(dim=0).to(gamma.dtype)
    return dx, dg, db


def _check_affine(n, gamma, beta):
    check_cuda_arg("gamma", gamma, (torch.float32,), 1)
    check_cuda_arg("beta", beta, (torch.float32,), 1)
    if gamma.shape[0] != n or beta.shape[0] != n:
        raise ValueError(f"gamma/beta must be ({n},), got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")


def layer_norm_fwd(x, gamma, beta, *, eps=1e-6, return_stats=False):
    """The forward kernel on ``x (..., n)`` with f32 ``gamma``/``beta
    (n,)``: ``y`` or, with ``return_stats``, ``(y, mean, rstd)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel: the
    vector path (a warp per row) where :func:`vectors_per_lane` of ``x``,
    ``y``, ``gamma`` and ``beta`` is not 0, else the general path."""
    if not uses_kernel(x, gamma, beta):
        return layer_norm_plain(x, gamma, beta, eps=eps,
                                return_stats=return_stats)
    n = x.shape[-1]
    x2 = x.reshape(-1, n)
    check_cuda_arg("x", x2, DTYPE_CODES, 2)
    _check_affine(n, gamma, beta)
    out = launch_fwd(x2, gamma, beta, eps, return_stats,
                     vectors_per_lane(n, x2.dtype, x2, gamma, beta))
    if return_stats:
        y, mean, rstd = out
        lead = x.shape[:-1]
        return y.reshape(x.shape), mean.reshape(lead), rstd.reshape(lead)
    return out.reshape(x.shape)


def launch_fwd(x2, gamma, beta, eps, return_stats, nv):
    """One forward on checked CUDA tensors ``x2 (rows, n)``: the vector
    path with ``nv`` vectors a lane, or the general path for ``nv == 0``
    (the output is allocated 16-byte aligned, as ``nv`` assumes)."""
    rows, n = x2.shape
    y = torch.empty_like(x2)
    mean = rstd = None
    if return_stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
        rstd = torch.empty(rows, dtype=torch.float32, device=x2.device)
    status = _build.library().stf_layer_norm_fwd(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr() if return_stats else None,
        rstd.data_ptr() if return_stats else None,
        rows, n, float(eps), nv, DTYPE_CODES[x2.dtype],
        _build.stream_handle(x2.device))
    check_status("layer_norm", status)
    count_launch("layer_norm")
    return (y, mean, rstd) if return_stats else y


def vectors_per_lane(n, dtype, *tensors) -> int:
    """Which kernel, forward or backward, takes rows of ``n`` values of
    ``dtype``: the vector path's 16-byte vectors a lane (a warp per row,
    ``n == 32 * nv * 16 / element size`` with ``nv`` in ``VEC_NV``, every
    tensor's data 16-byte aligned), or 0 for the general strided path."""
    per_vec = 16 // (torch.finfo(dtype).bits // 8)
    nv, rem = divmod(n, 32 * per_vec)
    if rem or nv not in VEC_NV[dtype] or \
            any(t.data_ptr() % 16 for t in tensors):
        return 0
    return nv


def layer_norm_bwd(x, gamma, mean, rstd, dout):
    """The backward kernel: ``(dx, dgamma, dbeta)`` for ``x, dout (rows,
    n)`` and the forward's ``mean``/``rstd (rows,)``. CPU tensors take the
    plain version; CUDA tensors launch the kernel of the path
    :func:`vectors_per_lane` picks (dx and the per-block column
    partials, then the fixed-order reduction of the partials)."""
    if not uses_kernel(x, gamma, mean, rstd, dout):
        return layer_norm_bwd_plain(x, gamma, mean, rstd, dout)
    check_cuda_arg("x", x, DTYPE_CODES, 2)
    check_cuda_arg("dout", dout, (x.dtype,), 2)
    check_cuda_arg("gamma", gamma, (torch.float32,), 1)
    check_cuda_arg("mean", mean, (torch.float32,), 1)
    check_cuda_arg("rstd", rstd, (torch.float32,), 1)
    rows, n = x.shape
    if tuple(dout.shape) != (rows, n) or gamma.shape[0] != n or \
            mean.shape[0] != rows or rstd.shape[0] != rows:
        raise ValueError(
            f"layer_norm_bwd: x {tuple(x.shape)}, dout {tuple(dout.shape)}, "
            f"gamma {tuple(gamma.shape)}, mean {tuple(mean.shape)}, rstd "
            f"{tuple(rstd.shape)} do not agree")
    return launch_bwd(x, gamma, mean, rstd, dout,
                      vectors_per_lane(n, x.dtype, x, dout, gamma))


def launch_bwd(x, gamma, mean, rstd, dout, nv):
    """One backward on checked CUDA tensors: the vector path with ``nv``
    vectors a lane, or the general path for ``nv == 0``."""
    rows, n = x.shape
    dx = torch.empty_like(x)
    dg = torch.empty(n, dtype=torch.float32, device=x.device)
    db = torch.empty(n, dtype=torch.float32, device=x.device)
    rpb = BWD_VEC_ROWS_PER_BLOCK if nv else BWD_ROWS_PER_BLOCK
    part = torch.empty((2, cdiv(rows, rpb), n), dtype=torch.float32,
                       device=x.device)
    status = _build.library().stf_layer_norm_bwd(
        x.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dout.data_ptr(), dx.data_ptr(), part.data_ptr(), dg.data_ptr(),
        db.data_ptr(), rows, n, rpb, nv, DTYPE_CODES[x.dtype],
        _build.stream_handle(x.device))
    check_status("layer_norm_bwd", status)
    count_launch("layer_norm_bwd")
    return dx, dg, db


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with the backward kernel as its gradient (the JAX
    ``_layer_norm_2d`` custom VJP): forward saves ``x``, ``gamma`` and the
    row statistics, backward runs :func:`layer_norm_bwd`. ``plain=True``
    runs the plain versions of both on any device (the reference the
    kernels are held against)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, plain):
        n = x.shape[-1]
        x2 = x.reshape(-1, n)
        if not x2.is_contiguous():
            x2 = x2.contiguous()
        fwd = layer_norm_plain if plain else layer_norm_fwd
        y, mean, rstd = fwd(x2, gamma, beta, eps=eps, return_stats=True)
        ctx.save_for_backward(x2, gamma, mean, rstd)
        ctx.x_shape = x.shape
        ctx.plain = plain
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, gamma, mean, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape)
        if not dy2.is_contiguous():
            dy2 = dy2.contiguous()
        bwd = layer_norm_bwd_plain if ctx.plain else layer_norm_bwd
        dx, dg, db = bwd(x2, gamma, mean, rstd, dy2)
        return dx.reshape(ctx.x_shape), dg, db, None, None


def layer_norm(x, gamma, beta, *, eps=1e-6, plain=False):
    """LayerNorm over the last axis of ``x (..., n)`` with f32 ``gamma``
    and ``beta (n,)``. Differentiable (the backward kernel) when autograd
    records; otherwise the forward kernel alone, with no statistics kept.
    CPU tensors take the plain versions; CUDA tensors launch the kernels.
    ``plain=True`` runs the plain versions on any device."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return LayerNormFunction.apply(x, gamma, beta, eps, plain)
    fwd = layer_norm_plain if plain else layer_norm_fwd
    return fwd(x, gamma, beta, eps=eps)
