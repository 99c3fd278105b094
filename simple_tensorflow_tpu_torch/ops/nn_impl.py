"""Fused batch normalisation, as the JAX package computes it.

Port of ``simple_tensorflow_tpu/ops/nn_impl.py``: ``_bn_train`` with its
custom VJP (:46-120), ``_fused_bn_impl`` (:123-146), the ``FusedBatchNorm``
graph op (:146) and ``fused_batch_norm`` (:180). BatchNorm has no Pallas
kernel there, so this is plain PyTorch on both devices. It is not
``F.batch_norm`` (nor cuDNN's): those take another variance, apply in
another order and save other residuals, so their numbers differ from the
JAX program's. Here, op for op as in ``_bn_train_fwd_impl``/``_bn_train_bwd``:

- statistics in f32 over every axis but the channel axis (last: NHWC);
  for half-precision input the one-pass ``E[x^2] - E[x]^2`` clipped at
  0, for f32 input the centred two-pass variance;
- the apply step subtracts first, in the input dtype: ``(x - mean) *
  (inv * gamma) + beta``, each factor cast to ``x``'s dtype;
- the backward saves only ``x`` and per-channel f32 statistics,
  recomputes ``x_hat`` from ``x``, and takes the cotangents of the mean
  and variance outputs too (where the caller uses them).

:func:`fused_batch_norm` takes torch tensors (the eager
``BatchNormalizationModule``: it runs at once) or graph tensors (the graph
``BatchNormalization`` layer: it builds the three-output ``FusedBatchNorm``
op, whose lowering is the same function and whose gradient is autograd's
through :class:`FusedBatchNormFunction`). NHWC only.
"""

from __future__ import annotations

import torch

from ..framework import graph as ops_mod
from ..framework import op_registry
from .fused_ops import is_graph_value
from .op_util import make_op

_HALF = (torch.bfloat16, torch.float16)


def _stats(x, red):
    xf = x.float()
    mean = xf.mean(dim=red)
    if x.dtype in _HALF:
        meansq = torch.square(xf).mean(dim=red)
        var = torch.clamp_min(meansq - torch.square(mean), 0.0)
    else:
        var = torch.square(xf - mean).mean(dim=red)
    return mean, var


class FusedBatchNormFunction(torch.autograd.Function):
    """Training-mode batch norm over the last axis: ``(y, batch_mean,
    batch_var)`` for ``x (..., C)`` and f32 ``scale``/``offset (C,)``;
    ``y`` in ``x``'s dtype, the statistics f32 (the JAX ``_bn_train``
    and its VJP)."""

    @staticmethod
    def forward(ctx, x, scale, offset, epsilon):
        red = tuple(range(x.dim() - 1))
        mean, var = _stats(x, red)
        inv = torch.rsqrt(var + epsilon)
        y = ((x - mean.to(x.dtype)) * (inv * scale.float()).to(x.dtype)
             + offset.to(x.dtype))
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, mean, inv = ctx.saved_tensors
        red = tuple(range(x.dim() - 1))
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, JAX by the f32 count
        n = torch.full((), float(x.numel() // x.shape[-1]),
                       dtype=torch.float32, device=x.device)
        xc = x.float() - mean
        x_hat = xc * inv
        dyf = (dy.float() if dy is not None
               else torch.zeros_like(x_hat))
        sum_dy = dyf.sum(dim=red)
        sum_dy_xhat = (dyf * x_hat).sum(dim=red)
        dx = (scale.float() * inv) * (dyf - sum_dy / n
                                      - x_hat * (sum_dy_xhat / n))
        if dmean is not None:
            dx = dx + dmean.float() / n
        if dvar is not None:
            dx = dx + (2.0 * dvar.float() / n) * xc
        return (dx.to(x.dtype), sum_dy_xhat.to(scale.dtype),
                sum_dy.to(scale.dtype), None)


def _fused_bn_impl(x, scale, offset, mean=None, variance=None,
                   epsilon=1e-3, is_training=True, data_format="NHWC"):
    """``(y, batch_mean, batch_var)`` over the last axis of NHWC ``x``.
    Training: batch statistics (:class:`FusedBatchNormFunction`,
    differentiable). Inference: the given ``mean``/``variance`` (f32),
    ``(x - mean) * (rsqrt(var + eps) * scale) + offset`` in ``x``'s
    dtype; they come back as the statistics."""
    if data_format != "NHWC":
        raise NotImplementedError(f"FusedBatchNorm data_format "
                                  f"{data_format!r} is not ported (NHWC)")
    if is_training:
        return list(FusedBatchNormFunction.apply(x, scale, offset,
                                                 float(epsilon)))
    if mean is None or variance is None:
        raise ValueError("fused_batch_norm inference needs mean/variance")
    batch_mean, batch_var = mean.float(), variance.float()
    inv = torch.rsqrt(batch_var + epsilon) * scale.float()
    y = (x - batch_mean.to(x.dtype)) * inv.to(x.dtype) + offset.to(x.dtype)
    return [y, batch_mean, batch_var]


op_registry.register_pure("FusedBatchNorm", _fused_bn_impl)


def fused_batch_norm(x, scale, offset, mean=None, variance=None,
                     epsilon=1e-3, data_format="NHWC", is_training=True,
                     name=None):
    """(ref: nn_impl.py ``fused_batch_norm``) ``(y, batch_mean,
    batch_var)``: for graph tensors the ``FusedBatchNorm`` op (module
    docstring), for torch tensors :func:`_fused_bn_impl` at once."""
    if not is_graph_value(x):
        return tuple(_fused_bn_impl(x, scale, offset, mean, variance,
                                    epsilon, is_training, data_format))
    x = ops_mod.convert_to_tensor(x)
    scale = ops_mod.convert_to_tensor(scale, dtype="float32")
    offset = ops_mod.convert_to_tensor(offset, dtype="float32")
    inputs = [x, scale, offset]
    if not is_training:
        if mean is None or variance is None:
            raise ValueError("fused_batch_norm inference needs mean/variance")
        inputs += [ops_mod.convert_to_tensor(mean, dtype="float32"),
                   ops_mod.convert_to_tensor(variance, dtype="float32")]
    y, m, v = make_op(
        "FusedBatchNorm", inputs,
        attrs={"epsilon": float(epsilon), "is_training": is_training,
               "data_format": data_format}, name=name, n_out=3)
    return y, m, v
