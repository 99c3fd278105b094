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

The sampled losses of the word2vec graph, :272-343 there:
``_sampled_logits`` (the true and the sampled logits from one gather of
the weights and one of the biases, the log expected counts subtracted),
``nce_loss`` (sigmoid cross entropy over them) and
``sampled_softmax_loss``; ``remove_accidental_hits`` is taken and, as
there, not applied.
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


def _sampled_logits(weights, biases, labels, inputs, num_sampled, num_classes,
                    num_true, sampled_values, subtract_log_q, name):
    """Shared by nce_loss / sampled_softmax_loss
    (ref: nn_impl.py ``_compute_sampled_logits``)."""
    from . import array_ops, candidate_sampling_ops, embedding_ops, math_ops

    if not isinstance(weights, (list, tuple)):
        weights = [weights]
    if len(weights) != 1:
        raise NotImplementedError("a sharded weight list is not ported")
    inputs = ops_mod.convert_to_tensor(inputs)
    labels = math_ops.cast(ops_mod.convert_to_tensor(labels), "int32")
    if sampled_values is None:
        sampled_values = candidate_sampling_ops.log_uniform_candidate_sampler(
            true_classes=math_ops.cast(labels, "int64"), num_true=num_true,
            num_sampled=num_sampled, unique=True, range_max=num_classes)
    sampled, true_expected, sampled_expected = sampled_values
    sampled = math_ops.cast(sampled, "int32")
    labels_flat = array_ops.reshape(labels, [-1])
    all_ids = array_ops.concat([labels_flat, sampled], 0)
    all_w = embedding_ops.embedding_lookup(weights[0], all_ids)
    all_b = embedding_ops.embedding_lookup(biases, all_ids)
    n_true_total = labels_flat.shape[0].value
    true_w = all_w[:n_true_total]
    sampled_w = all_w[n_true_total:]
    true_b = all_b[:n_true_total]
    sampled_b = all_b[n_true_total:]
    dim = inputs.shape[-1].value
    true_w = array_ops.reshape(true_w, [-1, num_true, dim])
    true_logits = math_ops.reduce_sum(
        array_ops.expand_dims(inputs, 1) * true_w, axis=2)
    true_logits += array_ops.reshape(true_b, [-1, num_true])
    sampled_logits = math_ops.matmul(inputs, sampled_w, transpose_b=True)
    sampled_logits += sampled_b
    if subtract_log_q:
        true_logits -= math_ops.log(true_expected)
        sampled_logits -= math_ops.log(sampled_expected)
    out_logits = array_ops.concat([true_logits, sampled_logits], 1)
    out_labels = array_ops.concat([
        array_ops.ones_like(true_logits) / num_true,
        array_ops.zeros_like(sampled_logits)], 1)
    return out_logits, out_labels


def nce_loss(weights, biases, labels, inputs, num_sampled, num_classes,
             num_true=1, sampled_values=None, remove_accidental_hits=False,
             partition_strategy="mod", name="nce_loss"):
    """(ref: nn_impl.py ``nce_loss``)."""
    from . import math_ops, nn_ops

    logits, labels_out = _sampled_logits(
        weights, biases, labels, inputs, num_sampled, num_classes, num_true,
        sampled_values, subtract_log_q=True, name=name)
    xent = nn_ops.sigmoid_cross_entropy_with_logits(labels=labels_out,
                                                    logits=logits)
    return math_ops.reduce_sum(xent, axis=1)


def sampled_softmax_loss(weights, biases, labels, inputs, num_sampled,
                         num_classes, num_true=1, sampled_values=None,
                         remove_accidental_hits=True,
                         partition_strategy="mod",
                         name="sampled_softmax_loss"):
    """(ref: nn_impl.py ``sampled_softmax_loss``)."""
    from . import nn_ops

    logits, labels_out = _sampled_logits(
        weights, biases, labels, inputs, num_sampled, num_classes, num_true,
        sampled_values, subtract_log_q=True, name=name)
    return nn_ops.softmax_cross_entropy_with_logits(labels=labels_out,
                                                    logits=logits)
