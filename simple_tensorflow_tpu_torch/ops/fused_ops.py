"""Entry points of the fused kernels, as the JAX package's
``simple_tensorflow_tpu/ops/fused_ops.py`` (``stf.nn.fused_*``) names them:
``fused_attention``, ``fused_bias_dropout_residual``, ``fused_layer_norm``
and ``fused_softmax_cross_entropy``. Each calls its kernel module's
differentiable wrapper, so CPU tensors take the plain versions and CUDA
tensors launch the kernels.

:func:`plain_versions` runs every one of them through the kernels' plain
PyTorch versions on any device: the reference the kernels are held
against on the card. A trainer built with ``plain=True``
(:func:`..models.causal_lm.causal_lm_train_model`,
:func:`..models.resnet.resnet50_train_model`) enters it and gives its
optimizer the plain Adam or Momentum update; nothing else enters it, and
the kernel wrappers themselves never fall back.

Dropout (``rate > 0``) takes an int32 ``seed`` and draws the JAX
kernels' counter-hash mask from it (the JAX lowering draws that seed from
the op's per-step stream; the port's trainer passes it in).
"""

from __future__ import annotations

import contextlib
import threading

from .kernels.dropout_residual import dropout_bias_residual
from .kernels.flash_attention import flash_attention
from .kernels.layer_norm import layer_norm
from .kernels.softmax_xent import softmax_cross_entropy

_state = threading.local()


@contextlib.contextmanager
def plain_versions():
    """Within the block, on this thread, the fused ops run their kernels'
    plain PyTorch versions on any device."""
    prev = using_plain_versions()
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def using_plain_versions() -> bool:
    return getattr(_state, "plain", False)


def fused_attention(q, k, v, *, bias=None, dropout_rate=0.0, causal=False,
                    sm_scale=None, seed=None):
    """Flash attention over ``(batch, heads, seq, head_dim)``; ``bias`` an
    additive ``(batch, kv_seq)`` key bias, constant under
    differentiation; ``dropout_rate > 0`` drops attention probabilities
    with the mask of the int32 ``seed``."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           bias=bias, dropout_rate=float(dropout_rate or 0.0),
                           dropout_seed=seed, plain=using_plain_versions())


def fused_bias_dropout_residual(x, residual, bias=None, *, rate, seed=None):
    """``residual + dropout(x + bias)``; rate 0 is the plain add the JAX
    function builds at rate 0 (``fused_ops.py:70-72``); rate > 0 runs the
    fused kernel with the mask of the int32 ``seed``."""
    if bias is not None:
        bias = bias.to(x.dtype)
    if not rate or float(rate) <= 0.0:
        return x + bias + residual if bias is not None else x + residual
    if seed is None:
        raise ValueError("fused_bias_dropout_residual with rate > 0 needs "
                         "a seed")
    return dropout_bias_residual(x, residual, bias, rate=float(rate),
                                 seed=seed, plain=using_plain_versions())


def fused_layer_norm(x, gamma, beta, *, eps=1e-6):
    """LayerNorm over the last axis; gamma/beta ``(features,)`` f32."""
    return layer_norm(x, gamma, beta, eps=eps, plain=using_plain_versions())


def fused_softmax_cross_entropy(logits, labels, *, label_smoothing=0.0):
    """Per-example sparse softmax xent with the TPU kernel's label
    smoothing; ``logits (..., vocab)``, int ``labels (...)``, f32 loss
    ``(...)``."""
    return softmax_cross_entropy(logits, labels,
                                 label_smoothing=label_smoothing,
                                 plain=using_plain_versions())
