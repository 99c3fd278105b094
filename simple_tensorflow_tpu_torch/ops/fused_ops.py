"""Entry points of the fused kernels, as the JAX package's
``simple_tensorflow_tpu/ops/fused_ops.py`` (``stf.nn.fused_*``) names them:
``fused_attention``, ``fused_bias_dropout_residual``, ``fused_layer_norm``
and ``fused_softmax_cross_entropy``. Each takes either torch tensors or
graph tensors, told apart by its first argument:

- torch tensors (the eager trainers and serving): the call runs its
  kernel module's differentiable wrapper at once, so CPU tensors take the
  plain versions and CUDA tensors launch the kernels;
- graph tensors (``stf.Tensor`` or ``stf.Variable``, user code of the TF-1
  front end): the call builds the JAX package's graph op (``fused_ops.py:
  17-113``: ``FlashAttention``, or ``FlashAttentionDropout`` at a rate
  above 0, with attrs ``causal``/``sm_scale``/``dropout_rate`` and the
  op's ``seed``/``_graph_seed``; ``FusedLayerNorm``; ``FusedSoftmaxXent``;
  ``FusedDropoutBiasResidual``, or the plain add at rate 0), and the
  Session's lowering of that op calls the same wrapper on the run's
  tensors. The two dropout ops draw randomness (``Effects(rng=True)``, so
  never merged) and take their int32 seed from
  ``LoweringContext.seed_for``: ``randint(key, (1,), 0, 2**31 - 1)`` of the
  op's key, a host int, or in a captured step a row of the device seed
  buffer read by the kernels' seed-pointer entries.

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

from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import random_seed as random_seed_mod
from ..framework import tensor_shape as shape_mod
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


def is_graph_value(x) -> bool:
    """A graph tensor or variable (module docstring), not a torch one."""
    return isinstance(x, ops_mod.Tensor) or hasattr(x, "_as_graph_element")


def fused_attention(q, k, v, *, bias=None, dropout_rate=0.0, causal=False,
                    sm_scale=None, seed=None, name=None):
    """Flash attention over ``(batch, heads, seq, head_dim)``; ``bias`` an
    additive ``(batch, kv_seq)`` key bias, constant under
    differentiation; ``dropout_rate > 0`` drops attention probabilities
    with the mask of the int32 ``seed`` (eager), or of the op's per-run
    seed (graph: ``seed`` is then the op seed of ``get_seed``)."""
    if is_graph_value(q):
        return _graph_attention(q, k, v, bias, dropout_rate, causal,
                                sm_scale, seed, name)
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           bias=bias, dropout_rate=float(dropout_rate or 0.0),
                           dropout_seed=seed, plain=using_plain_versions())


def fused_bias_dropout_residual(x, residual, bias=None, *, rate, seed=None,
                                name=None):
    """``residual + dropout(x + bias)``; rate 0 is the plain add the JAX
    function builds at rate 0 (``fused_ops.py:70-72``); rate > 0 runs the
    fused kernel with the mask of the int32 ``seed`` (eager) or builds the
    graph op (graph tensors: ``seed`` is the op seed)."""
    if is_graph_value(x):
        return _graph_dropout_residual(x, residual, bias, rate, seed, name)
    if bias is not None:
        bias = bias.to(x.dtype)
    if not rate or float(rate) <= 0.0:
        return x + bias + residual if bias is not None else x + residual
    if seed is None:
        raise ValueError("fused_bias_dropout_residual with rate > 0 needs "
                         "a seed")
    return dropout_bias_residual(x, residual, bias, rate=float(rate),
                                 seed=seed, plain=using_plain_versions())


def fused_layer_norm(x, gamma, beta, *, eps=1e-6, name=None):
    """LayerNorm over the last axis; gamma/beta ``(features,)`` f32."""
    if is_graph_value(x):
        return _graph_op("FusedLayerNorm", [x, gamma, beta],
                         {"eps": float(eps)}, name or "fused_layer_norm",
                         lambda t: (t[0].shape, t[0].dtype))
    return layer_norm(x, gamma, beta, eps=eps, plain=using_plain_versions())


def fused_softmax_cross_entropy(logits, labels, *, label_smoothing=0.0,
                                name=None):
    """Per-example sparse softmax xent with the TPU kernel's label
    smoothing; ``logits (..., vocab)``, int ``labels (...)``, f32 loss
    ``(...)``."""
    if is_graph_value(logits):
        from ..framework import dtypes as dtypes_mod

        return _graph_op(
            "FusedSoftmaxXent", [logits, labels],
            {"label_smoothing": float(label_smoothing)},
            name or "fused_softmax_xent",
            lambda t: (t[0].shape[:-1] if t[0].shape.rank is not None
                       else shape_mod.TensorShape(None), dtypes_mod.float32))
    return softmax_cross_entropy(logits, labels,
                                 label_smoothing=label_smoothing,
                                 plain=using_plain_versions())


# -- graph ops (JAX ops/fused_ops.py:17-113, lowerings ops/pallas/__init__.py)

def _graph_op(op_type, inputs, attrs, name, spec):
    g = ops_mod.get_default_graph()
    inputs = [ops_mod.convert_to_tensor(t) for t in inputs]
    op = g.create_op(op_type, inputs, attrs=attrs, name=name,
                     output_specs=[spec(inputs)])
    return op.outputs[0]


def _graph_attention(q, k, v, bias, dropout_rate, causal, sm_scale, seed,
                     name):
    inputs = [q, k, v] + ([bias] if bias is not None else [])
    attrs = {"causal": bool(causal), "sm_scale": sm_scale}
    op_type = "FlashAttention"
    if dropout_rate and float(dropout_rate) > 0.0:
        op_type = "FlashAttentionDropout"
        attrs["dropout_rate"] = float(dropout_rate)
        graph_seed, op_seed = random_seed_mod.get_seed(seed)
        attrs["seed"] = op_seed
        attrs["_graph_seed"] = graph_seed
    return _graph_op(op_type, inputs, attrs, name or "flash_attention",
                     lambda t: (t[0].shape, t[0].dtype))


def _graph_dropout_residual(x, residual, bias, rate, seed, name):
    x = ops_mod.convert_to_tensor(x)
    residual = ops_mod.convert_to_tensor(residual)
    if bias is not None:
        bias = ops_mod.convert_to_tensor(bias, dtype=x.dtype.base_dtype)
    if not rate or float(rate) <= 0.0:
        return x + bias + residual if bias is not None else x + residual
    graph_seed, op_seed = random_seed_mod.get_seed(seed)
    inputs = [x, residual] + ([bias] if bias is not None else [])
    return _graph_op("FusedDropoutBiasResidual", inputs,
                     {"rate": float(rate), "seed": op_seed,
                      "_graph_seed": graph_seed},
                     name or "fused_dropout_residual",
                     lambda t: (t[0].shape, t[0].dtype))


def _lower_attention(ctx, op, inputs):
    q, k, v = inputs[:3]
    bias = inputs[3] if len(inputs) > 3 else None
    rate = float(op.attrs.get("dropout_rate", 0.0))
    return [fused_attention(
        q, k, v, bias=bias, causal=op.attrs.get("causal", False),
        sm_scale=op.attrs.get("sm_scale"), dropout_rate=rate,
        seed=ctx.seed_for(op) if rate > 0.0 else None)]


def _lower_dropout_residual(ctx, op, inputs):
    x, residual = inputs[:2]
    bias = inputs[2] if len(inputs) > 2 else None
    return [fused_bias_dropout_residual(x, residual, bias,
                                        rate=float(op.attrs["rate"]),
                                        seed=ctx.seed_for(op))]


op_registry.register("FlashAttention", lower=_lower_attention)
op_registry.register("FlashAttentionDropout", lower=_lower_attention,
                     effects=op_registry.Effects(rng=True))
op_registry.register("FusedDropoutBiasResidual",
                     lower=_lower_dropout_residual,
                     effects=op_registry.Effects(rng=True))
op_registry.register(
    "FusedLayerNorm", lower=lambda ctx, op, inputs: [fused_layer_norm(
        *inputs, eps=float(op.attrs.get("eps", 1e-6)))])
op_registry.register(
    "FusedSoftmaxXent", lower=lambda ctx, op, inputs: [
        fused_softmax_cross_entropy(
            *inputs, label_smoothing=op.attrs["label_smoothing"])])
