"""``stf.nn`` ops of the port, with the JAX package's layouts at their
boundaries (NHWC activations, HWIO filters, TF ``SAME``/``VALID``
padding).

The graph functions mirror ``simple_tensorflow_tpu/ops/nn_ops.py``:
``relu`` (:423), ``gelu`` (:439; ``Gelu``, default the tanh form of
``jax.nn.gelu``, which ``F.gelu(approximate="tanh")`` computes in one
kernel where XLA rounds a bf16 input after each step of it), ``l2_loss``
(:485), ``bias_add`` (:489), ``conv2d``
(:538), ``max_pool`` (:665), ``dropout`` (:699),
``softmax_cross_entropy_with_logits`` (:496),
``sparse_softmax_cross_entropy_with_logits`` (:509) and
``sigmoid_cross_entropy_with_logits`` (:519; ``SigmoidCrossEntropyWithLogits``
with the JAX lowering's arithmetic, :158-161) build graph ops, and
``weighted_cross_entropy_with_logits`` (:526) composes them;
their lowerings call the eager implementations below, as the JAX module's
lowerings call its ``_conv2d_impl`` (:164) and ``_max_pool_impl`` (:352):

- ``_dropout_impl``, as ``_dropout_lower`` (:388-398) draws it: JAX's
  threefry bits from an explicit key (a session derives the key per run
  and per op; :class:`..framework.random_seed.StepRNG` is the eager
  trainers' counterpart). It runs the Dropout kernel, or its plain version
  under :func:`.fused_ops.plain_versions`.
- ``_conv2d_impl`` and ``_max_pool_impl``: a plain convolution is left to
  ``F.conv2d`` (cuDNN on the card), as the JAX package leaves it to XLA
  outside any Pallas kernel. PyTorch's ``padding=`` is symmetric, so TF
  ``SAME`` padding, which puts the odd element at the bottom/right
  (stride 2), is padded explicitly.
- ``_relu_impl``, ``_l2_loss_impl`` (:53) and
  ``_sparse_softmax_xent_impl`` (:67-109), the last through the
  softmax-xent kernels without smoothing: the function the JAX registry's
  routed lowering computes (:92-104); logits of any rank go to the
  kernels as rows (``[B, T, V]`` with ``[B, T]`` labels: one ``[B*T,
  V]`` view, copied only when not contiguous).
- ``Softmax`` (:49, ``softmax``): ``torch.softmax`` along its axis;
  ``LogSoftmax`` (:50, ``log_softmax`` :479) as ``jax.nn.log_softmax``
  computes it; ``TopKV2`` (:417, ``top_k`` :761) as ``lax.top_k``
  orders it, ties to the lower index (beam search's bf16 logits tie
  often).

Left out of the graph ops: NCHW data formats, dilations, the other
activations, pools and convolutions.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import random_seed as random_seed_mod
from .fused_ops import using_plain_versions
from .kernels.dropout import DropoutFunction
from .kernels.softmax_xent import softmax_cross_entropy
from .math_ops import abs_impl
from .op_util import make_op, unary

Tensor = ops_mod.Tensor


def _dropout_impl(x, keep_prob: float, key):
    """``where(uniform(key, x.shape) < keep_prob, x / keep_prob, 0)``
    with ``keep_prob`` in ``x``'s dtype for the division; ``key`` is a raw
    threefry key (two uint32 words, or a ``(2,)`` int32 device tensor of
    their bits: :mod:`.kernels.dropout`). ``keep_prob == 1`` returns
    ``x``, as the JAX function does; one that rounds to 0 in f32 (below
    about 7e-46) is refused on every device. Differentiable."""
    keep_prob = float(keep_prob)
    if not (0.0 < np.float32(keep_prob) and keep_prob <= 1.0):
        raise ValueError(f"keep_prob must be in (0, 1] in f32: {keep_prob}")
    if keep_prob == 1.0:
        return x
    if not isinstance(key, torch.Tensor):
        key = tuple(int(w) for w in key)
    return DropoutFunction.apply(x, keep_prob, key, using_plain_versions())


def _relu_impl(x):
    return torch.relu(x)


def _l2_loss_impl(x):
    """``0.5 * sum(x**2)`` summed in f32, cast back to ``x``'s dtype."""
    return (0.5 * torch.sum(torch.square(x.float()))).to(x.dtype)


def _sparse_softmax_xent_impl(labels, logits):
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


def _conv2d_impl(x, filter, strides, padding):  # noqa: A002 (the TF name)
    """2-D convolution of NHWC ``x`` with an HWIO ``filter``, NHWC out.
    Strides ``[1, sh, sw, 1]``. The filter is handed to ``F.conv2d`` as
    the OIHW tensor it views (a port ``Conv2DModule`` stores its kernel
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


def _max_pool_impl(x, ksize, strides, padding):
    """Max pooling of NHWC ``x``; ``ksize``/``strides`` ``[1, h, w, 1]``;
    ``SAME`` pads with -inf, as ``reduce_window`` with a -inf init."""
    kh, kw = _spatial(ksize, "ksize")
    sh, sw = _spatial(strides, "strides")
    (pt, pb), (pl, pr) = _pads(x, (kh, kw), (sh, sw), padding)
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), (kh, kw), stride=(sh, sw))
    return y.permute(0, 2, 3, 1)


# -- graph ops ---------------------------------------------------------------

def _nhwc(data_format):
    if (data_format or "NHWC") != "NHWC":
        raise NotImplementedError(f"data_format {data_format!r} is not "
                                  "ported (NHWC only)")


def _conv2d_op(x, w, strides=(1, 1, 1, 1), padding="SAME",
               data_format="NHWC", dilations=(1, 1, 1, 1)):
    _nhwc(data_format)
    if tuple(dilations) != (1, 1, 1, 1):
        raise NotImplementedError("dilated conv2d is not ported")
    return _conv2d_impl(x, w, strides, padding)


def _max_pool_op(x, ksize=None, strides=None, padding="VALID",
                 data_format="NHWC"):
    _nhwc(data_format)
    return _max_pool_impl(x, ksize, strides, padding)


def _bias_add_op(x, b, data_format="NHWC"):
    _nhwc(data_format)
    return x + b


def _softmax_xent(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-(labels.float() * logp).sum(dim=-1)).to(logits.dtype)


op_registry.register_pure("Relu", _relu_impl)
op_registry.register_pure("L2Loss", _l2_loss_impl)
op_registry.register_pure("Gelu", lambda x, approximate=True: F.gelu(
    x, approximate="tanh" if approximate else "none"))
op_registry.register_pure("BiasAdd", _bias_add_op)
op_registry.register_pure("Conv2D", _conv2d_op)
op_registry.register_pure("MaxPool", _max_pool_op)
op_registry.register_pure("SoftmaxCrossEntropyWithLogits", _softmax_xent)
op_registry.register_pure(
    "SigmoidCrossEntropyWithLogits",
    # torch.maximum splits a tie's gradient in halves, as lax.max does;
    # |x| differentiates as lax.abs does, to 1 at 0
    lambda logits, labels: (torch.maximum(logits, torch.zeros_like(logits))
                            - logits * labels
                            + torch.log1p(torch.exp(-abs_impl(logits)))))


def _log_softmax_impl(x, axis=-1):
    """``jax.nn.log_softmax``'s arithmetic: the max-shifted input less the
    log of its exponentials' sum."""
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=axis,
                                                       keepdim=True))


def _top_k_impl(x, k=1, sorted=True):  # noqa: A002 (the TF name)
    """``lax.top_k``: the k largest along the last axis, descending, a
    tie taking the lower index first (a stable descending sort, not
    ``torch.topk``, which orders no ties); int32 indices."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return [values[..., :k], indices[..., :k].to(torch.int32)]


op_registry.register_pure("LogSoftmax", _log_softmax_impl)
op_registry.register_pure("TopKV2", _top_k_impl)
op_registry.register_pure("Softmax", lambda x, axis=-1: torch.softmax(
    x, dim=axis))


def _lower_sparse_xent(ctx, op, inputs):
    logits, labels = inputs
    return [_sparse_softmax_xent_impl(labels, logits)]


def _infer_sparse_xent(graph, attrs, inputs):
    logits, labels = inputs
    return [(labels.shape, logits.dtype.base_dtype)]


op_registry.register("SparseSoftmaxCrossEntropyWithLogits",
                     lower=_lower_sparse_xent, infer_fn=_infer_sparse_xent)


def _lower_dropout(ctx, op, inputs):
    """The JAX lowering's draw (``u = uniform(key, x.shape)``, keep ``u <
    keep_prob``) through the Dropout kernel, its key from
    :meth:`LoweringContext.rng_key` (a device-buffer row in a compiled
    step); a tensor ``keep_prob`` is read on the host
    (:meth:`LoweringContext.host_value`: a feed or a constant default
    costs no sync, anything else one ``.item()``, which a compiled step
    refuses)."""
    x = inputs[0]
    keep_prob = op.attrs["keep_prob"]
    if keep_prob is None:
        keep_prob = ctx.host_value(op.inputs[1], op)
    ns = op.attrs.get("noise_shape")
    if ns is not None and tuple(ns) != tuple(x.shape):
        raise NotImplementedError("dropout noise_shape other than the "
                                  "input's shape is not ported")
    return [_dropout_impl(x, keep_prob, ctx.rng_key(op))]


op_registry.register("Dropout", lower=_lower_dropout,
                     effects=op_registry.Effects(rng=True))


def relu(features, name=None):
    return unary("Relu", features, name)


def softmax(logits, axis=-1, name=None, dim=None):
    if dim is not None:
        axis = dim
    return unary("Softmax", logits, name, attrs={"axis": int(axis)})


def log_softmax(logits, axis=-1, name=None, dim=None):
    if dim is not None:
        axis = dim
    return unary("LogSoftmax", logits, name, attrs={"axis": int(axis)})


def top_k(input, k=1, sorted=True, name=None):  # noqa: A002
    x = ops_mod.convert_to_tensor(input)
    values, indices = make_op("TopKV2", [x], attrs={"k": int(k),
                                                    "sorted": sorted},
                              name=name, n_out=2)
    return values, indices


def gelu(features, approximate=True, name=None):
    return unary("Gelu", features, name, attrs={"approximate": approximate})


def l2_loss(t, name=None):
    return unary("L2Loss", t, name)


def bias_add(value, bias, data_format="NHWC", name=None):
    value = ops_mod.convert_to_tensor(value)
    bias = ops_mod.convert_to_tensor(bias, dtype=value.dtype.base_dtype)
    return make_op("BiasAdd", [value, bias],
                   attrs={"data_format": data_format or "NHWC"}, name=name)


def softmax_cross_entropy_with_logits(labels=None, logits=None, dim=-1,
                                      name=None, _sentinel=None):
    if _sentinel is not None:
        raise ValueError("Use named arguments for "
                         "softmax_cross_entropy_with_logits")
    logits = ops_mod.convert_to_tensor(logits)
    labels = ops_mod.convert_to_tensor(labels, dtype=logits.dtype.base_dtype)
    return make_op("SoftmaxCrossEntropyWithLogits", [logits, labels],
                   name=name)


softmax_cross_entropy_with_logits_v2 = softmax_cross_entropy_with_logits


def sigmoid_cross_entropy_with_logits(labels=None, logits=None, name=None,
                                      _sentinel=None):
    logits = ops_mod.convert_to_tensor(logits)
    labels = ops_mod.convert_to_tensor(labels, dtype=logits.dtype.base_dtype)
    return make_op("SigmoidCrossEntropyWithLogits", [logits, labels],
                   name=name)


def weighted_cross_entropy_with_logits(targets, logits, pos_weight,
                                       name=None):
    from . import math_ops

    logits = ops_mod.convert_to_tensor(logits)
    targets = ops_mod.convert_to_tensor(targets,
                                        dtype=logits.dtype.base_dtype)
    log_weight = 1 + (pos_weight - 1) * targets
    return math_ops.add(
        (1 - targets) * logits,
        log_weight * (math_ops.log1p(math_ops.exp(-math_ops.abs(logits)))
                      + relu(-logits)), name=name)


def sparse_softmax_cross_entropy_with_logits(labels=None, logits=None,
                                             name=None, _sentinel=None):
    logits = ops_mod.convert_to_tensor(logits)
    labels = ops_mod.convert_to_tensor(labels)
    if not labels.dtype.is_integer:
        raise TypeError("labels must be integer class ids")
    return make_op("SparseSoftmaxCrossEntropyWithLogits", [logits, labels],
                   name=name)


def conv2d(input, filter=None, strides=None, padding=None,  # noqa: A002
           use_cudnn_on_gpu=True, data_format="NHWC", dilations=None,
           name=None, filters=None):
    """2-D convolution (ref: nn_ops.py ``conv2d``)."""
    w = filters if filters is not None else filter
    x = ops_mod.convert_to_tensor(input)
    w = ops_mod.convert_to_tensor(w, dtype=x.dtype.base_dtype)
    strides = strides or [1, 1, 1, 1]
    if isinstance(strides, int):
        strides = [1, strides, strides, 1]
    dilations = dilations or [1, 1, 1, 1]
    if isinstance(dilations, int):
        dilations = [1, dilations, dilations, 1]
    return make_op("Conv2D", [x, w],
                   attrs={"strides": builtins.tuple(strides),
                          "padding": padding or "SAME",
                          "data_format": data_format or "NHWC",
                          "dilations": builtins.tuple(dilations)},
                   name=name)


def max_pool(value, ksize, strides, padding, data_format="NHWC", name=None):
    x = ops_mod.convert_to_tensor(value)
    return make_op("MaxPool", [x],
                   attrs={"ksize": builtins.tuple(ksize),
                          "strides": builtins.tuple(strides),
                          "padding": padding,
                          "data_format": data_format or "NHWC"}, name=name)


def dropout(x, keep_prob=None, noise_shape=None, seed=None, name=None,
            rate=None):
    """(ref: nn_ops.py ``dropout``). The mask is drawn from the run's
    stream for this op; the backward applies the forward's mask."""
    from . import math_ops

    x = ops_mod.convert_to_tensor(x)
    if rate is not None:
        keep_prob = 1.0 - rate
    if keep_prob is None:
        raise ValueError("dropout: pass keep_prob or rate")
    g = ops_mod.get_default_graph()
    graph_seed, op_seed = random_seed_mod.get_seed(seed)
    ns = None
    if noise_shape is not None:
        ns = builtins.tuple(int(d) for d in np.ravel(np.asarray(noise_shape)))
    inputs = [x]
    if isinstance(keep_prob, Tensor):
        inputs.append(math_ops.cast(keep_prob, "float32"))
        kp_attr = None
    else:
        kp_attr = float(keep_prob)
        if kp_attr == 1.0:
            return x
    op = g.create_op("Dropout", inputs,
                     attrs={"keep_prob": kp_attr, "noise_shape": ns,
                            "seed": op_seed, "_graph_seed": graph_seed},
                     name=name or "dropout",
                     output_specs=[(x.shape, x.dtype)])
    return op.outputs[0]
