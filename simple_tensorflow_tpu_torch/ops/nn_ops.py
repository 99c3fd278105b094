"""``stf.nn`` ops of the port that are not fused kernels of the JAX
package: ``dropout``, as ``simple_tensorflow_tpu/ops/nn_ops.py:dropout``
(:699) builds it and ``_dropout_lower`` (:388-398) lowers it, drawing
JAX's threefry bits from an explicit key (a JAX session derives the key
per step and per op; :class:`..framework.random_seed.StepRNG` is the
port's counterpart). It runs the Dropout kernel, or its plain version
under :func:`.fused_ops.plain_versions`."""

from __future__ import annotations

from .fused_ops import using_plain_versions
from .kernels.dropout import DropoutFunction


def dropout(x, keep_prob: float, key):
    """``where(uniform(key, x.shape) < keep_prob, x / keep_prob, 0)``
    with ``keep_prob`` in ``x``'s dtype for the division; ``key`` is a raw
    threefry key (two uint32 words). ``keep_prob == 1`` returns ``x``, as
    the JAX function does. Differentiable."""
    keep_prob = float(keep_prob)
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must be in (0, 1]: {keep_prob}")
    if keep_prob == 1.0:
        return x
    return DropoutFunction.apply(x, keep_prob, tuple(int(w) for w in key),
                                 using_plain_versions())
