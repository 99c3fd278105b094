"""Numerics checking (ref: tensorflow/python/ops/numerics.py); the port of
``simple_tensorflow_tpu/ops/numerics.py``.

``NumericSummary`` (JAX :23-41): the float32 ``[nonfinite_count, max_abs,
l2_norm, zero_fraction]`` of a tensor, nonfinites masked out of the
magnitude stats, lowered to the ``numeric_summary`` kernel wrapper
(``ops/kernels/numeric_summary.py``). ``NumericSummaries`` is the port's
op of the numerics-health plane: the ``(T, 4)`` rows of T taps in one
launch, the JAX plane's T ``NumericSummary`` ops and their ``Pack``
(``debug/numerics.py``). Neither has an effect.

``CheckNumerics`` (JAX ``array_ops.check_numerics``) passes its input
through and raises ``InvalidArgumentError`` with its message when the
input holds a NaN or an Inf. The JAX program carries the check's flag
out of the compiled step; here the check reads the device from the host,
so the op declares an ``io`` effect: a plan with one runs eagerly at every
run and outside ``run_steps`` windows, as one with ``Print`` does.
"""

from __future__ import annotations

import torch

from ..framework import dtypes as dtypes_mod
from ..framework import errors
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from .kernels.numeric_summary import numeric_summary as _summarize

# the layout of the packed rows
STAT_NAMES = ("nonfinite_count", "max_abs", "l2_norm", "zero_fraction")
STATS_WIDTH = len(STAT_NAMES)


def _contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_contiguous() else x.contiguous()


def _lower_numeric_summary(ctx, op, inputs):
    return [_summarize([_contiguous(inputs[0])])[0]]


def _lower_numeric_summaries(ctx, op, inputs):
    return [_summarize([_contiguous(x) for x in inputs])]


op_registry.register(
    "NumericSummary", lower=_lower_numeric_summary,
    infer_fn=lambda g, attrs, ins: [(shape_mod.TensorShape([STATS_WIDTH]),
                                     dtypes_mod.float32)])
op_registry.register(
    "NumericSummaries", lower=_lower_numeric_summaries,
    infer_fn=lambda g, attrs, ins: [(
        shape_mod.TensorShape([len(ins), STATS_WIDTH]), dtypes_mod.float32)])


def _lower_check_numerics(ctx, op, inputs):
    x = inputs[0]
    if x.is_floating_point() and not bool(torch.isfinite(x).all()):
        raise errors.InvalidArgumentError(
            None, op, f"{op.attrs.get('message', '')} : Tensor had NaN or "
            "Inf values")
    return [x]


op_registry.register(
    "CheckNumerics", lower=_lower_check_numerics,
    infer_fn=lambda g, attrs, ins: [(ins[0].shape, ins[0].dtype)],
    effects=op_registry.Effects(io=True))


def numeric_summary(tensor, name=None):
    """The packed health stats of ``tensor``: a float32 ``[4]`` vector
    ``[nonfinite_count, max_abs, l2_norm, zero_fraction]`` (ref: the
    tfdbg ``DebugNumericSummary`` idea, core/ops/debug_ops.cc)."""
    x = ops_mod.convert_to_tensor(tensor)
    op = ops_mod.get_default_graph().create_op(
        "NumericSummary", [x], attrs={}, name=name or "NumericSummary",
        output_specs=[(shape_mod.TensorShape([STATS_WIDTH]),
                       dtypes_mod.float32)])
    return op.outputs[0]


def check_numerics(tensor, message, name=None):
    """(ref: array_ops.check_numerics)."""
    x = ops_mod.convert_to_tensor(tensor)
    op = ops_mod.get_default_graph().create_op(
        "CheckNumerics", [x], attrs={"message": message},
        name=name or "CheckNumerics", output_specs=[(x.shape, x.dtype)])
    return op.outputs[0]


def verify_tensor_all_finite(t, msg, name=None):
    """(ref: numerics.py:32 ``verify_tensor_all_finite``)."""
    return check_numerics(t, msg, name=name)


def add_check_numerics_ops():
    """(ref: numerics.py:51 ``add_check_numerics_ops``): a
    ``CheckNumerics`` on every floating-point tensor of the default graph;
    returns their group."""
    from . import control_flow_ops

    g = ops_mod.get_default_graph()
    checks = []
    for op in list(g.get_operations()):
        if op.type in ("CheckNumerics", "Placeholder", "Const"):
            continue
        for out in op.outputs:
            if out.dtype.is_floating:
                checks.append(check_numerics(
                    out, f"{op.name}:{out.value_index}"))
    return control_flow_ops.group(*checks, name="check_numerics_all")
