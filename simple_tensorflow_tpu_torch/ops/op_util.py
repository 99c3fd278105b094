"""Helpers that build op wrappers (port of ``simple_tensorflow_tpu/ops/
op_util.py``): ``make_op``, ``unary``, ``binary`` and the TF-1.0 dtype
discipline of ``promote_args`` (mixed-dtype binary ops raise
``TypeError``; Python scalars take the tensor operand's dtype)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..framework import graph as ops_mod

Tensor = ops_mod.Tensor


def make_op(op_type: str, inputs: Sequence[Tensor], attrs=None,
            name: Optional[str] = None, n_out: int = 1):
    g = ops_mod.get_default_graph()
    op = g.create_op(op_type, inputs, attrs=attrs or {}, name=name or op_type)
    return op.outputs[0] if n_out == 1 else list(op.outputs)


def unary(op_type: str, x, name=None, dtype=None, attrs=None):
    x = ops_mod.convert_to_tensor(x, dtype=dtype)
    return make_op(op_type, [x], attrs=attrs, name=name)


def binary(op_type: str, x, y, name=None, attrs=None):
    x, y = promote_args(x, y, op_type)
    return make_op(op_type, [x, y], attrs=attrs, name=name)


def promote_args(x, y, op_name=""):
    """Both operands must have the same base dtype; a Python scalar adopts
    the tensor operand's dtype (TF-1.0 strictness)."""
    x_is_t = isinstance(x, Tensor) or hasattr(x, "_as_graph_element")
    y_is_t = isinstance(y, Tensor) or hasattr(y, "_as_graph_element")
    if x_is_t:
        x = ops_mod.convert_to_tensor(x)
    if y_is_t:
        y = ops_mod.convert_to_tensor(y)
    if x_is_t and not y_is_t:
        y = ops_mod.convert_to_tensor(y, dtype=x.dtype.base_dtype)
    elif y_is_t and not x_is_t:
        x = ops_mod.convert_to_tensor(x, dtype=y.dtype.base_dtype)
    elif not x_is_t and not y_is_t:
        x = ops_mod.convert_to_tensor(x)
        y = ops_mod.convert_to_tensor(y, dtype=x.dtype.base_dtype)
    if x.dtype.base_dtype != y.dtype.base_dtype:
        raise TypeError(
            f"{op_name or 'binary op'}: operand dtypes must match, got "
            f"{x.dtype.base_dtype.name} and {y.dtype.base_dtype.name}. "
            f"Use stf.cast explicitly (TF-1.0 semantics).")
    return x, y


def norm_axis(axis):
    """A reduction axis as a static tuple, or None."""
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    if isinstance(axis, Tensor):
        from ..framework import constant_op

        v = constant_op.constant_value(axis)
        if v is None:
            raise ValueError("Reduction axis must be statically known")
        return tuple(int(a) for a in np.ravel(v))
    return (int(axis),)
