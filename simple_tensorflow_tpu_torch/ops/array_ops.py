"""Array ops of the port's graph front end.

Port of the part of ``simple_tensorflow_tpu/ops/array_ops.py`` the MNIST,
transformer and BERT graphs and the optimizers reach: ``Placeholder``
(:317), ``PlaceholderWithDefault`` (:328), ``Identity``, ``StopGradient``,
``Reshape`` (:373), ``Squeeze`` (:420), ``Transpose`` (:394), ``Gather``
(:644, ``jnp.take`` along ``axis``), ``Fill``, ``Slice`` and the
constant-backed ``zeros`` and ``ones``. Each op lowers to a torch function
of its inputs and static attrs. Left out: the other ~60 array ops
(concat, pad, strided slices, ...).
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework import constant_op
from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from .op_util import make_op, unary

Tensor = ops_mod.Tensor
constant = constant_op.constant

op_registry.register_pure("Identity", lambda x: x)
op_registry.register_pure("StopGradient", lambda x: x.detach())
op_registry.register_pure("Reshape", lambda x, shape: torch.reshape(x, shape))
op_registry.register_pure(
    "Squeeze", lambda x, axis=None: x.squeeze() if axis is None
    else x.squeeze(tuple(axis)))
op_registry.register_pure("Fill", lambda value, dims=None: value.expand(
    dims).clone())
op_registry.register_pure(
    "Transpose", lambda x, perm=None: x.permute(
        *(perm if perm is not None else builtins.range(x.dim() - 1, -1, -1))))
# advanced indexing, not index_select: its gradient is index_put_ with
# accumulate, which sums a repeated index's rows in one order on every run
# (it sorts); index_select's is index_add_, whose atomics on the card sum
# them in another order each run (BERT's MLM gather repeats positions)
op_registry.register_pure(
    "Gather", lambda params, indices, axis=0: params[
        (builtins.slice(None),) * axis + (indices.long(),)])
op_registry.register_pure("Slice", lambda x, begin=None, size=None: x[
    tuple(builtins.slice(b, b + s) for b, s in zip(begin, size))])


def placeholder(dtype, shape=None, name=None):
    """(ref: python/ops/array_ops.py:1620 ``placeholder``)."""
    g = ops_mod.get_default_graph()
    dt = dtypes_mod.as_dtype(dtype)
    sh = shape_mod.as_shape(shape) if shape is not None \
        else shape_mod.TensorShape(None)
    op = g.create_op("Placeholder", [], attrs={"dtype": dt, "shape": sh},
                     name=name or "Placeholder", output_specs=[(sh, dt)])
    return op.outputs[0]


def placeholder_with_default(input, shape, name=None):  # noqa: A002
    x = ops_mod.convert_to_tensor(input)
    op = ops_mod.get_default_graph().create_op(
        "PlaceholderWithDefault", [x], attrs={},
        name=name or "PlaceholderWithDefault",
        output_specs=[(shape_mod.as_shape(shape), x.dtype)])
    return op.outputs[0]


def identity(input, name=None):  # noqa: A002
    return unary("Identity", input, name)


def stop_gradient(input, name=None):  # noqa: A002
    return unary("StopGradient", input, name)


def _static_shape_arg(shape, what):
    if isinstance(shape, shape_mod.TensorShape):
        return tuple(shape.as_list())
    if isinstance(shape, Tensor):
        v = constant_op.constant_value(shape)
        if v is None:
            raise ValueError(f"stf.{what}: the target shape must be static; "
                             "use -1 for one inferred dim.")
        return tuple(int(d) for d in np.ravel(v))
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(d) for d in shape)


def reshape(tensor, shape, name=None):
    x = ops_mod.convert_to_tensor(tensor)
    return make_op("Reshape", [x],
                   attrs={"shape": _static_shape_arg(shape, "reshape")},
                   name=name)


def squeeze(input, axis=None, name=None,  # noqa: A002
            squeeze_dims=None):
    if squeeze_dims is not None and axis is None:
        axis = squeeze_dims
    x = ops_mod.convert_to_tensor(input)
    if axis is not None and not isinstance(axis, (list, tuple)):
        axis = [axis]
    return make_op("Squeeze", [x], attrs={
        "axis": tuple(int(a) for a in axis) if axis is not None else None},
        name=name)


def zeros(shape, dtype=dtypes_mod.float32, name=None):
    dt = dtypes_mod.as_dtype(dtype)
    sh = _static_shape_arg(shape, "zeros")
    return constant(np.zeros(sh, dtype=dt.np_dtype), name=name or "zeros")


def ones(shape, dtype=dtypes_mod.float32, name=None):
    dt = dtypes_mod.as_dtype(dtype)
    sh = _static_shape_arg(shape, "ones")
    return constant(np.ones(sh, dtype=dt.np_dtype), name=name or "ones")


def transpose(a, perm=None, name=None):
    x = ops_mod.convert_to_tensor(a)
    if perm is not None:
        perm = tuple(int(p) for p in (
            constant_op.constant_value(perm) if isinstance(perm, Tensor)
            else perm))
    return make_op("Transpose", [x], attrs={"perm": perm}, name=name)


def gather(params, indices, validate_indices=None, name=None, axis=0):
    from . import variables as variables_mod

    if isinstance(params, variables_mod.Variable):
        params = params._ref
    params = ops_mod.convert_to_tensor(params)
    indices = ops_mod.convert_to_tensor(indices)
    if isinstance(axis, Tensor):
        axis = int(constant_op.constant_value(axis))
    return make_op("Gather", [params, indices], attrs={"axis": int(axis)},
                   name=name)


def fill(dims, value, name=None):
    return make_op("Fill", [ops_mod.convert_to_tensor(value)],
                   attrs={"dims": _static_shape_arg(dims, "fill")},
                   name=name)


def slice(input_, begin, size, name=None):  # noqa: A001
    """A static slice; ``begin``/``size`` become Const ops as in the JAX
    package (the fused optimizers' per-variable slot views)."""
    x = ops_mod.convert_to_tensor(input_)
    bv = constant_op.constant_value(ops_mod.convert_to_tensor(begin))
    sv = constant_op.constant_value(ops_mod.convert_to_tensor(size))
    if bv is None or sv is None:
        raise ValueError("stf.slice begin/size must be static")
    begin = [int(b) for b in np.ravel(bv)]
    size = [int(s) for s in np.ravel(sv)]
    size = [x.shape[i].value - begin[i] if s == -1 else s
            for i, s in enumerate(size)]
    return make_op("Slice", [x], attrs={"begin": tuple(begin),
                                        "size": tuple(size)}, name=name)
