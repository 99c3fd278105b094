"""Math ops of the port's graph front end.

Port of the part of ``simple_tensorflow_tpu/ops/math_ops.py`` the MNIST
and transformer graphs and the optimizers reach: ``Add``/``Sub``/``Mul``,
``TrueDiv`` (what ``/``, ``truediv`` and ``divide`` build, :302-312) and
``RealDiv`` (``realdiv``), ``Pow``, ``Minimum``, ``Cast`` (:587),
``AddN``, ``Tanh`` (:65), ``range`` (:886, a ``Const`` built with
numpy), ``MatMul`` (:663), the reductions ``Sum``/``Mean`` (:723),
``ArgMax`` (:777), ``Equal`` (:541) and ``NotEqual``, with the
JAX module's strictness on mixed-dtype binary ops (``TypeError``) and its
64-bit rule (``argmax``'s default int64 output computes and fetches as
int32); for the RNN graphs ``Maximum``, ``Sigmoid``, ``Sqrt``,
``Square``, ``Neg``, the comparisons ``Less``/``LessEqual``/``Greater``/
``GreaterEqual``, ``LogicalNot``, ``ClipByValue`` and ``BatchMatMul``
(what ``matmul`` builds for a rank-3 operand, :671-680); for beam search
and ``raw_rnn`` ``FloorDiv`` (:319) and ``FloorMod`` (:331) with floor
semantics on negative ints (``torch.floor_divide``, ``torch.remainder``),
``LogicalAnd``, ``LogicalOr`` and ``All`` (``reduce_all``); ``Log`` and
``Exp`` (the numerics plane's tests poison a step through ``Log``);
``Abs`` and ``Log1p`` (``weighted_cross_entropy_with_logits``). The
Tensor operators (``+ - * / // % @ **``, and of :973-994 unary ``-`` and
``~``, ``&``, ``|`` and ``< <= > >=``) are installed here on ``Tensor``
and ``Variable``.
A plain f32 matrix product, batched or not, is left to ``torch.matmul``
(full f32 on the card: the Session pins TF32 off), as the JAX package
leaves it to XLA. Left out: the other elementwise, reduction, segment,
scan and linear-algebra ops.
"""

from __future__ import annotations

import builtins

import torch

import numpy as np

from ..framework import constant_op
from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from .op_util import binary, make_op, norm_axis, promote_args, unary

Tensor = ops_mod.Tensor


def _narrow(dtype) -> torch.dtype:
    return dtypes_mod.narrowed_if_no_x64(dtype).torch_dtype


op_registry.register_pure("Add", torch.add)
op_registry.register_pure("Sub", torch.sub)
op_registry.register_pure("Mul", torch.mul)
op_registry.register_pure("TrueDiv", torch.true_divide)
op_registry.register_pure("RealDiv", torch.true_divide)
op_registry.register_pure("Pow", torch.pow)
op_registry.register_pure("Minimum", torch.minimum)
op_registry.register_pure("Equal", torch.eq)
op_registry.register_pure("NotEqual", torch.ne)
op_registry.register_pure("Cast", lambda x, dtype: x.to(_narrow(dtype)))
op_registry.register_pure("Tanh", torch.tanh)
op_registry.register_pure("AddN", lambda *xs: builtins.sum(xs[1:], xs[0]))
op_registry.register_pure("Maximum", torch.maximum)
op_registry.register_pure("Sigmoid", torch.sigmoid)
op_registry.register_pure("Sqrt", torch.sqrt)
op_registry.register_pure("Log", torch.log)
op_registry.register_pure("Exp", torch.exp)
def abs_impl(x):
    """``|x|`` with ``lax.abs``'s gradient: 1 at 0, where ``torch.abs``
    gives 0."""
    return torch.where(x >= 0, x, -x)


op_registry.register_pure("Abs", abs_impl)
op_registry.register_pure("Log1p", torch.log1p)
op_registry.register_pure("Square", torch.square)
op_registry.register_pure("Neg", torch.neg)
op_registry.register_pure("Less", torch.lt)
op_registry.register_pure("LessEqual", torch.le)
op_registry.register_pure("Greater", torch.gt)
op_registry.register_pure("GreaterEqual", torch.ge)
op_registry.register_pure("LogicalNot", torch.logical_not)
op_registry.register_pure("LogicalAnd", torch.logical_and)
op_registry.register_pure("LogicalOr", torch.logical_or)
# floor semantics, as jnp.floor_divide and jnp.mod: a negative int
# quotient rounds down and the remainder takes the divisor's sign
op_registry.register_pure("FloorDiv", torch.floor_divide)
op_registry.register_pure("FloorMod", torch.remainder)
op_registry.register_pure("ClipByValue", lambda x, lo, hi: torch.minimum(
    torch.maximum(x, lo), hi))


def _matmul_impl(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


op_registry.register_pure("MatMul", _matmul_impl)
op_registry.register_pure(
    "BatchMatMul", lambda a, b, adj_x=False, adj_y=False: _matmul_impl(
        a, b, adj_x, adj_y))


def _reducer(fn):
    def reduce(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return fn(x, dim=axis, keepdim=keepdims)

    return reduce


op_registry.register_pure("Sum", _reducer(torch.sum))
op_registry.register_pure("Mean", _reducer(torch.mean))
op_registry.register_pure("All", _reducer(torch.all))
op_registry.register_pure(
    "ArgMax", lambda x, axis=0, output_type=None: torch.argmax(
        x, dim=axis).to(_narrow(output_type or dtypes_mod.int64)))


# -- public API --------------------------------------------------------------

def add(x, y, name=None):
    return binary("Add", x, y, name)


def subtract(x, y, name=None):
    return binary("Sub", x, y, name)


sub = subtract


def multiply(x, y, name=None):
    return binary("Mul", x, y, name)


mul = multiply


def divide(x, y, name=None):
    return binary("TrueDiv", x, y, name)


def truediv(x, y, name=None):
    return binary("TrueDiv", x, y, name)


def realdiv(x, y, name=None):
    return binary("RealDiv", x, y, name)


def pow(x, y, name=None):  # noqa: A001
    return binary("Pow", x, y, name)


def minimum(x, y, name=None):
    return binary("Minimum", x, y, name)


def equal(x, y, name=None):
    return binary("Equal", x, y, name)


def not_equal(x, y, name=None):
    return binary("NotEqual", x, y, name)


def maximum(x, y, name=None):
    return binary("Maximum", x, y, name)


def negative(x, name=None):
    return unary("Neg", x, name)



def square(x, name=None):
    return unary("Square", x, name)


def sqrt(x, name=None):
    return unary("Sqrt", x, name)


def log(x, name=None):
    return unary("Log", x, name)


def log1p(x, name=None):
    return unary("Log1p", x, name)


def abs(x, name=None):  # noqa: A001 (the TF name)
    return unary("Abs", x, name)


def exp(x, name=None):
    return unary("Exp", x, name)


def sigmoid(x, name=None):
    return unary("Sigmoid", x, name)


def less(x, y, name=None):
    return binary("Less", x, y, name)


def less_equal(x, y, name=None):
    return binary("LessEqual", x, y, name)


def greater(x, y, name=None):
    return binary("Greater", x, y, name)


def greater_equal(x, y, name=None):
    return binary("GreaterEqual", x, y, name)


def floordiv(x, y, name=None):
    return binary("FloorDiv", x, y, name)


def floormod(x, y, name=None):
    return binary("FloorMod", x, y, name)


def logical_and(x, y, name=None):
    return binary("LogicalAnd", x, y, name)


def logical_or(x, y, name=None):
    return binary("LogicalOr", x, y, name)


def logical_not(x, name=None):
    return unary("LogicalNot", x, name)


def cast(x, dtype, name=None):
    dtype = dtypes_mod.as_dtype(dtype)
    x = ops_mod.convert_to_tensor(x)
    if x.dtype.base_dtype == dtype.base_dtype:
        return x
    return make_op("Cast", [x], attrs={"dtype": dtype.base_dtype}, name=name)


def tanh(x, name=None):
    return unary("Tanh", x, name)


def range(start, limit=None, delta=1, dtype=None,  # noqa: A001
          name="range"):
    """A ``Const`` of ``np.arange(start, limit, delta)`` (static bounds;
    int64 narrowed to int32, float64 to float32, as in JAX)."""
    if limit is None:
        start, limit = 0, start
    sv, lv, dv = (constant_op.constant_value(ops_mod.convert_to_tensor(v))
                  for v in (start, limit, delta))
    if sv is None or lv is None or dv is None:
        raise ValueError("stf.range bounds must be static")
    arr = np.arange(sv, lv, dv)
    if dtype is not None:
        arr = arr.astype(dtypes_mod.as_dtype(dtype).np_dtype)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return constant_op.constant(arr, name=name)


def add_n(inputs, name=None):
    tensors = [ops_mod.convert_to_tensor(x) for x in inputs]
    if len(tensors) == 1:
        return tensors[0]
    return make_op("AddN", tensors, name=name)


def matmul(a, b, transpose_a=False, transpose_b=False, adjoint_a=False,
           adjoint_b=False, a_is_sparse=False, b_is_sparse=False, name=None):
    a, b = promote_args(a, b, "MatMul")
    if a.shape.rank is not None and a.shape.rank > 2:
        return make_op("BatchMatMul", [a, b],
                       attrs={"adj_x": transpose_a or adjoint_a,
                              "adj_y": transpose_b or adjoint_b},
                       name=name)
    return make_op("MatMul", [a, b],
                   attrs={"transpose_a": transpose_a or adjoint_a,
                          "transpose_b": transpose_b or adjoint_b},
                   name=name)


def _reduce(op_type, input_tensor, axis, keepdims, name,
            reduction_indices=None, keep_dims=None):
    if keep_dims is not None:
        keepdims = keep_dims
    if reduction_indices is not None and axis is None:
        axis = reduction_indices
    x = ops_mod.convert_to_tensor(input_tensor)
    return make_op(op_type, [x], attrs={"axis": norm_axis(axis),
                                        "keepdims": builtins.bool(keepdims)},
                   name=name)


def reduce_sum(input_tensor, axis=None, keepdims=False, name=None,
               reduction_indices=None, keep_dims=None):
    return _reduce("Sum", input_tensor, axis, keepdims, name,
                   reduction_indices, keep_dims)


def reduce_mean(input_tensor, axis=None, keepdims=False, name=None,
                reduction_indices=None, keep_dims=None):
    return _reduce("Mean", input_tensor, axis, keepdims, name,
                   reduction_indices, keep_dims)


def reduce_all(input_tensor, axis=None, keepdims=False, name=None,
               reduction_indices=None, keep_dims=None):
    return _reduce("All", input_tensor, axis, keepdims, name,
                   reduction_indices, keep_dims)


def argmax(input, axis=None, name=None, dimension=None,  # noqa: A002
           output_type=dtypes_mod.int64):
    if dimension is not None and axis is None:
        axis = dimension
    x = ops_mod.convert_to_tensor(input)
    return make_op("ArgMax", [x], attrs={
        "axis": int(axis or 0),
        "output_type": dtypes_mod.as_dtype(output_type)}, name=name)


def _install_operators():
    T = Tensor
    T.__add__ = lambda self, other: add(self, other)
    T.__radd__ = lambda self, other: add(other, self)
    T.__sub__ = lambda self, other: subtract(self, other)
    T.__rsub__ = lambda self, other: subtract(other, self)
    T.__mul__ = lambda self, other: multiply(self, other)
    T.__rmul__ = lambda self, other: multiply(other, self)
    T.__truediv__ = lambda self, other: truediv(self, other)
    T.__rtruediv__ = lambda self, other: truediv(other, self)
    T.__floordiv__ = lambda self, other: floordiv(self, other)
    T.__rfloordiv__ = lambda self, other: floordiv(other, self)
    T.__mod__ = lambda self, other: floormod(self, other)
    T.__rmod__ = lambda self, other: floormod(other, self)
    T.__and__ = lambda self, other: logical_and(self, other)
    T.__rand__ = lambda self, other: logical_and(other, self)
    T.__or__ = lambda self, other: logical_or(self, other)
    T.__ror__ = lambda self, other: logical_or(other, self)
    T.__matmul__ = lambda self, other: matmul(self, other)
    T.__rmatmul__ = lambda self, other: matmul(other, self)
    T.__pow__ = lambda self, other: pow(self, other)
    T.__rpow__ = lambda self, other: pow(other, self)
    T.__neg__ = lambda self: negative(self)
    T.__invert__ = lambda self: logical_not(self)
    T.__lt__ = lambda self, other: less(self, other)
    T.__le__ = lambda self, other: less_equal(self, other)
    T.__gt__ = lambda self, other: greater(self, other)
    T.__ge__ = lambda self, other: greater_equal(self, other)

    from . import variables as variables_mod

    def _mk(d):
        def fwd(self, *args):
            return getattr(self._ref, d)(*args)

        return fwd

    for dunder in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                   "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
                   "__rfloordiv__", "__mod__", "__rmod__", "__matmul__",
                   "__rmatmul__", "__pow__", "__rpow__", "__neg__",
                   "__lt__", "__le__", "__gt__", "__ge__"):
        setattr(variables_mod.Variable, dunder, _mk(dunder))


_install_operators()
