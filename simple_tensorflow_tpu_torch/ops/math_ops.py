"""Math ops of the port's graph front end.

Port of the part of ``simple_tensorflow_tpu/ops/math_ops.py`` the MNIST
and transformer graphs and the optimizers reach: ``Add``/``Sub``/``Mul``,
``TrueDiv`` (what ``/``, ``truediv`` and ``divide`` build, :302-312) and
``RealDiv`` (``realdiv``), ``Pow``, ``Minimum``, ``Cast`` (:587),
``AddN``, ``MatMul`` (:663), the reductions ``Sum``/``Mean`` (:723),
``ArgMax`` (:777), ``Equal`` (:541) and ``NotEqual``, with the
JAX module's strictness on mixed-dtype binary ops (``TypeError``) and its
64-bit rule (``argmax``'s default int64 output computes and fetches as
int32). The Tensor operators (``+ - * / @``) are installed here on
``Tensor`` and ``Variable``. A plain f32 matrix product is left to
``torch.matmul`` (full f32 on the card: the Session pins TF32 off). Left
out: the other elementwise, comparison, reduction, segment, scan and
linear-algebra ops.
"""

from __future__ import annotations

import builtins

import torch

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from .op_util import binary, make_op, norm_axis, promote_args

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
op_registry.register_pure("AddN", lambda *xs: builtins.sum(xs[1:], xs[0]))


def _matmul_impl(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


op_registry.register_pure("MatMul", _matmul_impl)


def _reducer(fn):
    def reduce(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return fn(x, dim=axis, keepdim=keepdims)

    return reduce


op_registry.register_pure("Sum", _reducer(torch.sum))
op_registry.register_pure("Mean", _reducer(torch.mean))
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


def cast(x, dtype, name=None):
    dtype = dtypes_mod.as_dtype(dtype)
    x = ops_mod.convert_to_tensor(x)
    if x.dtype.base_dtype == dtype.base_dtype:
        return x
    return make_op("Cast", [x], attrs={"dtype": dtype.base_dtype}, name=name)


def add_n(inputs, name=None):
    tensors = [ops_mod.convert_to_tensor(x) for x in inputs]
    if len(tensors) == 1:
        return tensors[0]
    return make_op("AddN", tensors, name=name)


def matmul(a, b, transpose_a=False, transpose_b=False, adjoint_a=False,
           adjoint_b=False, a_is_sparse=False, b_is_sparse=False, name=None):
    a, b = promote_args(a, b, "MatMul")
    if a.shape.rank is not None and a.shape.rank > 2:
        raise NotImplementedError("batched matmul is not ported")
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
    T.__matmul__ = lambda self, other: matmul(self, other)
    T.__rmatmul__ = lambda self, other: matmul(other, self)
    T.__pow__ = lambda self, other: pow(self, other)
    T.__rpow__ = lambda self, other: pow(other, self)

    from . import variables as variables_mod

    def _mk(d):
        def fwd(self, *args):
            return getattr(self._ref, d)(*args)

        return fwd

    for dunder in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
                   "__rmul__", "__truediv__", "__rtruediv__", "__matmul__",
                   "__rmatmul__", "__pow__", "__rpow__"):
        setattr(variables_mod.Variable, dunder, _mk(dunder))


_install_operators()
