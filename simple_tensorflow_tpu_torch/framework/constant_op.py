"""Constant and placeholder ops.

Port of ``simple_tensorflow_tpu/framework/constant_op.py``: ``constant``
(:102) keeps its value as a numpy array in the op's attrs; the Session
copies it to its device once and keeps the tensor for later runs (the JAX
package bakes it into the compiled program). ``FuncArg`` and
``CapturedInput`` (:140-153) are a graph function body's bound values:
the call's lowering binds them, and lowering one alone is an error.
``constant_value`` reads a static value through ``Const``, ``Identity``
and ``Cast``. A string constant is a numpy ``object`` array of bytes that
never becomes a torch tensor: the Session runs it in the host stage
before the device step, as the JAX package does. Left out: the shape-op
cases of ``constant_value``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dtypes as dtypes_mod
from . import graph as ops
from . import op_registry
from . import tensor_shape as shape_mod


def _to_numpy(value, dtype=None):
    if dtype is not None:
        dtype = dtypes_mod.as_dtype(dtype)
    if dtype is not None and dtype.name == "string":
        return np.asarray(value, dtype=object)
    arr = value if isinstance(value, np.ndarray) else np.asarray(value)
    if arr.dtype.kind in "USO":
        return np.asarray(arr, dtype=object)
    if dtype is not None:
        arr = arr.astype(dtype.np_dtype)
    elif arr.dtype == np.float64 and not isinstance(value, np.ndarray):
        arr = arr.astype(np.float32)  # Python floats default to float32
    elif arr.dtype == np.int64 and not isinstance(value, np.ndarray):
        arr = arr.astype(np.int32)  # Python ints default to int32
    return arr


def constant(value, dtype=None, shape=None, name="Const",
             verify_shape=False):
    """A constant tensor (ref: python/framework/constant_op.py:102)."""
    g = ops.get_default_graph()
    if isinstance(value, ops.Tensor):
        return value
    arr = _to_numpy(value, dtype)
    if shape is not None:
        shape = shape_mod.as_shape(shape)
        n_target = shape.num_elements()
        if arr.size == 1 and n_target is not None and n_target != arr.size:
            arr = np.full(shape.as_list(), arr.reshape(()), dtype=arr.dtype)
        elif verify_shape and list(arr.shape) != shape.as_list():
            raise TypeError(f"Expected shape {shape}, got {list(arr.shape)}")
        else:
            arr = arr.reshape(shape.as_list())
    if dtype is not None:
        dt = dtypes_mod.as_dtype(dtype)
    elif arr.dtype == object:
        dt = dtypes_mod.string
    else:
        dt = dtypes_mod.as_dtype(arr.dtype)
    op = g.create_op("Const", [], attrs={"value": arr, "dtype": dt},
                     name=name,
                     output_specs=[(shape_mod.TensorShape(list(arr.shape)),
                                    dt)])
    return op.outputs[0]


def constant_value(tensor):
    """The static value of a tensor, or None (ref: python/framework/
    tensor_util.py ``constant_value``)."""
    if not isinstance(tensor, ops.Tensor):
        return np.asarray(tensor)
    op = tensor.op
    if op.type == "Const":
        return op.attrs["value"]
    if op.type == "Identity":
        return constant_value(op.inputs[0])
    if op.type == "Cast":
        v = constant_value(op.inputs[0])
        if v is not None:
            return v.astype(op.attrs["dtype"].np_dtype)
    return None


def host_tensor(arr) -> torch.Tensor:
    """A CPU tensor over numpy ``arr``'s memory (bfloat16 values as their
    2-byte bits, viewed); over a copy where the array is not contiguous or
    not writable."""
    arr = np.asarray(arr)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_torch(arr, device, dtype=None) -> torch.Tensor:
    """A numpy value as a new tensor on ``device``, of ``dtype`` (a torch
    dtype) or else its own dtype narrowed (bfloat16 numpy values moved as
    their bits)."""
    arr = np.asarray(arr)
    if dtype is None:
        dtype = dtypes_mod.as_dtype(arr.dtype).torch_dtype
    return host_tensor(arr).to(device=device, dtype=dtype, copy=True)


def _lower_const(ctx, op, inputs):
    if op.attrs["dtype"].name == "string":
        return [op.attrs["value"]]  # a host value: never a torch tensor
    return [ctx.constant(op)]


op_registry.register("Const", lower=_lower_const)


def _lower_placeholder(ctx, op, inputs):
    raise RuntimeError(
        f"Placeholder {op.name} was not fed. You must feed a value for it "
        "via Session.run(..., feed_dict={...}).")


op_registry.register("Placeholder", lower=_lower_placeholder,
                     is_stateful=True)


def _lower_placeholder_with_default(ctx, op, inputs):
    return [inputs[0]]


op_registry.register("PlaceholderWithDefault",
                     lower=_lower_placeholder_with_default)


def _lower_unbound(kind):
    def lower(ctx, op, inputs):
        raise RuntimeError(
            f"{kind} {op.name} lowered outside its binding context — "
            "an internal graph-function lowering bug.")

    return lower


op_registry.register("CapturedInput", lower=_lower_unbound("CapturedInput"),
                     is_stateful=True)
op_registry.register("FuncArg", lower=_lower_unbound("FuncArg"),
                     is_stateful=True)
