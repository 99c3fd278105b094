"""Array ops of the port's graph front end.

Port of the part of ``simple_tensorflow_tpu/ops/array_ops.py`` the MNIST,
transformer and BERT graphs and the optimizers reach: ``Placeholder``
(:317), ``PlaceholderWithDefault`` (:328), ``Identity``, ``StopGradient``,
``Reshape`` (:373), ``Squeeze`` (:420), ``Transpose`` (:394), ``Gather``
(:644, ``jnp.take`` along ``axis``), ``Fill``, ``Slice`` and the
constant-backed ``zeros`` and ``ones``; for the RNN graphs ``Concat``,
``ExpandDims``, ``ZerosLike``/``OnesLike``, ``Select`` (``where``, which
broadcasts as ``jnp.where``), ``SequenceMask``, ``Reverse`` and
``StridedSlice``, which ``Tensor.__getitem__`` builds (:603-641: static
indices, slices with any step, ``None`` and ``...``). Each op lowers to a
torch function of its inputs and static attrs. ``ZerosLike`` and
``OnesLike`` of a fully static shape need no input value
(``lowering.shape_only``): a plan does not run the op that makes their
input, as XLA drops it from the JAX program. For beam search ``Tile``
(:65, :550, ``torch.tile``) and ``OneHot`` (:78, :671). Left out: the
other ~50 array ops (pad, split, scatters, ...).
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
def _infer_gather(graph, attrs, inputs):
    """``params.shape[:axis] + indices.shape + params.shape[axis + 1:]``
    (a meta tensor cannot index, so the generic probe cannot tell)."""
    params, indices = inputs
    axis = attrs.get("axis", 0)
    if params.shape.rank is None or indices.shape.rank is None:
        return [(shape_mod.TensorShape(None), params.dtype.base_dtype)]
    dims = params.shape.as_list()
    return [(shape_mod.TensorShape(dims[:axis] + indices.shape.as_list()
                                   + dims[axis + 1:]), params.dtype.base_dtype)]


def _gather(params, indices, axis=0):
    # a 0-d index as a (1,) index, the axis then squeezed: indexing with a
    # 0-d tensor reads it on the host (``.item()``), which a captured step
    # cannot
    idx = indices.long()
    if idx.dim() == 0:
        return params[(builtins.slice(None),) * axis + (
            idx.reshape(1),)].squeeze(axis)
    return params[(builtins.slice(None),) * axis + (idx,)]


op_registry.register_pure("Gather", _gather, infer_fn=_infer_gather)
op_registry.register_pure("Slice", lambda x, begin=None, size=None: x[
    tuple(builtins.slice(b, b + s) for b, s in zip(begin, size))])
op_registry.register_pure("ExpandDims", lambda x, axis: x.unsqueeze(axis))
op_registry.register_pure("Concat", lambda *xs, axis: torch.cat(xs, dim=axis))
op_registry.register_pure("Select", lambda cond, x, y: torch.where(cond, x, y))
op_registry.register_pure("Reverse", lambda x, axis: torch.flip(x, axis))
op_registry.register_pure("Tile", lambda x, multiples: torch.tile(
    x, multiples))


def _one_hot_impl(indices, depth=None, on_value=1.0, off_value=0.0,
                  axis=-1, dtype=None):
    """``jax.nn.one_hot`` along ``axis`` (an index outside ``[0, depth)``
    gives a row of ``off_value``), then ``on_value``/``off_value``."""
    dt = dtypes_mod.narrowed_if_no_x64(
        dtype or dtypes_mod.float32).torch_dtype
    ax = axis if axis >= 0 else indices.dim() + 1 + axis
    shape = [1] * (indices.dim() + 1)
    shape[ax] = depth
    oh = (indices.unsqueeze(ax).long() == torch.arange(
        depth, device=indices.device).reshape(shape)).to(dt)
    if on_value != 1.0 or off_value != 0.0:
        oh = (oh * (on_value - off_value) + off_value).to(dt)
    return oh


op_registry.register_pure("OneHot", _one_hot_impl)
op_registry.register_pure(
    "SequenceMask", lambda lengths, maxlen=None, dtype=None: (
        torch.arange(maxlen, device=lengths.device)[None, :]
        < lengths[..., None]).to(dtype.torch_dtype if dtype else torch.bool))


def _fill_like(value):
    """The lowering of ``ZerosLike``/``OnesLike``: from the static output
    shape when the plan gave no input value (``lowering.shape_only``),
    else like the input."""
    def lower(ctx, op, inputs):
        if inputs:
            return [torch.full_like(inputs[0], value)]
        out = op.outputs[0]
        return [torch.full(tuple(out.shape.as_list()), value,
                           dtype=out.dtype.base_dtype.torch_dtype,
                           device=ctx.device)]

    return lower


op_registry.register("ZerosLike", lower=_fill_like(0),
                     infer_fn=lambda g, attrs, ins: [(ins[0].shape,
                                                      ins[0].dtype)])
op_registry.register("OnesLike", lower=_fill_like(1),
                     infer_fn=lambda g, attrs, ins: [(ins[0].shape,
                                                      ins[0].dtype)])


def _strided_impl(x, dyn_inputs, spec):
    """``x[spec]`` with numpy's semantics, one axis at a time: an index
    drops its axis, a slice keeps it (a negative step takes the rows by
    an index tensor: torch slices only forward), ``newaxis`` adds one,
    ``ellipsis`` skips the axes the other items leave; a ``tensor_idx``
    indexes by a dynamic int tensor (its backward sorts, as ``Gather``'s
    does)."""
    used = builtins.sum(1 for it in spec
                        if it[0] in ("idx", "tensor_idx", "slice"))
    dyn = iter(dyn_inputs)
    out, dim = x, 0
    for item in spec:
        kind = item[0]
        if kind == "ellipsis":
            dim += x.dim() - used
        elif kind == "newaxis":
            out = out.unsqueeze(dim)
            dim += 1
        elif kind == "idx":
            out = out.select(dim, item[1])
        elif kind == "tensor_idx":
            out = out[(builtins.slice(None),) * dim + (next(dyn).long(),)]
        else:
            start, stop, step = builtins.slice(*item[1:]).indices(
                out.shape[dim])
            if step > 0:
                out = out[(builtins.slice(None),) * dim
                          + (builtins.slice(start, stop, step),)]
            else:
                rows = torch.arange(start, stop, step, device=out.device)
                out = out[(builtins.slice(None),) * dim + (rows,)]
            dim += 1
    return out


op_registry.register_pure("StridedSlice", lambda x, *dyn, spec:
                          _strided_impl(x, dyn, spec))


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


def tile(input, multiples, name=None):  # noqa: A002
    x = ops_mod.convert_to_tensor(input)
    if isinstance(multiples, Tensor):
        v = constant_op.constant_value(multiples)
        if v is None:
            raise ValueError("multiples must be static on TPU")
        multiples = v
    return make_op("Tile", [x], attrs={
        "multiples": tuple(int(m) for m in np.ravel(multiples))}, name=name)


def one_hot(indices, depth, on_value=None, off_value=None, axis=None,
            dtype=None, name=None):
    indices = ops_mod.convert_to_tensor(indices)
    if isinstance(depth, Tensor):
        depth = int(constant_op.constant_value(depth))
    dt = dtypes_mod.as_dtype(dtype) if dtype is not None \
        else dtypes_mod.float32
    return make_op("OneHot", [indices],
                   attrs={"depth": int(depth),
                          "on_value": 1.0 if on_value is None else on_value,
                          "off_value": 0.0 if off_value is None
                          else off_value,
                          "axis": -1 if axis is None else int(axis),
                          "dtype": dt},
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


def expand_dims(input, axis=None, name=None, dim=None):  # noqa: A002
    if dim is not None and axis is None:
        axis = dim
    x = ops_mod.convert_to_tensor(input)
    return make_op("ExpandDims", [x], attrs={"axis": int(axis)}, name=name)


def zeros_like(tensor, dtype=None, name=None, optimize=True):
    x = ops_mod.convert_to_tensor(tensor)
    out = unary("ZerosLike", x, name)
    if dtype is not None and dtypes_mod.as_dtype(dtype) != x.dtype.base_dtype:
        from . import math_ops

        out = math_ops.cast(out, dtype)
    return out


def ones_like(tensor, dtype=None, name=None, optimize=True):
    x = ops_mod.convert_to_tensor(tensor)
    out = unary("OnesLike", x, name)
    if dtype is not None and dtypes_mod.as_dtype(dtype) != x.dtype.base_dtype:
        from . import math_ops

        out = math_ops.cast(out, dtype)
    return out


def concat(values, axis, name="concat"):
    if not isinstance(values, (list, tuple)):
        values = [values]
    tensors = [ops_mod.convert_to_tensor(v) for v in values]
    if len(tensors) == 1:
        return identity(tensors[0], name=name)
    if isinstance(axis, Tensor):
        axis = int(constant_op.constant_value(axis))
    return make_op("Concat", tensors, attrs={"axis": int(axis)}, name=name)


def strided_slice(input_, begin, end, strides=None, begin_mask=0, end_mask=0,
                  ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=0,
                  name=None):
    """(ref: array_ops.py ``strided_slice``): static bounds and masks as
    the ``StridedSlice`` op's spec."""
    bv = constant_op.constant_value(ops_mod.convert_to_tensor(begin))
    ev = constant_op.constant_value(ops_mod.convert_to_tensor(end))
    strv = (constant_op.constant_value(ops_mod.convert_to_tensor(strides))
            if strides is not None else np.ones_like(bv))
    if bv is None or ev is None or strv is None:
        raise ValueError("strided_slice bounds must be static")
    spec = []
    for i, (b, e, s) in enumerate(zip(np.ravel(bv), np.ravel(ev),
                                      np.ravel(strv))):
        if shrink_axis_mask & (1 << i):
            spec.append(("idx", int(b)))
        elif new_axis_mask & (1 << i):
            spec.append(("newaxis",))
        elif ellipsis_mask & (1 << i):
            spec.append(("ellipsis",))
        else:
            bb = None if begin_mask & (1 << i) else int(b)
            ee = None if end_mask & (1 << i) else int(e)
            spec.append(("slice", bb, ee, int(s)))
    x = ops_mod.convert_to_tensor(input_)
    return make_op("StridedSlice", [x], attrs={"spec": tuple(spec)},
                   name=name)


def _slice_helper(tensor, sl):
    """``Tensor.__getitem__`` (ref: array_ops.py:478 ``_SliceHelper``)."""
    if not isinstance(sl, tuple):
        sl = (sl,)
    spec = []
    dyn = []
    for item in sl:
        if isinstance(item, builtins.slice):
            def stat(v):
                if v is None:
                    return None
                if isinstance(v, Tensor):
                    c = constant_op.constant_value(v)
                    if c is None:
                        raise ValueError(
                            "Slice bounds must be static; for dynamic "
                            "windows use stf.gather.")
                    return int(c)
                return int(v)

            spec.append(("slice", stat(item.start), stat(item.stop),
                         stat(item.step)))
        elif item is Ellipsis:
            spec.append(("ellipsis",))
        elif item is None:
            spec.append(("newaxis",))
        elif isinstance(item, Tensor):
            c = constant_op.constant_value(item)
            if c is not None and c.ndim == 0:
                spec.append(("idx", int(c)))
            else:
                spec.append(("tensor_idx",))
                dyn.append(item)
        else:
            spec.append(("idx", int(item)))
    return make_op("StridedSlice", [tensor] + dyn,
                   attrs={"spec": tuple(spec)})


Tensor.__getitem__ = _slice_helper


def where(condition, x=None, y=None, name=None):
    """``Select`` of ``x`` where ``condition``, else ``y``, broadcasting
    as ``jnp.where`` (a ``[B, 1]`` condition against ``[B, H]``); with
    neither ``x`` nor ``y``, the indices of a static condition."""
    condition = ops_mod.convert_to_tensor(condition)
    if x is None and y is None:
        cv = constant_op.constant_value(condition)
        if cv is None:
            raise ValueError(
                "stf.where(cond) with one argument has a data-dependent "
                "output shape; use where(cond, x, y) or a static "
                "condition.")
        return constant(np.argwhere(cv).astype(np.int64),
                        name=name or "Where")
    if x is None or y is None:
        raise ValueError("x and y must both be set or both None")
    from .op_util import promote_args

    x, y = promote_args(x, y, "Select")
    return make_op("Select", [condition, x, y], name=name)



def reverse(tensor, axis, name=None):
    x = ops_mod.convert_to_tensor(tensor)
    if isinstance(axis, Tensor):
        axis = constant_op.constant_value(axis)
    axis = tuple(int(a) for a in np.ravel(axis))
    return make_op("Reverse", [x], attrs={"axis": axis}, name=name)



def sequence_mask(lengths, maxlen=None, dtype=dtypes_mod.bool_, name=None):
    lengths = ops_mod.convert_to_tensor(lengths)
    if maxlen is None:
        v = constant_op.constant_value(lengths)
        if v is None:
            raise ValueError("sequence_mask needs a static maxlen")
        maxlen = int(np.max(v))
    elif isinstance(maxlen, Tensor):
        maxlen = int(constant_op.constant_value(maxlen))
    return make_op("SequenceMask", [lengths],
                   attrs={"maxlen": int(maxlen),
                          "dtype": dtypes_mod.as_dtype(dtype)}, name=name)
