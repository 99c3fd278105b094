"""Variable reads and assigns (port of the part of ``simple_tensorflow_tpu/
ops/state_ops.py`` the MNIST graphs reach: ``VariableV2``/``ReadVariable``
reads, ``Assign``, ``AssignAdd`` and ``AssignSub``).

A variable is an entry of the Session's store (name -> device tensor). A
read returns the entry at the op's place in the run's order; an assign
stages a tensor of its own (a copy of the assigned value), which later
reads of the run see and the end of the run commits into the store
(``LoweringContext.commit``), so a value read earlier in the run keeps its
old contents, as in the JAX package's functional state. Only the fused
optimizer update writes the store in place mid-run
(``train/optimizers.py``). Left out: the scatter updates,
``CountUpTo`` and ``IsVariableInitialized``.
"""

from __future__ import annotations

from ..framework import graph as ops_mod
from ..framework import op_registry


def _lower_variable(ctx, op, inputs):
    return [ctx.read_var(op.attrs["var_name"], op)]


op_registry.register("VariableV2", lower=_lower_variable,
                     effects=op_registry.Effects(reads=("var_name",)))
# a fresh read at this node's place in the run (observes writes ordered
# before it by control dependencies)
op_registry.register("ReadVariable", lower=_lower_variable,
                     effects=op_registry.Effects(reads=("var_name",)))


def _lower_assign(ctx, op, inputs):
    name = op.attrs["var_name"]
    val = inputs[0]
    if ctx.var_exists(name):
        prev = ctx.read_var(name, op)
        if op.attrs.get("validate_shape", True) and \
                tuple(prev.shape) != tuple(val.shape):
            raise ValueError(
                f"Assign to {name}: shape {tuple(val.shape)} != variable "
                f"shape {tuple(prev.shape)}")
        if prev.dtype != val.dtype:
            val = val.to(prev.dtype)
    val = val.detach().clone()
    ctx.write_var(name, val)
    return [val]


op_registry.register("Assign", lower=_lower_assign,
                     effects=op_registry.Effects(writes=("var_name",)))


def _make_aug_assign(fn):
    def lower(ctx, op, inputs):
        name = op.attrs["var_name"]
        cur = ctx.read_var(name, op)
        new = fn(cur, inputs[0].to(cur.dtype)).detach()
        ctx.write_var(name, new)
        return [new]

    return lower


op_registry.register("AssignAdd", lower=_make_aug_assign(lambda a, b: a + b),
                     effects=op_registry.Effects(writes=("var_name",),
                                                 update="add"))
op_registry.register("AssignSub", lower=_make_aug_assign(lambda a, b: a - b),
                     effects=op_registry.Effects(writes=("var_name",),
                                                 update="sub"))


def _var_name_of(ref) -> str:
    op = ref.op if isinstance(ref, ops_mod.Tensor) else ref
    if op.type != "VariableV2":
        raise TypeError(f"Expected a variable ref tensor, got op {op.type}")
    return op.attrs["var_name"]


def _ref_of(x):
    from . import variables as variables_mod

    return x._ref if isinstance(x, variables_mod.Variable) else x


def assign(ref, value, validate_shape=True, use_locking=True, name=None):
    """(ref: python/ops/state_ops.py ``assign``)."""
    ref = _ref_of(ref)
    g = ops_mod.get_default_graph()
    value = ops_mod.convert_to_tensor(value, dtype=ref.dtype.base_dtype)
    op = g.create_op("Assign", [value],
                     attrs={"var_name": _var_name_of(ref),
                            "validate_shape": validate_shape,
                            "use_locking": use_locking},
                     name=name or "Assign",
                     output_specs=[(value.shape if not validate_shape
                                    else ref.shape, ref.dtype.base_dtype)])
    return op.outputs[0]


def _aug_assign(op_type, ref, value, name):
    ref = _ref_of(ref)
    g = ops_mod.get_default_graph()
    value = ops_mod.convert_to_tensor(value, dtype=ref.dtype.base_dtype)
    op = g.create_op(op_type, [value],
                     attrs={"var_name": _var_name_of(ref)},
                     name=name or op_type,
                     output_specs=[(ref.shape, ref.dtype.base_dtype)])
    return op.outputs[0]


def assign_add(ref, value, use_locking=True, name=None):
    return _aug_assign("AssignAdd", ref, value, name)


def assign_sub(ref, value, use_locking=True, name=None):
    return _aug_assign("AssignSub", ref, value, name)
