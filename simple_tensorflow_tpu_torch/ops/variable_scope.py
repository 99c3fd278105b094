"""``variable_scope`` and ``get_variable`` of the port (port of
``simple_tensorflow_tpu/ops/variable_scope.py``): scopes form a path,
``get_variable`` (:114) creates or, with ``reuse=True``, returns the
variable of that full name, ``AUTO_REUSE`` creates on first use, and the
default initializer of a float variable is glorot uniform (:152). Left
out: custom getters, regularizers, constraints and partitioners.
"""

from __future__ import annotations

import contextlib

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import tensor_shape as shape_mod
from . import init_ops
from . import variables as variables_mod

AUTO_REUSE = "auto_reuse"
_VARS = "__variable_store__"
_SCOPE = "__variable_scope_stack__"


# the variable store and the scope stack belong to the root graph, also
# while a FuncGraph body is traced
def _graph_vars(g) -> dict:
    return ops_mod._root_graph(g)._scoped_state.setdefault(_VARS, {})


def _scope_stack(g) -> list:
    g = ops_mod._root_graph(g)
    st = g._scoped_state.get(_SCOPE)
    if st is None:
        st = [VariableScope("")]
        g._scoped_state[_SCOPE] = st
    return st


class VariableScope:
    def __init__(self, name, reuse=False, initializer=None, dtype=None):
        self._name = name
        self._reuse = reuse
        self._initializer = initializer
        self._dtype = dtype or dtypes_mod.float32

    @property
    def name(self):
        return self._name

    @property
    def original_name_scope(self):
        return self._name + "/" if self._name else ""

    @property
    def reuse(self):
        return self._reuse

    @property
    def initializer(self):
        return self._initializer

    @property
    def dtype(self):
        return self._dtype

    def reuse_variables(self):
        self._reuse = True

    def set_initializer(self, initializer):
        self._initializer = initializer


def get_variable_scope() -> VariableScope:
    return _scope_stack(ops_mod.get_default_graph())[-1]


def get_variable(name, shape=None, dtype=None, initializer=None,
                 trainable=True, collections=None, validate_shape=True):
    """(ref: variable_scope.py:988 ``get_variable``)."""
    scope = get_variable_scope()
    name = f"{scope.name}/{name}" if scope.name else name
    store = _graph_vars(ops_mod.get_default_graph())
    if name in store:
        if scope.reuse is False:
            raise ValueError(
                f"Variable {name} already exists, disallowed. Did you mean "
                "to set reuse=True or reuse=stf.AUTO_REUSE in VarScope?")
        v = store[name]
        if shape is not None and not v.shape.is_compatible_with(shape):
            raise ValueError(
                f"Trying to share variable {name}, but specified shape "
                f"{shape} and found shape {v.shape}.")
        return v
    if scope.reuse is True:
        raise ValueError(
            f"Variable {name} does not exist, or was not created with "
            "stf.get_variable(). Did you mean to set reuse=None in "
            "VarScope?")
    dt = dtypes_mod.as_dtype(dtype or scope.dtype)
    init = initializer if initializer is not None else scope.initializer
    if init is None:
        if dt.is_floating:
            init = init_ops.glorot_uniform_initializer(dtype=dt)
        elif dt.is_integer or dt.is_bool:
            init = init_ops.Zeros(dtype=dt)
        else:
            raise ValueError(f"No default initializer for dtype {dt}")
    if callable(init) and not isinstance(init, ops_mod.Tensor):
        if shape is None:
            raise ValueError(f"Shape of variable {name} must be known")
        sh = [int(d) for d in shape_mod.as_shape(shape).as_list()]

        def init_val():
            try:
                return init(sh, dtype=dt)
            except TypeError:
                return init(sh)
    else:
        init_val = init
    v = variables_mod.Variable(
        initial_value=init_val, trainable=trainable, collections=collections,
        validate_shape=validate_shape, name=name + "/", dtype=dt)
    store[name] = v
    return v


@contextlib.contextmanager
def variable_scope(name_or_scope, default_name=None, values=None,
                   initializer=None, reuse=None, dtype=None,
                   auxiliary_name_scope=True):
    """(ref: variable_scope.py:1615 ``variable_scope``)."""
    g = ops_mod.get_default_graph()
    stack = _scope_stack(g)
    parent = stack[-1]
    if isinstance(name_or_scope, VariableScope):
        new_name = name_or_scope.name
        base = name_or_scope
    else:
        if name_or_scope is None:
            name_or_scope = default_name
        new_name = f"{parent.name}/{name_or_scope}" if parent.name \
            else name_or_scope
        base = None
    src = base or parent
    scope = VariableScope(
        new_name, reuse=reuse if reuse is not None else src.reuse,
        initializer=(initializer if initializer is not None
                     else src.initializer),
        dtype=dtype if dtype is not None else src.dtype)
    stack.append(scope)
    try:
        if auxiliary_name_scope and \
                not isinstance(name_or_scope, VariableScope):
            with g.name_scope(name_or_scope):
                yield scope
        else:
            yield scope
    finally:
        stack.pop()
