"""``stf.Variable`` of the port (ref: tensorflow/python/ops/variables.py).

Port of ``simple_tensorflow_tpu/ops/variables.py``: ``Variable`` (:23) is
graph metadata plus a named entry of the Session's ``VariableStore``. The
graph holds a ``VariableV2`` read op (its output is the "ref" tensor, as in
TF-1.0), an initializer ``Assign`` and the ``read`` snapshot, created in
the JAX package's order and with its names. ``trainable_variables``
(:287), ``global_variables_initializer`` (:308) and
``local_variables_initializer`` (:316) as there; ``to_proto`` and
``from_proto`` (:200-245), the meta graph's form of a variable
(``framework/graph_io.py``); ``set_sharding`` records a spec. Left out:
constraints,
``ResourceVariable``, ``PartitionedVariable`` and the
uninitialized-variable report ops.
"""

from __future__ import annotations

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from . import state_ops

GraphKeys = ops_mod.GraphKeys


class Variable:
    def __init__(self, initial_value=None, trainable=True, collections=None,
                 validate_shape=True, name=None, dtype=None):
        if initial_value is None:
            raise ValueError("initial_value must be specified.")
        g = ops_mod._root_graph()  # variables live in the root graph
        self._graph = g
        with ops_mod._as_current(g), \
                g.name_scope(name or "Variable") as scope:
            base = scope[:-1] if scope else g.unique_name("Variable")
            if callable(initial_value):
                with g.name_scope("Initializer"):
                    initial_value = initial_value()
            self._initial_value = ops_mod.convert_to_tensor(
                initial_value, dtype=dtype, name="initial_value")
            if validate_shape and \
                    not self._initial_value.shape.is_fully_defined():
                raise ValueError(
                    f"initial_value for {base} must have fully defined "
                    f"shape, got {self._initial_value.shape}")
            dt = self._initial_value.dtype.base_dtype
            shape = self._initial_value.shape
            self._var_name = base
            var_op = g.create_op(
                "VariableV2", [],
                attrs={"var_name": base, "dtype": dt, "shape": shape,
                       "trainable": trainable},
                name=base + "/" if scope else base,
                output_specs=[(shape, dt._ref)])
            self._ref = var_op.outputs[0]
            self._op = var_op
            with g.name_scope("Assign"):
                self._initializer_op = state_ops.assign(
                    self._ref, self._initial_value,
                    validate_shape=validate_shape).op
            read_op = g.create_op(
                "ReadVariable", [], attrs={"var_name": base},
                name=base + "/read" + "/", output_specs=[(shape, dt)])
            self._snapshot = read_op.outputs[0]
        if collections is None:
            collections = [GraphKeys.GLOBAL_VARIABLES]
        if trainable and GraphKeys.TRAINABLE_VARIABLES not in collections:
            collections = list(collections) + [GraphKeys.TRAINABLE_VARIABLES]
        g.add_to_collections(collections, self)
        self._trainable = trainable
        g._scoped_state.setdefault("__vars_by_store_name__", {})[base] = self

    @property
    def name(self) -> str:
        return self._ref.name

    @property
    def var_name(self) -> str:
        """Store key (the op name, no ``:0``)."""
        return self._var_name

    @property
    def op(self):
        return self._op

    @property
    def graph(self):
        return self._graph

    @property
    def dtype(self):
        return self._ref.dtype

    @property
    def shape(self):
        return self._ref.shape

    def get_shape(self):
        return self._ref.shape

    @property
    def trainable(self):
        return self._trainable

    @property
    def initial_value(self):
        return self._initial_value

    @property
    def initializer(self):
        return self._initializer_op

    def set_sharding(self, spec):
        """Record a PartitionSpec-like sharding (``parallel.shard_variable``);
        with no mesh nothing reads it."""
        self._op.attrs["sharding"] = spec

    def value(self):
        return self._snapshot

    def read_value(self):
        """A fresh read op: under ``control_dependencies([assign])`` it
        observes the write."""
        g = ops_mod.get_default_graph()
        op = g.create_op("ReadVariable", [],
                         attrs={"var_name": self._var_name}, name="read",
                         output_specs=[(self.shape, self.dtype.base_dtype)])
        return op.outputs[0]

    def _grad_anchor(self):
        """The tensor ``stf.gradients`` differentiates for this Variable."""
        return self._ref

    def eval(self, session=None):
        return self._ref.eval(session=session)

    def assign(self, value, use_locking=False, read_value=True):
        return state_ops.assign(self._ref, value)

    def assign_add(self, delta, use_locking=False, read_value=True):
        return state_ops.assign_add(self._ref, delta)

    def assign_sub(self, delta, use_locking=False, read_value=True):
        return state_ops.assign_sub(self._ref, delta)

    def load(self, value, session=None):
        """Set the store value directly (host path, no graph op)."""
        from ..client.session import get_default_session

        session = session or get_default_session()
        if session is None:
            raise ValueError("No session for Variable.load")
        session._variable_store.load(self._var_name, value, self)

    def _as_graph_element(self):
        return self._ref

    def to_proto(self, export_scope=None):
        return {"variable_name": self.name,
                "initial_value_name": self._initial_value.name,
                "initializer_name": self._initializer_op.name,
                "snapshot_name": self._snapshot.name,
                "trainable": self._trainable}

    @classmethod
    def from_proto(cls, proto, import_scope=None, graph=None):
        """A Variable bound to ops already imported into ``graph`` (ref:
        variables.py ``Variable.from_proto``); makes no op."""
        g = graph or ops_mod.get_default_graph()

        def _scoped(name):
            return f"{import_scope}/{name}" if import_scope else name

        self = cls.__new__(cls)
        ref = g.as_graph_element(_scoped(proto["variable_name"]),
                                 allow_tensor=True, allow_operation=False)
        self._graph = g
        self._ref = ref
        self._op = ref.op
        self._var_name = ref.op.attrs.get(
            "var_name", _scoped(proto["variable_name"]).split(":")[0])
        self._trainable = bool(proto.get("trainable", True))
        self._initializer_op = g.as_graph_element(
            _scoped(proto["initializer_name"]), allow_tensor=False,
            allow_operation=True)
        self._snapshot = g.as_graph_element(
            _scoped(proto["snapshot_name"]), allow_tensor=True,
            allow_operation=False)
        try:
            self._initial_value = g.as_graph_element(
                _scoped(proto["initial_value_name"]), allow_tensor=True,
                allow_operation=False)
        except (KeyError, ValueError):
            self._initial_value = None
        g._scoped_state.setdefault("__vars_by_store_name__",
                                   {})[self._var_name] = self
        return self

    def __repr__(self):
        return (f"<stf.Variable '{self.name}' shape={self.shape} "
                f"dtype={self.dtype.base_dtype.name}>")


def _variable_conversion(value, dtype=None, name=None):
    t = value._ref
    if dtype is not None and \
            not dtypes_mod.as_dtype(dtype).is_compatible_with(t.dtype):
        return NotImplemented
    return t


ops_mod.register_tensor_conversion_function(Variable, _variable_conversion)


def variables_by_store_name(graph) -> dict:
    """``{store name: Variable}`` of every Variable built in ``graph``."""
    return dict(graph._scoped_state.get("__vars_by_store_name__", {}))


def global_variables():
    return ops_mod.get_default_graph().get_collection(
        GraphKeys.GLOBAL_VARIABLES)


def local_variables():
    return ops_mod.get_default_graph().get_collection(
        GraphKeys.LOCAL_VARIABLES)


def trainable_variables():
    return ops_mod.get_default_graph().get_collection(
        GraphKeys.TRAINABLE_VARIABLES)


def variables_initializer(var_list, name="init"):
    from . import control_flow_ops

    if not var_list:
        return control_flow_ops.no_op(name=name)
    return control_flow_ops.group(*[v.initializer for v in var_list],
                                  name=name)


def global_variables_initializer():
    return variables_initializer(global_variables(), "init")


initialize_all_variables = global_variables_initializer


def local_variables_initializer():
    return variables_initializer(local_variables(), "init_local")
