"""Graph IR of the port: ``Graph``, ``Operation``, ``Tensor``.

Port of ``simple_tensorflow_tpu/framework/graph.py``: ``GraphKeys`` (:42),
``Tensor`` (:78), ``Operation`` (:242), ``Graph`` (:351) with its op
counter, names, collections and control-dependency scopes, the
default-graph stack (:767-809), ``name_scope`` (:811),
``control_dependencies`` (:825) and ``convert_to_tensor`` (:883). The
graph is append-only; ``Session.run`` prunes it to the fetches and runs the
op list on the session's device (``framework/lowering.py``). Op ids come
from the same counter as the JAX package's, so a graph built by the same
user code numbers its ops alike (seeded random ops read the counter).
Left out: ``FuncGraph`` and captures (control flow), op-creation
tracebacks, device/colocation placement, gradient override maps and
GraphDef serialisation.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import dtypes as dtypes_mod
from . import tensor_shape as shape_mod


class GraphKeys:
    """Standard collection names (ref: python/framework/ops.py
    ``GraphKeys``)."""

    GLOBAL_VARIABLES = "variables"
    LOCAL_VARIABLES = "local_variables"
    MODEL_VARIABLES = "model_variables"
    TRAINABLE_VARIABLES = "trainable_variables"
    SUMMARIES = "summaries"
    MOVING_AVERAGE_VARIABLES = "moving_average_variables"
    REGULARIZATION_LOSSES = "regularization_losses"
    UPDATE_OPS = "update_ops"
    LOSSES = "losses"
    GLOBAL_STEP = "global_step"
    TRAIN_OP = "train_op"
    SAVERS = "savers"
    SAVEABLE_OBJECTS = "saveable_objects"
    VARIABLES = GLOBAL_VARIABLES  # deprecated alias


class Tensor:
    """Symbolic handle to one output of an Operation, with a static dtype
    and a possibly partial shape."""

    __slots__ = ("_op", "_value_index", "_dtype", "_shape", "__weakref__")

    def __init__(self, op: "Operation", value_index: int, dtype, shape):
        self._op = op
        self._value_index = value_index
        self._dtype = dtypes_mod.as_dtype(dtype)
        self._shape = shape_mod.as_shape(shape)

    @property
    def op(self) -> "Operation":
        return self._op

    @property
    def graph(self) -> "Graph":
        return self._op.graph

    @property
    def value_index(self) -> int:
        return self._value_index

    @property
    def dtype(self) -> dtypes_mod.DType:
        return self._dtype

    @property
    def shape(self) -> shape_mod.TensorShape:
        return self._shape

    def get_shape(self) -> shape_mod.TensorShape:
        return self._shape

    def set_shape(self, shape):
        self._shape = self._shape.merge_with(shape)

    @property
    def name(self) -> str:
        return f"{self._op.name}:{self._value_index}"

    @property
    def ndim(self):
        return self._shape.rank

    def consumers(self) -> List["Operation"]:
        return self.graph._consumers(self)

    def eval(self, feed_dict=None, session=None):
        from ..client.session import get_default_session

        session = session or get_default_session()
        if session is None:
            raise ValueError(
                "Cannot evaluate tensor using `eval()`: No default session")
        return session.run(self, feed_dict=feed_dict)

    def __repr__(self):
        return (f"<stf.Tensor '{self.name}' shape={self._shape} "
                f"dtype={self._dtype.name}>")

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        # identity; elementwise equality is stf.equal()
        return self is other

    def __bool__(self):
        raise TypeError(
            "Using a symbolic stf.Tensor as a Python bool is not allowed; "
            "run it in a Session first.")

    __array_priority__ = 100

    def __array__(self, *a, **k):
        raise NotImplementedError(
            f"Cannot convert symbolic tensor {self.name} to a numpy array: "
            "run it in a Session first.")

    # arithmetic operators are attached by ops/math_ops.py


class Operation:
    """A node of the Graph, immutable after construction. ``attrs`` holds
    the static attributes (Python scalars, shapes, dtypes, numpy
    constants)."""

    __slots__ = ("_graph", "_type", "_name", "_inputs", "_control_inputs",
                 "_attrs", "_outputs", "_id", "__weakref__")

    def __init__(self, graph, op_type, name, inputs, control_inputs, attrs,
                 output_specs):
        self._graph = graph
        self._type = op_type
        self._name = name
        self._inputs: Tuple[Tensor, ...] = tuple(inputs)
        self._control_inputs: Tuple[Operation, ...] = tuple(control_inputs)
        self._attrs: Dict[str, Any] = dict(attrs)
        self._id = graph._next_id()
        self._outputs = tuple(
            Tensor(self, i, dt, sh) for i, (sh, dt) in enumerate(output_specs))

    @property
    def graph(self):
        return self._graph

    @property
    def type(self) -> str:
        return self._type

    @property
    def name(self) -> str:
        return self._name

    @property
    def inputs(self) -> Tuple[Tensor, ...]:
        return self._inputs

    @property
    def control_inputs(self) -> Tuple["Operation", ...]:
        return self._control_inputs

    @property
    def outputs(self) -> Tuple[Tensor, ...]:
        return self._outputs

    @property
    def attrs(self) -> Dict[str, Any]:
        return self._attrs

    def get_attr(self, name):
        try:
            return self._attrs[name]
        except KeyError:
            raise ValueError(
                f"Operation {self._name!r} has no attr {name!r}") from None

    @property
    def op_def(self):
        from . import op_registry

        return op_registry.get(self._type)

    def run(self, feed_dict=None, session=None):
        from ..client.session import get_default_session

        session = session or get_default_session()
        if session is None:
            raise ValueError("No default session for Operation.run()")
        session.run(self, feed_dict=feed_dict)

    def __repr__(self):
        return f"<stf.Operation '{self._name}' type={self._type}>"


class Graph:
    """An append-only dataflow graph (ref: python/framework/ops.py:2531
    ``class Graph``): operations are never mutated or removed, so a planned
    run stays valid as the graph grows."""

    def __init__(self):
        self._lock = threading.RLock()
        self._ops_by_name: Dict[str, Operation] = {}
        self._ops_in_order: List[Operation] = []
        self._op_counter = 0
        self._names_in_use: Dict[str, int] = {}
        self._name_stack = ""
        self._collections: Dict[str, list] = {}
        self._control_deps_stack: List[List[Operation]] = []
        self._seed: Optional[int] = None
        self._finalized = False
        self._consumers_map: Dict[Tensor, List[Operation]] = {}
        # variable_scope's store and scope stack, the variable registry
        self._scoped_state: Dict[str, Any] = {}

    def _next_id(self) -> int:
        self._op_counter += 1
        return self._op_counter

    def finalize(self):
        self._finalized = True

    @property
    def finalized(self):
        return self._finalized

    # -- naming --------------------------------------------------------------
    def unique_name(self, name: str, mark_as_used=True) -> str:
        if self._name_stack:
            name = f"{self._name_stack}/{name}"
        i = self._names_in_use.get(name, 0)
        if mark_as_used:
            self._names_in_use[name] = i + 1
        if i > 0:
            base = name
            name = f"{base}_{i}"
            while name in self._names_in_use:
                i += 1
                name = f"{base}_{i}"
            if mark_as_used:
                self._names_in_use[name] = 1
        return name

    @contextlib.contextmanager
    def name_scope(self, name: Optional[str]):
        old = self._name_stack
        if name is None or name == "":
            self._name_stack = ""
        elif name.endswith("/"):
            self._name_stack = name[:-1]
        else:
            self._name_stack = self.unique_name(name)
        try:
            yield (self._name_stack + "/") if self._name_stack else ""
        finally:
            self._name_stack = old

    # -- control dependencies ------------------------------------------------
    @contextlib.contextmanager
    def control_dependencies(self, control_inputs):
        if control_inputs is None:
            saved = self._control_deps_stack
            self._control_deps_stack = []
            try:
                yield
            finally:
                self._control_deps_stack = saved
            return
        ops = []
        for c in control_inputs:
            if isinstance(c, Tensor):
                ops.append(c.op)
            elif isinstance(c, Operation):
                ops.append(c)
            elif hasattr(c, "op"):  # Variable
                ops.append(c.op)
            else:
                raise TypeError(
                    f"control input must be Operation/Tensor, got {c!r}")
        self._control_deps_stack.append(ops)
        try:
            yield
        finally:
            self._control_deps_stack.pop()

    def _current_control_dependencies(self) -> List[Operation]:
        out = []
        for frame in self._control_deps_stack:
            for op in frame:
                if op not in out:
                    out.append(op)
        return out

    # -- seeds ---------------------------------------------------------------
    @property
    def seed(self):
        return self._seed

    @seed.setter
    def seed(self, value):
        self._seed = value

    # -- collections ---------------------------------------------------------
    def add_to_collection(self, name, value):
        with self._lock:
            self._collections.setdefault(name, []).append(value)

    def add_to_collections(self, names, value):
        if isinstance(names, str):
            names = [names]
        for n in names:
            self.add_to_collection(n, value)

    def get_collection(self, name, scope=None) -> list:
        with self._lock:
            items = list(self._collections.get(name, []))
        if scope is None:
            return items
        rx = re.compile(scope)
        return [item for item in items
                if getattr(item, "name", None) and rx.match(item.name)]

    def get_collection_ref(self, name) -> list:
        with self._lock:
            return self._collections.setdefault(name, [])

    # -- op construction -----------------------------------------------------
    def create_op(self, op_type: str, inputs: Sequence[Tensor],
                  attrs: Optional[Dict[str, Any]] = None,
                  name: Optional[str] = None, output_specs=None,
                  control_inputs: Sequence[Operation] = ()) -> Operation:
        """Create and register an Operation; ``output_specs`` (a list of
        ``(shape, dtype)``) defaults to the op registry's inference."""
        from . import op_registry

        if self._finalized:
            raise RuntimeError("Graph is finalized and cannot be modified.")
        attrs = attrs or {}
        if name and name.endswith("/"):
            # a trailing slash means "use this exact, already-scoped name"
            name = name[:-1]
            if name in self._ops_by_name:
                raise ValueError(f"Op name {name!r} already used")
        else:
            name = self.unique_name(name or op_type)
        opdef = op_registry.get(op_type)
        checked = []
        for i, t in enumerate(inputs):
            if not isinstance(t, Tensor):
                raise TypeError(f"Input {i} of op {name!r} ({op_type}) is "
                                f"not a Tensor: {t!r}")
            checked.append(self._maybe_capture(t, name))
        inputs = tuple(checked)
        if output_specs is None:
            output_specs = opdef.infer(self, attrs, inputs)
        ctrl = list(control_inputs) + [
            c for c in self._current_control_dependencies()
            if c not in control_inputs]
        op = Operation(self, op_type, name, inputs, ctrl, attrs,
                       output_specs)
        with self._lock:
            self._ops_by_name[name] = op
            self._ops_in_order.append(op)
            for t in inputs:
                self._consumers_map.setdefault(t, []).append(op)
        return op

    def _maybe_capture(self, t: Tensor, for_op: str) -> Tensor:
        """Same-graph tensors pass through; in a FuncGraph, an outer
        graph's tensor is captured (through every graph between)."""
        if t.graph is self:
            return t
        if isinstance(self, FuncGraph):
            og = self.outer_graph
            if t.graph is og:
                return self.capture(t)
            return self.capture(og._maybe_capture(t, for_op))
        raise ValueError(
            f"Input {t.name} of {for_op!r} is from a different graph.")

    # -- lookup --------------------------------------------------------------
    def get_operations(self) -> List[Operation]:
        with self._lock:
            return list(self._ops_in_order)

    def get_operation_by_name(self, name: str) -> Operation:
        with self._lock:
            if name not in self._ops_by_name:
                raise KeyError(f"Operation {name!r} not found in graph")
            return self._ops_by_name[name]

    def get_tensor_by_name(self, name: str) -> Tensor:
        if ":" not in name:
            raise ValueError(
                f"{name!r} is an operation name, not a tensor name "
                "(tensor names look like 'op:0')")
        op_name, idx = name.rsplit(":", 1)
        return self.get_operation_by_name(op_name).outputs[int(idx)]

    def as_graph_element(self, obj, allow_tensor=True, allow_operation=True):
        """(ref: ops.py ``Graph.as_graph_element``)."""
        if isinstance(obj, Tensor):
            if not allow_tensor:
                raise TypeError("Tensor not allowed here")
            if obj.graph is not self:
                raise ValueError(f"Tensor {obj} is not from this graph")
            return obj
        if isinstance(obj, Operation):
            if not allow_operation:
                raise TypeError("Operation not allowed here")
            if obj.graph is not self:
                raise ValueError(f"Operation {obj} is not from this graph")
            return obj
        if hasattr(obj, "_as_graph_element"):
            return self.as_graph_element(obj._as_graph_element(),
                                         allow_tensor, allow_operation)
        if isinstance(obj, str):
            if ":" in obj:
                return self.get_tensor_by_name(obj)
            return self.get_operation_by_name(obj)
        raise TypeError(f"Cannot convert {obj!r} to a graph element")

    def _consumers(self, tensor: Tensor) -> List[Operation]:
        with self._lock:
            return list(self._consumers_map.get(tensor, []))

    @contextlib.contextmanager
    def as_default(self):
        stack = _get_graph_stack()
        stack.append(self)
        try:
            yield self
        finally:
            stack.pop()

    def __repr__(self):
        return f"<stf.Graph with {len(self._ops_in_order)} ops>"


class FuncGraph(Graph):
    """A nested graph with captures: the body of a graph function (ref:
    the JAX package's ``FuncGraph``, the TF-2 one). ``captures``: (outer
    tensor, inner ``CapturedInput`` output) pairs; ``inputs``: the
    ``FuncArg`` outputs; ``outputs``: set by the tracer."""

    def __init__(self, name: str, outer_graph: Graph):
        super().__init__()
        self.func_name = name
        self.outer_graph = outer_graph
        self.captures: List[Tuple[Tensor, Tensor]] = []
        self.inputs: List[Tensor] = []
        self.outputs: List[Tensor] = []
        self._seed = outer_graph.seed

    def capture(self, outer_tensor: Tensor) -> Tensor:
        for ext, internal in self.captures:
            if ext is outer_tensor:
                return internal
        op = self.create_op(
            "CapturedInput", [],
            attrs={"dtype": outer_tensor.dtype, "shape": outer_tensor.shape},
            name=f"captured_{len(self.captures)}",
            output_specs=[(outer_tensor.shape, outer_tensor.dtype)])
        internal = op.outputs[0]
        self.captures.append((outer_tensor, internal))
        return internal

    def add_input(self, dtype, shape, name="arg") -> Tensor:
        op = self.create_op("FuncArg", [],
                            attrs={"dtype": dtypes_mod.as_dtype(dtype),
                                   "shape": shape_mod.as_shape(shape),
                                   "index": len(self.inputs)},
                            name=name, output_specs=[(shape, dtype)])
        t = op.outputs[0]
        self.inputs.append(t)
        return t


_default_graph_stack = threading.local()
_global_default_graph: Optional[Graph] = None
_global_lock = threading.Lock()


def _get_graph_stack() -> List[Graph]:
    if not hasattr(_default_graph_stack, "stack"):
        _default_graph_stack.stack = []
    return _default_graph_stack.stack


def get_default_graph() -> Graph:
    stack = _get_graph_stack()
    if stack:
        return stack[-1]
    global _global_default_graph
    with _global_lock:
        if _global_default_graph is None:
            _global_default_graph = Graph()
        return _global_default_graph


def _root_graph(g: Optional[Graph] = None) -> Graph:
    """The outermost (non-FuncGraph) graph around ``g`` (default: the
    default graph), where variables live: a variable made while a body is
    traced belongs to the root graph and is captured into the body."""
    g = g or get_default_graph()
    while isinstance(g, FuncGraph):
        g = g.outer_graph
    return g


def reset_default_graph():
    global _global_default_graph
    if _get_graph_stack():
        raise AssertionError("Do not use reset_default_graph() inside a "
                             "`with g.as_default()` block.")
    with _global_lock:
        _global_default_graph = Graph()


@contextlib.contextmanager
def _as_current(graph):
    stack = _get_graph_stack()
    stack.append(graph)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def name_scope(name, default_name=None, values=None):
    """Module-level name_scope (ref: ops.py:4164 ``name_scope``)."""
    scope_name = name if name is not None else default_name
    with get_default_graph().name_scope(scope_name) as scope:
        yield scope


@contextlib.contextmanager
def control_dependencies(control_inputs):
    with get_default_graph().control_dependencies(control_inputs):
        yield


def add_to_collection(name, value):
    get_default_graph().add_to_collection(name, value)


def add_to_collections(names, value):
    get_default_graph().add_to_collections(names, value)


def get_collection(name, scope=None):
    return get_default_graph().get_collection(name, scope)


def get_collection_ref(name):
    return get_default_graph().get_collection_ref(name)


_tensor_conversion_funcs: List[Tuple[int, type, Callable]] = []


def register_tensor_conversion_function(base_type, conversion_func,
                                        priority=100):
    _tensor_conversion_funcs.append((priority, base_type, conversion_func))
    _tensor_conversion_funcs.sort(key=lambda x: x[0])


def convert_to_tensor(value, dtype=None, name=None, preferred_dtype=None):
    """Python/numpy values and Variables as graph Tensors (ref: ops.py:836
    ``convert_to_tensor``); a Tensor of another dtype is cast."""
    g = get_default_graph()
    if isinstance(value, Tensor):
        if dtype is not None and not dtypes_mod.as_dtype(
                dtype).is_compatible_with(value.dtype):
            from ..ops import math_ops

            return math_ops.cast(value, dtype)
        if value.graph is g or isinstance(g, FuncGraph):
            return g._maybe_capture(value, name or "convert_to_tensor")
        raise ValueError(f"Tensor {value.name} belongs to a different graph.")
    for _, base_type, func in _tensor_conversion_funcs:
        if isinstance(value, base_type):
            ret = func(value, dtype=dtype, name=name)
            if ret is not NotImplemented:
                return convert_to_tensor(ret, dtype=dtype, name=name)
    from . import constant_op

    return constant_op.constant(value, dtype=dtype, name=name or "Const")
