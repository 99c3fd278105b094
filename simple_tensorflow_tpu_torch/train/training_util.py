"""``global_step`` helpers (port of ``simple_tensorflow_tpu/train/
training_util.py``; ref: tensorflow/python/training/training_util.py).
The step is an int64 Variable, which computes and fetches as int32 under
the port's 64-bit rule, as in the JAX package."""

from __future__ import annotations

from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..ops import variables as variables_mod

GraphKeys = ops_mod.GraphKeys


def get_global_step(graph=None):
    graph = graph or ops_mod.get_default_graph()
    items = graph.get_collection(GraphKeys.GLOBAL_STEP)
    if items:
        return items[0]
    try:
        op = graph.get_operation_by_name("global_step")
    except KeyError:
        return None
    for v in graph.get_collection(GraphKeys.GLOBAL_VARIABLES):
        if v.op is op:
            return v
    return None


def create_global_step(graph=None):
    graph = graph or ops_mod.get_default_graph()
    if get_global_step(graph) is not None:
        raise ValueError('"global_step" already exists.')
    with ops_mod._as_current(graph):
        return variables_mod.Variable(
            0, trainable=False, dtype=dtypes_mod.int64, name="global_step",
            collections=[GraphKeys.GLOBAL_VARIABLES, GraphKeys.GLOBAL_STEP])


def get_or_create_global_step(graph=None):
    """(ref: training_util.py:39)."""
    graph = graph or ops_mod.get_default_graph()
    gs = get_global_step(graph)
    if gs is None:
        gs = create_global_step(graph)
    return gs
