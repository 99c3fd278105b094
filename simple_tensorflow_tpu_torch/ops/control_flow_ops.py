"""``no_op`` and ``group`` (port of the part of ``simple_tensorflow_tpu/
ops/control_flow_ops.py`` the optimizers and initializers reach: a node
whose control edges pull its inputs into the pruned run). Left out:
``cond``, ``while_loop``, ``case`` and ``tuple``, which need
``FuncGraph``."""

from __future__ import annotations

import builtins
from typing import Any, List

from ..framework import graph as ops_mod
from ..framework import op_registry

Tensor = ops_mod.Tensor


def _flatten(structure):
    """Flatten nested (list/tuple/dict) structures of Tensors."""
    flat: List[Any] = []

    def rec(s):
        if isinstance(s, (list, builtins.tuple)) and not isinstance(s, str):
            for x in s:
                rec(x)
        elif isinstance(s, dict):
            for k in sorted(s):
                rec(s[k])
        else:
            flat.append(s)

    rec(structure)
    return flat


def _lower_noop(ctx, op, inputs):
    return []


op_registry.register("NoOp", lower=_lower_noop, is_stateful=True)
op_registry.register("Group", lower=_lower_noop, is_stateful=True)


def no_op(name=None):
    g = ops_mod.get_default_graph()
    return g.create_op("NoOp", [], name=name or "NoOp", output_specs=[])


def group(*inputs, **kwargs):
    """An op that completes when all inputs complete (ref:
    control_flow_ops.py:2855 ``group``)."""
    name = kwargs.pop("name", None)
    g = ops_mod.get_default_graph()
    ctrl = []
    for x in _flatten(list(inputs)):
        if isinstance(x, Tensor):
            ctrl.append(x.op)
        elif isinstance(x, ops_mod.Operation):
            ctrl.append(x)
        elif hasattr(x, "op"):
            ctrl.append(x.op)
        elif x is None:
            continue
        else:
            raise TypeError(f"group: cannot handle {x!r}")
    return g.create_op("Group", [], name=name or "group", output_specs=[],
                       control_inputs=ctrl)
