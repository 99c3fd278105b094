"""``no_op`` and ``group`` (port of the part of ``simple_tensorflow_tpu/
ops/control_flow_ops.py`` the optimizers and initializers reach: a node
whose control edges pull its inputs into the pruned run), and the
structure helpers ``_flatten`` and ``_pack_like`` (:41-70) that
``ops/functional_ops.py`` and ``ops/rnn.py`` rebuild carries with
(namedtuples such as ``LSTMStateTuple`` included). ``cond``,
``while_loop`` and ``case`` raise ``NotImplementedError``: a trip count
or branch that depends on data either syncs to the host or needs CUDA
graph conditional nodes on the card (ROADMAP Queue 1, front-end item 1).
Left out: ``tuple`` and ``with_dependencies``."""

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


def _pack_like(structure, flat):
    """``flat`` (a list) in the nested structure of ``structure``."""
    it = iter(flat)

    def rec(s):
        if isinstance(s, (list, builtins.tuple)) and not isinstance(s, str):
            vals = [rec(x) for x in s]
            return type(s)(vals) if not hasattr(s, "_fields") \
                else type(s)(*vals)
        if isinstance(s, dict):
            return {k: rec(s[k]) for k in sorted(s)}
        return next(it)

    return rec(structure)


_NOT_PORTED = ("{} is not ported: data-dependent control flow on FuncGraph "
               "bodies is ROADMAP Queue 1, front-end item 1 (cond, "
               "while_loop, raw_rnn); stf.scan, map_fn and foldl run loops "
               "of a static trip count")


def cond(pred, true_fn=None, false_fn=None, strict=False, name=None,
         fn1=None, fn2=None):
    raise NotImplementedError(_NOT_PORTED.format("cond"))


def case(pred_fn_pairs, default=None, exclusive=False, strict=False,
         name="case"):
    raise NotImplementedError(_NOT_PORTED.format("case"))


def while_loop(cond, body, loop_vars, shape_invariants=None,
               parallel_iterations=10, back_prop=True, swap_memory=False,
               name=None, maximum_iterations=None):
    raise NotImplementedError(_NOT_PORTED.format("while_loop"))


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
