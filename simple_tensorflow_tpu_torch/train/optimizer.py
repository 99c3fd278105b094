"""Graph optimizer base class (port of ``simple_tensorflow_tpu/train/
optimizer.py``; ref: tensorflow/python/training/optimizer.py).

``minimize`` (:53) = ``compute_gradients`` (:69), one ``SymbolicGradient``
op over the trainable variables, then ``apply_gradients`` (:79): the
subclass's fused update op, or (after ``_create_slots``) its
per-variable ``_apply_dense`` ops grouped as ``update``,
and with a ``global_step`` its ``AssignAdd`` under a control dependency on
the update. Per-variable slots are zero-initialised variables named
``{variable}/{optimizer}/{slot}`` in the update dtype (``slot_creator.
create_zeros_slot``). Ops are created in the JAX package's order and under
its names. Left out: sparse (``IndexedSlices``) gradients.
"""

from __future__ import annotations

from ..framework import dtypes as dtypes_mod
from ..framework import gradients as gradients_mod
from ..framework import graph as ops_mod
from ..ops import array_ops, control_flow_ops, state_ops
from ..ops import variables as variables_mod

GATE_NONE = 0
GATE_OP = 1
GATE_GRAPH = 2


class Optimizer:
    GATE_NONE = GATE_NONE
    GATE_OP = GATE_OP
    GATE_GRAPH = GATE_GRAPH

    def __init__(self, use_locking, name):
        if not name:
            raise ValueError("Must specify optimizer name")
        self._use_locking = use_locking
        self._name = name
        self._slots = {}  # slot name -> {var name: slot Variable}
        # the fused tail's per-variable slot views, flat slot variables and
        # their cache (train/optimizers.py:_flat_slot_layout)
        self._slot_views = {}
        self._fused_slot_vars = []
        self._flat_slot_cache = {}

    @property
    def name(self):
        return self._name

    def minimize(self, loss, global_step=None, var_list=None,
                 gate_gradients=GATE_OP, aggregation_method=None,
                 colocate_gradients_with_ops=False, name=None,
                 grad_loss=None):
        grads_and_vars = self.compute_gradients(
            loss, var_list=var_list, grad_loss=grad_loss)
        if not any(g is not None for g, _ in grads_and_vars):
            raise ValueError(
                f"No gradients provided for any variable: "
                f"{[v.name for _, v in grads_and_vars]}")
        return self.apply_gradients(grads_and_vars, global_step=global_step,
                                    name=name)

    def compute_gradients(self, loss, var_list=None, gate_gradients=GATE_OP,
                          aggregation_method=None,
                          colocate_gradients_with_ops=False, grad_loss=None):
        if var_list is None:
            var_list = variables_mod.trainable_variables()
        grads = gradients_mod.gradients(
            loss, var_list,
            grad_ys=[grad_loss] if grad_loss is not None else None)
        return list(zip(grads, var_list))

    def apply_gradients(self, grads_and_vars, global_step=None, name=None):
        grads_and_vars = list(grads_and_vars)
        if not grads_and_vars:
            raise ValueError("No variables provided.")
        if not any(g is not None for g, _ in grads_and_vars):
            raise ValueError("No gradients provided for any variable")
        g = ops_mod.get_default_graph()
        with g.name_scope(name or self._name):
            finish = self._maybe_build_fused_update(grads_and_vars)
            if finish is None:
                self._create_slots([v for grad, v in grads_and_vars
                                    if grad is not None])
                update_ops = [self._apply_dense(grad, var)
                              for grad, var in grads_and_vars
                              if grad is not None]
                finish = self._finish(update_ops, "update")
            if global_step is not None:
                with g.control_dependencies([finish]):
                    incr = state_ops.assign_add(
                        global_step._ref if isinstance(
                            global_step, variables_mod.Variable)
                        else global_step, 1)
                return control_flow_ops.group(finish, incr.op,
                                              name="apply_gradients")
            return finish

    def get_slot(self, var, name):
        """The per-variable view of a fused flat slot, or the per-variable
        slot Variable, or None."""
        view = self._slot_views.get(name, {}).get(_var_key(var))
        if view is not None:
            return view
        return self._slots.get(name, {}).get(_var_key(var))

    def get_slot_names(self):
        return sorted(set(self._slots) | set(self._slot_views))

    def variables(self):
        out = [v for d in self._slots.values() for v in d.values()]
        return out + list(self._fused_slot_vars)

    def _zeros_slot(self, var, slot_name, op_name):
        named = self._slots.setdefault(slot_name, {})
        key = _var_key(var)
        if key not in named:
            named[key] = variables_mod.Variable(
                array_ops.zeros([int(d) for d in var.shape.as_list()],
                                dtype=update_dtype(var)),
                trainable=False, name=f"{var.var_name}/{op_name}/{slot_name}")
        return named[key]

    def _create_slots(self, var_list):
        pass

    def _maybe_build_fused_update(self, grads_and_vars):
        """One fused update op over every (grad, var) pair, or None for
        the per-variable ``_apply_dense`` ops."""
        return None

    def _apply_dense(self, grad, var):
        raise NotImplementedError

    def _finish(self, update_ops, name_scope):
        return control_flow_ops.group(*update_ops, name=name_scope)

    def _call_if_callable(self, param):
        return param() if callable(param) else param


def update_dtype(var):
    """The slot and update dtype of a graph variable (``slot_creator.
    update_dtype``): f32 for low-precision floats, else its own."""
    d = var.dtype.base_dtype
    return dtypes_mod.float32 if d.name in ("bfloat16", "float16") else d


def _var_key(var):
    return var.var_name if hasattr(var, "var_name") else var.name
