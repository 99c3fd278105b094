"""Graph optimizer base class (port of ``simple_tensorflow_tpu/train/
optimizer.py``; ref: tensorflow/python/training/optimizer.py).

``minimize`` (:53) = ``compute_gradients`` (:69), one ``SymbolicGradient``
op over the trainable variables, then ``apply_gradients`` (:79): the
subclass's fused update op, or its per-variable ``_apply_dense`` ops
grouped as ``update``, and with a ``global_step`` its ``AssignAdd``
under a control dependency on the update. Ops are created in the JAX
package's order and under its names. Left out: sparse (``IndexedSlices``)
gradients and per-variable slot creation.
"""

from __future__ import annotations

from ..framework import gradients as gradients_mod
from ..framework import graph as ops_mod
from ..ops import control_flow_ops, state_ops
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
        """The per-variable view of a fused flat slot, or None."""
        return self._slot_views.get(name, {}).get(_var_key(var))

    def get_slot_names(self):
        return sorted(self._slot_views)

    def variables(self):
        return list(self._fused_slot_vars)

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


def _var_key(var):
    return var.var_name if hasattr(var, "var_name") else var.name
