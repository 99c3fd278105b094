"""Symbolic gradients.

Port of ``simple_tensorflow_tpu/framework/gradients.py``: ``gradients``
(:213) inserts ONE ``SymbolicGradient`` op for ``d(sum ys)/d(xs)``, exactly
as the JAX package does, with ``_ReadIndex`` (:182): a Variable passed as
an x stands for every read of it the ys reach, and the cotangents of
several reads sum (``AddN``).

The lowering differs. The JAX package re-traces the forward slice under
``jax.vjp``. Here the Session gives the xs' values ``requires_grad``
leaves as the forward makes them (``LoweringContext.grad_leaves``), the
forward runs once, and the op lowers to ``torch.autograd.grad(ys, xs,
grad_ys)``: the kernels' ``autograd.Function`` backwards run (the xent
backward kernel, the Dropout backward from the forward's saved mask bits,
where JAX re-draws the mask from the same key). A ``While`` without
``maximum_iterations`` on a differentiable path to the ys raises
``InvalidArgumentError`` here, at graph construction, with JAX's message
(:262-280; ``_while_reaches_ys_differentiably`` :153); a path that a
``StopGradient`` cuts or that carries only integers does not. A bounded
``While`` and a ``Cond`` differentiate (``ops/control_flow_ops.py``).
Left out: ``stop_gradients``, gradient override maps, ``hessians`` and
``GradientTape``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import graph as ops_mod
from . import lowering as lowering_mod
from . import op_registry
from .errors import InvalidArgumentError

Tensor = ops_mod.Tensor


def _as_tensor_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _while_reaches_ys_differentiably(while_op, ys):
    """True iff a While op's output can carry a nonzero cotangent from ys:
    a path cut by a StopGradient op, or passing only through non-floating
    tensors (argmax or sampled indices feeding a gather), does not."""
    yset = set(ys)
    seen = set()
    work = [t for t in while_op.outputs
            if t.dtype.is_floating or t.dtype.is_complex]
    while work:
        t = work.pop()
        if t in seen:
            continue
        seen.add(t)
        if t in yset:
            return True
        for consumer in t.consumers():
            if consumer.type == "StopGradient":
                continue
            for out in consumer.outputs:
                if out.dtype.is_floating or out.dtype.is_complex:
                    work.append(out)
    return False


class _ReadIndex:
    """Lazy var_name -> ReadVariable outputs over a graph: the tensors
    TF-1 treats as "the variable" for differentiation (the ref, the
    cached ``value()`` snapshot and explicit ``read_value()`` reads)."""

    def __init__(self, g):
        self._g = g
        self._by_var = None

    def candidates(self, x):
        if not hasattr(x, "_grad_anchor"):
            return [x]
        cands = [x._grad_anchor()]
        base = getattr(x, "_var_name", None)
        if base is not None:
            if self._by_var is None:
                self._by_var = {}
                for op_ in self._g.get_operations():
                    if op_.type == "ReadVariable":
                        self._by_var.setdefault(
                            op_.attrs.get("var_name"),
                            []).append(op_.outputs[0])
            cands.extend(self._by_var.get(base, ()))
        return cands


def gradients(ys, xs, grad_ys=None, name="gradients",
              colocate_gradients_with_ops=False, gate_gradients=False,
              aggregation_method=None, stop_gradients=None
              ) -> List[Optional[Tensor]]:
    """``d(sum ys)/d(xs)`` (ref: python/ops/gradients_impl.py:154): a list
    aligned with ``xs``, None for an x the ys do not reach."""
    if stop_gradients:
        raise NotImplementedError("gradients(stop_gradients=...) is not "
                                  "ported; use stf.stop_gradient")
    ys = _as_tensor_list(ys)
    xs_in = _as_tensor_list(xs)
    g = ops_mod.get_default_graph()
    xs = []
    xs_groups = []
    seen_x = set()
    index = _ReadIndex(g)
    for x in xs_in:
        if not (hasattr(x, "_grad_anchor") or isinstance(x, Tensor)):
            raise TypeError(
                f"gradients: xs must be Tensors/Variables, got {x!r}")
        cands = index.candidates(x)
        xs_groups.append(cands)
        for c in cands:
            if c not in seen_x:
                seen_x.add(c)
                xs.append(c)
    if grad_ys is not None:
        grad_ys = [ops_mod.convert_to_tensor(gy) if gy is not None else None
                   for gy in _as_tensor_list(grad_ys)]
        if len(grad_ys) != len(ys):
            raise ValueError("grad_ys must match ys in length")
    else:
        grad_ys = [None] * len(ys)

    path_ops, connected = lowering_mod.ancestors_between(xs, ys)
    while_on_path = [o.name for o in path_ops if o.type == "While"
                     and o.attrs.get("max_iterations") is None
                     and _while_reaches_ys_differentiably(o, ys)]
    if while_on_path:
        raise InvalidArgumentError(
            None, None,
            "Reverse-mode gradients cannot cross an UNBOUNDED while_loop "
            f"on TPU (XLA cannot differentiate it; on path: "
            f"{while_on_path[:3]}). Pass maximum_iterations= to "
            "while_loop (the bounded loop replays as a masked, "
            "differentiable lax.scan in the backward pass), or use "
            "stf.scan / stf.foldl / dynamic_rnn (lax.scan-based).")
    with g.name_scope(name):
        connected_xs = [x for x in xs if x in connected
                        and (x.dtype.is_floating or x.dtype.is_complex)]
        if not connected_xs:
            return [None] * len(xs_groups)
        supplied_gys = [gy for gy in grad_ys if gy is not None]
        attrs = {"n_ys": len(ys), "n_xs": len(connected_xs),
                 "grad_ys_mask": tuple(gy is not None for gy in grad_ys),
                 "stop_tensors": ()}
        op = g.create_op("SymbolicGradient",
                         list(ys) + list(connected_xs) + supplied_gys,
                         attrs=attrs, name="grad",
                         output_specs=[(x.shape, x.dtype)
                                       for x in connected_xs])
        grads_by_x = dict(zip(connected_xs, op.outputs))
        out = []
        for cands in xs_groups:
            parts = [grads_by_x[c] for c in cands if c in grads_by_x]
            if not parts:
                out.append(None)
            elif len(parts) == 1:
                out.append(parts[0])
            else:
                from ..ops import math_ops

                out.append(math_ops.add_n(parts))
    return out


def symbolic_gradient_xs(op) -> list:
    """The xs of a ``SymbolicGradient`` op (the tensors the Session turns
    into leaves)."""
    n_ys, n_xs = op.attrs["n_ys"], op.attrs["n_xs"]
    return list(op.inputs[n_ys:n_ys + n_xs])


def _lower_symbolic_gradient(ctx, op, input_values):
    n_ys, n_xs = op.attrs["n_ys"], op.attrs["n_xs"]
    gys_mask = op.attrs["grad_ys_mask"]
    ys_vals = input_values[:n_ys]
    xs_vals = input_values[n_ys:n_ys + n_xs]
    supplied = iter(input_values[n_ys + n_xs:])
    ys_used, cots = [], []
    for i, y in enumerate(ys_vals):
        gy = next(supplied) if gys_mask[i] else None
        if not y.requires_grad:
            continue  # no path from any x: a zero cotangent
        ys_used.append(y)
        cots.append(torch.ones_like(y) if gy is None else gy.to(y.dtype))
    if not ys_used:
        return [torch.zeros_like(x) for x in xs_vals]
    grads = torch.autograd.grad(ys_used, xs_vals, cots, allow_unused=True,
                                retain_graph=ctx.retain_graph)
    return [torch.zeros_like(x) if gr is None else gr
            for gr, x in zip(grads, xs_vals)]


op_registry.register("SymbolicGradient", lower=_lower_symbolic_gradient)
