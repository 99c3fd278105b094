"""Control flow: ``cond``, ``case``, ``while_loop``, ``smart_cond``,
``no_op`` and ``group``.

Port of ``simple_tensorflow_tpu/ops/control_flow_ops.py``. The graph
construction is the JAX module's (:72-334, :425): branches and bodies are
``FuncGraph``s traced once, ``cond`` builds one ``Cond`` op (inputs
``[pred] + true captures + false captures``, attrs ``true_graph``,
``false_graph``, ``n_true_caps``), ``case`` a chain of them under its name
scope, ``while_loop`` one ``While`` op (inputs vars + cond captures + body
captures, attrs ``cond_graph``, ``body_graph``, ``n_vars``,
``n_cond_caps``, ``max_iterations``), with the same names, checks and
errors. The structure helpers ``_flatten`` and ``_pack_like`` are the
ones ``ops/functional_ops.py`` and ``ops/rnn.py`` rebuild carries with.

The lowerings have two forms:

- **Eager** (``Session.run``, and the warm-up before a capture): ``Cond``
  reads its predicate on the host and runs one branch; ``While`` runs the
  body while the predicate, read on the host before every iteration,
  holds, ``max_iterations`` capping it (JAX's ``_lower_cond`` :192 and
  ``_lower_while`` :337). Each read counts on the Session
  (``host_predicate_reads``). Autograd records the iterations that ran,
  so a bounded loop differentiates through exactly those and a body is
  never evaluated past the exit, as JAX's guarded replay (:347-377).
- **Captured** (a compiled step, ``LoweringContext.compiled``): nothing is
  read on the host. ``Cond`` is two IF nodes (the branch taken and its
  negation) that write one set of output buffers; ``While`` copies its
  vars into carry buffers and runs the body under a WHILE node, which
  copies the body's results back and recomputes the predicate on the
  device (``ops/kernels/control_flow.py``, the node setter in
  ``csrc/control_flow.cu``; on the CPU their plain version, a host loop).
  Where the step differentiates through the op, the node holds no
  autograd record, so the op is an ``autograd.Function``
  (:class:`_Guarded`) whose forward runs the branch or body under an IF
  node and whose backward recomputes it under the same predicate and
  takes the vector-Jacobian product there: ``Cond`` is one such call;
  a bounded ``While`` is ``max_iterations`` guarded steps, each active
  while every predicate so far held (JAX's replay, :347-377), so a body
  that is invalid past the exit never runs there, forward or backward.
  An unbounded ``While`` does not differentiate
  (``framework/gradients.py`` refuses it at graph construction).

Left out: ``tuple`` and ``with_dependencies``, the plan-time optimizer's
function-op registration and the sharding rules.
"""

from __future__ import annotations

import builtins
import weakref
from typing import Any, List

import numpy as np
import torch

from ..framework import constant_op
from ..framework import graph as ops_mod
from ..framework import lowering as lowering_mod
from ..framework import op_registry
from ..framework import tensor_shape as shape_mod
from ..framework.errors import InvalidArgumentError
from .kernels import control_flow as cf_kernels

Tensor = ops_mod.Tensor
FuncGraph = ops_mod.FuncGraph


# -- structure utils ---------------------------------------------------------

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


# -- simple ops --------------------------------------------------------------

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


# -- cond --------------------------------------------------------------------

def _build_branch(fn, name):
    g = ops_mod.get_default_graph()
    fg = FuncGraph(name, outer_graph=g)
    with ops_mod._as_current(fg):
        result = fn()
    flat = [ops_mod.convert_to_tensor(t) if not isinstance(t, Tensor) else t
            for t in _flatten(result)]
    # converted in the branch graph, so that constants land inside it
    with ops_mod._as_current(fg):
        flat = [t if t.graph is fg else fg._maybe_capture(t, name)
                for t in flat]
    fg.outputs = flat
    return fg, result


def cond(pred, true_fn=None, false_fn=None, strict=False, name=None,
         fn1=None, fn2=None):
    """(ref: control_flow_ops.py:1806 ``cond``): one ``Cond`` op."""
    true_fn = true_fn or fn1
    false_fn = false_fn or fn2
    if true_fn is None or false_fn is None:
        raise ValueError("cond needs true_fn and false_fn")
    g = ops_mod.get_default_graph()
    pred = ops_mod.convert_to_tensor(pred)
    with g.name_scope(name or "cond"):
        tg, t_struct = _build_branch(true_fn, "cond_true")
        fg, _ = _build_branch(false_fn, "cond_false")
        if len(tg.outputs) != len(fg.outputs):
            raise ValueError(
                f"cond branches returned different numbers of tensors: "
                f"{len(tg.outputs)} vs {len(fg.outputs)}")
        for a, b in zip(tg.outputs, fg.outputs):
            if a.dtype.base_dtype != b.dtype.base_dtype:
                raise TypeError(f"cond branch dtypes differ: "
                                f"{a.dtype.name} vs {b.dtype.name}")
        t_caps = [outer for outer, _ in tg.captures]
        f_caps = [outer for outer, _ in fg.captures]
        out_specs = [(a.shape.merge_with(b.shape)
                      if a.shape.is_compatible_with(b.shape)
                      else shape_mod.TensorShape(None), a.dtype)
                     for a, b in zip(tg.outputs, fg.outputs)]
        op = g.create_op(
            "Cond", [pred] + t_caps + f_caps,
            attrs={"true_graph": tg, "false_graph": fg,
                   "n_true_caps": len(t_caps)},
            name="cond_op", output_specs=out_specs)
    if not op.outputs:
        return None
    packed = _pack_like(t_struct, list(op.outputs))
    if not strict and isinstance(packed, (list, builtins.tuple)) \
            and len(packed) == 1:
        # non-strict mode unwraps singleton sequences (ref cond strict=)
        return packed[0]
    return packed


def case(pred_fn_pairs, default=None, exclusive=False, strict=False,
         name="case"):
    """(ref: control_flow_ops.py:3211 ``case``): chained ``cond``s."""
    if isinstance(pred_fn_pairs, dict):
        pairs = list(pred_fn_pairs.items())
    else:
        pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]

    def build(i):
        if i == len(pairs):
            return default
        p, f = pairs[i]
        return lambda: cond(p, f, build(i + 1))

    with ops_mod.name_scope(name):
        return build(0)()


def smart_cond(pred, true_fn, false_fn, name=None):
    """``true_fn()`` or ``false_fn()`` at graph construction when ``pred``
    is static, else :func:`cond`."""
    if isinstance(pred, Tensor):
        pv = constant_op.constant_value(pred)
    else:
        pv = np.asarray(pred)
    if pv is not None:
        return true_fn() if builtins.bool(pv) else false_fn()
    return cond(pred, true_fn, false_fn, name=name)


# -- while_loop --------------------------------------------------------------

def _call_with(fn, loop_vars, flat_args):
    """Rebuild the user's loop_vars structure from flat args and apply fn
    as the reference does (``fn(*top_level_items)``)."""
    if isinstance(loop_vars, (list, builtins.tuple)):
        packed = _pack_like(builtins.list(loop_vars), flat_args)
        return fn(*packed)
    return fn(_pack_like(loop_vars, flat_args))


def while_loop(cond, body, loop_vars, shape_invariants=None,
               parallel_iterations=10, back_prop=True, swap_memory=False,
               name=None, maximum_iterations=None):
    """(ref: control_flow_ops.py:2775 ``while_loop``): one ``While`` op.
    Gradients need ``maximum_iterations`` (module docstring); loop vars
    keep their dtypes, and their shapes unless ``shape_invariants`` is
    given."""
    g = ops_mod.get_default_graph()
    flat_vars = [ops_mod.convert_to_tensor(v) for v in _flatten(loop_vars)]
    with g.name_scope(name or "while"):
        cg = FuncGraph("while_cond", outer_graph=g)
        with ops_mod._as_current(cg):
            c_args = [cg.add_input(v.dtype, v.shape, f"arg{i}")
                      for i, v in enumerate(flat_vars)]
            c_res = _call_with(cond, loop_vars, c_args)
            cg.outputs = [ops_mod.convert_to_tensor(c_res)]
        bg = FuncGraph("while_body", outer_graph=g)
        with ops_mod._as_current(bg):
            b_args = [bg.add_input(v.dtype, v.shape, f"arg{i}")
                      for i, v in enumerate(flat_vars)]
            b_res = _call_with(body, loop_vars, b_args)
            b_flat = [ops_mod.convert_to_tensor(t) for t in _flatten(b_res)]
            bg.outputs = b_flat
        if len(b_flat) != len(flat_vars):
            raise ValueError(
                f"while_loop body returned {len(b_flat)} values for "
                f"{len(flat_vars)} loop vars")
        for v, o in zip(flat_vars, b_flat):
            if v.dtype.base_dtype != o.dtype.base_dtype:
                raise TypeError(f"Loop var dtype changed: {v.dtype.name} "
                                f"-> {o.dtype.name}")
            if (shape_invariants is None and v.shape.is_fully_defined()
                    and o.shape.is_fully_defined()
                    and v.shape.as_list() != o.shape.as_list()):
                raise ValueError(
                    f"Loop var shape changed {v.shape} -> {o.shape}; XLA "
                    "loops need invariant shapes.")
        c_caps = [outer for outer, _ in cg.captures]
        b_caps = [outer for outer, _ in bg.captures]
        if maximum_iterations is not None:
            mi = constant_op.constant_value(
                ops_mod.convert_to_tensor(maximum_iterations))
            if mi is None:
                raise ValueError("maximum_iterations must be static on TPU")
            maximum_iterations = int(mi)
        op = g.create_op(
            "While", flat_vars + c_caps + b_caps,
            attrs={"cond_graph": cg, "body_graph": bg,
                   "n_vars": len(flat_vars), "n_cond_caps": len(c_caps),
                   "max_iterations": maximum_iterations},
            name="while_op",
            output_specs=[(v.shape, v.dtype) for v in flat_vars])
    outs = builtins.list(op.outputs)
    if isinstance(loop_vars, (list, builtins.tuple)):
        packed = _pack_like(builtins.list(loop_vars), outs)
        if len(loop_vars) == 1:
            return packed[0]
        return builtins.tuple(packed) \
            if isinstance(loop_vars, builtins.tuple) else packed
    return _pack_like(loop_vars, outs)


# -- lowering ----------------------------------------------------------------

def _host_predicate(ctx, value) -> bool:
    """An eager run's predicate, read on the host (counted on the
    Session)."""
    sess = ctx.session
    if sess is not None:
        sess.host_predicate_reads += 1
    return builtins.bool(value.reshape(()).item())


def _differentiating(values) -> bool:
    return torch.is_grad_enabled() and builtins.any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


def _storage(v) -> int:
    return v.untyped_storage().data_ptr()


def _run_arms(pred, arms, default, inputs):
    """``default(inputs)`` (copied), overwritten by ``fn(inputs)`` of each
    arm ``(negate, fn)`` under an IF node on ``pred`` (negated)."""
    outs = [o.clone() for o in default(inputs)]
    for negate, fn in arms:
        def run(fn=fn):
            for o, v in zip(outs, fn(inputs)):
                o.copy_(v)

        cf_kernels.run_if(pred, run, negate=negate)
    return outs


class _Guarded(torch.autograd.Function):
    """Outputs ``default(inputs)``, overwritten by ``fn(inputs)`` of each
    arm ``(negate, fn)`` under an IF node on ``pred`` (negated): an arm
    whose predicate does not hold never runs. The backward recomputes
    each arm under its predicate and takes the vector-Jacobian product
    there; where no arm ran, the cotangents of output i go to input i
    with ``passthrough`` (a loop step that did not run), else nowhere."""

    @staticmethod
    def forward(fctx, pred, arms, default, passthrough, *inputs):
        fctx.arms = arms
        fctx.passthrough = passthrough
        fctx.save_for_backward(pred, *inputs)
        outs = _run_arms(pred, arms, default, inputs)
        fctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return builtins.tuple(outs)

    @staticmethod
    def backward(fctx, *grads):
        pred, *inputs = fctx.saved_tensors
        needs = fctx.needs_input_grad[4:]
        wanted = [i for i, r in enumerate(needs) if r]
        got = [torch.zeros_like(inputs[i]) for i in wanted]
        if fctx.passthrough:
            for j, i in enumerate(wanted):
                if i < len(grads) and grads[i] is not None:
                    got[j].copy_(grads[i])
        for negate, fn in fctx.arms:
            def run(fn=fn):
                with torch.enable_grad():
                    xs = [x.detach().requires_grad_(r)
                          for x, r in zip(inputs, needs)]
                    pairs = [(o, g) for o, g in zip(fn(xs), grads)
                             if g is not None and o.requires_grad]
                    res = torch.autograd.grad(
                        [o for o, _ in pairs], [xs[i] for i in wanted],
                        [g for _, g in pairs], allow_unused=True) \
                        if pairs else [None] * len(wanted)
                for buf, r in zip(got, res):
                    if r is None:
                        buf.zero_()
                    else:
                        buf.copy_(r)

            cf_kernels.run_if(pred, run, negate=negate)
        out = [None] * len(inputs)
        for j, i in enumerate(wanted):
            out[i] = got[j]
        return (None, None, None, None) + builtins.tuple(out)


def _body_fn(ctx, fg, n_args):
    """``fg``'s outputs from a flat list of its args then captures."""
    run = weakref.ref(ctx)  # the autograd node holds the function

    def fn(xs):
        return lowering_mod.lower_func_graph(run(), fg, list(xs[:n_args]),
                                             list(xs[n_args:]))

    return fn


def _lower_cond(ctx, op, inputs):
    tg = op.attrs["true_graph"]
    fg = op.attrs["false_graph"]
    n_t = op.attrs["n_true_caps"]
    pred = inputs[0]
    t_caps = inputs[1:1 + n_t]
    f_caps = inputs[1 + n_t:]
    if not ctx.compiled:
        if _host_predicate(ctx, pred):
            return lowering_mod.lower_func_graph(ctx, tg, [], t_caps)
        return lowering_mod.lower_func_graph(ctx, fg, [], f_caps)
    if not op.outputs:
        return []
    if not builtins.all(t.shape.is_fully_defined() for t in op.outputs):
        raise InvalidArgumentError(
            None, op, f"{op.name}: a captured Cond needs output shapes that "
            "both branches fix")
    specs = [(builtins.tuple(t.shape.as_list()),
              t.dtype.base_dtype.torch_dtype) for t in op.outputs]
    t_fn, f_fn = _body_fn(ctx, tg, 0), _body_fn(ctx, fg, 0)
    arms = ((False, lambda xs: t_fn(xs[:n_t])),
            (True, lambda xs: f_fn(xs[n_t:])))

    def default(xs):
        return [torch.empty(s, dtype=d, device=ctx.device)
                for s, d in specs]

    caps = builtins.list(t_caps) + builtins.list(f_caps)
    pred = pred.reshape(1).to(torch.bool)
    if _differentiating(caps):
        return builtins.list(_Guarded.apply(pred, arms, default, False,
                                            *caps))
    with torch.no_grad():
        return _run_arms(pred, arms, default, caps)


op_registry.register("Cond", lower=_lower_cond)


def _lower_while(ctx, op, inputs):
    n = op.attrs["n_vars"]
    n_cc = op.attrs["n_cond_caps"]
    cg = op.attrs["cond_graph"]
    max_iter = op.attrs.get("max_iterations")
    init = builtins.list(inputs[:n])
    c_caps = builtins.list(inputs[n:n + n_cc])
    b_caps = builtins.list(inputs[n + n_cc:])

    def test(vs):
        return lowering_mod.lower_func_graph(ctx, cg, vs, c_caps)[0]

    body = _body_fn(ctx, op.attrs["body_graph"], n)
    if not ctx.compiled:
        vs, i = init, 0
        while (max_iter is None or i < max_iter) and \
                _host_predicate(ctx, test(vs)):
            vs = body(vs + b_caps)
            i += 1
        return vs
    if max_iter is not None and _differentiating(init + b_caps):
        # max_iter guarded steps, step j active while every predicate so
        # far held
        vs, active = init, None
        for _ in builtins.range(max_iter):
            with torch.no_grad():
                p = test(vs).reshape(1).to(torch.bool)
                active = p if active is None else \
                    torch.logical_and(active, p)
            vs = builtins.list(_Guarded.apply(
                active, ((False, body),), lambda xs: xs[:n], True,
                *vs, *b_caps))
        return vs
    with torch.no_grad():
        return _node_loop(ctx, op, init, test, body, b_caps, max_iter)


def _node_loop(ctx, op, init, test, body, b_caps, max_iter):
    """The loop under a WHILE node: the vars in carry buffers, the body's
    results copied back at the end of every iteration."""
    carry = [v.clone() for v in init]
    count = None if max_iter is None else torch.zeros(
        (), dtype=torch.int32, device=ctx.device)

    def predicate():
        p = test(carry).reshape(())
        if count is not None:
            p = torch.logical_and(p, count < max_iter)
        return p

    def step():
        outs = body(carry + b_caps)
        held = {_storage(c) for c in carry}
        outs = [o.clone() if _storage(o) in held else o for o in outs]
        for c, o in zip(carry, outs):
            if tuple(o.shape) != tuple(c.shape):
                raise InvalidArgumentError(
                    None, op, f"{op.name}: loop var shape changes from "
                    f"{tuple(c.shape)} to {tuple(o.shape)}, which a "
                    "captured loop cannot carry")
            c.copy_(o)
        if count is not None:
            count.add_(1)
        return predicate()

    cf_kernels.run_while(predicate(), step)
    return carry


op_registry.register("While", lower=_lower_while)
